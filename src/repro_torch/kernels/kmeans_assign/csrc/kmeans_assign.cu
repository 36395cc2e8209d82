// Fused K-Means assignment for Hopper (sm_90a): for every point, the index
// and the value of the smallest squared L2 distance to k centroids.
//
// Replaces: src/repro/kernels/kmeans_assign/kernel.py, kmeans_assign_pallas
// (the Pallas TPU kernel behind repro.core.kmeans.assign(use_kernel=True)).
// In the port it also carries every Lloyd assignment of the index build
// (repro_torch.core.kmeans._lloyd_step), batched over the groups of a
// level's fit_many: x (G, n, d), centroids (G, k, d) -> labels (G, n) int32,
// min_d2 (G, n) float32.
//
// Contract, as the TPU kernel: d2 = max(|x|^2 + |c|^2 - 2 x.c, 0) in float32,
// argmin ties go to the lowest centroid index (jnp.argmin). Any k is taken:
// centroids stream through shared memory in chunks, so there is no
// sentinel-padded centroid as in the TPU wrapper.
//
// What bounds it on the H100: the root fit of the paper's index is
// 518,576 x 256 x 45 multiply-adds per Lloyd step, ~12 GFLOP of float32
// against 24 MB of points, so it is bound by operations (67 TFLOP/s of
// non-tensor-core float32 -> ~0.18 ms) well before bytes (~7 us).
// Design: one thread per point holds its point in registers (DMAX-wide,
// fully unrolled, so no local memory for d <= 64 or 256); a chunk of
// centroids and their norms sits in shared memory and every thread of the
// block reads the same centroid word at the same time (a broadcast, no
// bank conflicts). The distance loop is then one FMA per shared load.
// Tensor cores (wgmma on a 3xTF32 split, to keep float32 accuracy) are
// left for a later change.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemFloats = 12288;  // 48 KB of static shared memory

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int n, int k, int d, int kt,
                     int32_t* __restrict__ labels, float* __restrict__ mind) {
  __shared__ float cs[kSmemFloats];  // kt centroids (kt * d) then their norms (kt)
  const int g = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float* xi = x + ((size_t)g * n + (live ? i : 0)) * d;
  const float* cg = c + (size_t)g * k * d;
  float* cn_s = cs + kt * d;

  float xr[DMAX];
  float xn = 0.f;
#pragma unroll
  for (int t = 0; t < DMAX; ++t) {
    xr[t] = (live && t < d) ? __ldg(xi + t) : 0.f;
    xn = fmaf(xr[t], xr[t], xn);
  }

  float best = FLT_MAX;
  int arg = 0;
  for (int j0 = 0; j0 < k; j0 += kt) {
    const int m = min(kt, k - j0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < m * d; e += kThreads) cs[e] = __ldg(cg + (size_t)j0 * d + e);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kThreads) {
      float s = 0.f;
      for (int t = 0; t < d; ++t) s = fmaf(cs[j * d + t], cs[j * d + t], s);
      cn_s[j] = s;
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float* cj = cs + j * d;
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < DMAX; ++t) {
        if (t < d) dot = fmaf(xr[t], cj[t], dot);
      }
      const float d2 = fmaxf(xn + cn_s[j] - 2.f * dot, 0.f);
      if (d2 < best) {  // strict: ties keep the lower index
        best = d2;
        arg = j0 + j;
      }
    }
  }
  if (live) {
    labels[(size_t)g * n + i] = arg;
    mind[(size_t)g * n + i] = best;
  }
}

}  // namespace

// x (groups, n, d), c (groups, k, d) float32, contiguous; labels/mind (groups, n).
extern "C" int kmeans_assign_f32(const float* x, const float* c, int groups, int n, int k,
                                 int d, int32_t* labels, float* mind, cudaStream_t stream) {
  if (groups == 0 || n == 0) return 0;
  if (k < 1 || d < 1 || d > 1024 || groups > 65535) return (int)cudaErrorInvalidValue;
  int kt = kSmemFloats / (d + 1);
  if (kt > k) kt = k;
  const dim3 grid((n + kThreads - 1) / kThreads, groups);
  if (d <= 64) {
    kmeans_assign_kernel<64><<<grid, kThreads, 0, stream>>>(x, c, n, k, d, kt, labels, mind);
  } else if (d <= 256) {
    kmeans_assign_kernel<256><<<grid, kThreads, 0, stream>>>(x, c, n, k, d, kt, labels, mind);
  } else {
    kmeans_assign_kernel<1024><<<grid, kThreads, 0, stream>>>(x, c, n, k, d, kt, labels, mind);
  }
  return (int)cudaGetLastError();
}
