// Tiled all-pairs squared L2 distance for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pairwise_l2/kernel.py, pairwise_l2_pallas
// (body _pairwise_l2_kernel). Neither package calls it from its pipeline
// (the filter and the K-Means assignment have kernels of their own); it is
// the entry point repro_torch.kernels.pairwise_l2.ops.pairwise_l2.
//
// Contract, as the TPU kernel: x (n, d), y (m, d), both float32 or both
// bfloat16, contiguous -> out (n, m) float32,
// out[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0), every product and
// sum in float32. Ragged n, m and d are masked here; nothing is padded.
//
// What bounds it on the H100: at the brute-force shape of the paper's
// index (512 queries x 518,576 embeddings, d = 45) it writes a 1.06 GB
// float32 matrix (0.32 ms at 3.35 TB/s) and does 2.4e10 float32 operations
// (0.36 ms at the 67 TFLOP/s of the CUDA cores): both bounds are near, the
// operations slightly ahead. Design: a block computes a 64 x 64 output
// tile with 256 threads, 4 x 4 outputs a thread in registers (4 adjacent
// rows, 4 columns 16 apart); x and y stream through shared memory in chunks of 32
// features, transposed so that a thread's 4 x values and 4 y values of a
// feature are two broadcast / consecutive reads. The squared norms are
// summed from the same shared chunks. The epilogue rounds each step as JAX
// writes it (no contraction into an FMA). Output columns of a thread are
// 16 apart, so a warp's stores are 64-byte runs of a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;
constexpr int kDK = 32;  // features per shared-memory chunk
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
pairwise_l2_kernel(const T* __restrict__ x, const T* __restrict__ y, int n, int m, int d,
                   float* __restrict__ out) {
  __shared__ float xs[kDK][kTile + 1];
  __shared__ float ys[kDK][kTile + 1];
  __shared__ float xn_s[kTile], yn_s[kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  float norm = 0.f;  // threads 0..63: |x_{i0+tid}|^2; 64..127: |y_{j0+tid-64}|^2

  for (int f0 = 0; f0 < d; f0 += kDK) {
    __syncthreads();
    for (int e = tid; e < kTile * kDK; e += kThreads) {
      const int r = e / kDK, c = e % kDK;
      const int f = f0 + c;
      xs[c][r] = (i0 + r < n && f < d) ? to_f32(x[(size_t)(i0 + r) * d + f]) : 0.f;
      ys[c][r] = (j0 + r < m && f < d) ? to_f32(y[(size_t)(j0 + r) * d + f]) : 0.f;
    }
    __syncthreads();
    if (tid < 2 * kTile) {
      const float(*src)[kTile + 1] = tid < kTile ? xs : ys;
      const int r = tid % kTile;
#pragma unroll 8
      for (int c = 0; c < kDK; ++c) norm = fmaf(src[c][r], src[c][r], norm);
    }
#pragma unroll 8
    for (int c = 0; c < kDK; ++c) {
      float xv[4], yv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = xs[c][ty * 4 + a];
#pragma unroll
      for (int b = 0; b < 4; ++b) yv[b] = ys[c][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xv[a], yv[b], acc[a][b]);
    }
  }
  if (tid < kTile) xn_s[tid] = norm;
  else if (tid < 2 * kTile) yn_s[tid - kTile] = norm;
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= n) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + 16 * b;
      if (j >= m) continue;
      const float s = __fadd_rn(xn_s[ty * 4 + a], yn_s[tx + 16 * b]);
      out[(size_t)i * m + j] = fmaxf(__fsub_rn(s, __fmul_rn(2.f, acc[a][b])), 0.f);
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x and y alike). out (n, m) float32.
extern "C" int pairwise_l2(const void* x, const void* y, int dtype, int n, int m, int d,
                           float* out, cudaStream_t stream) {
  if (n == 0 || m == 0) return 0;
  if (d < 1 || (n + kTile - 1) / kTile > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  if (dtype == 0) {
    pairwise_l2_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), n, m, d, out);
  } else if (dtype == 1) {
    pairwise_l2_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y), n, m, d, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
