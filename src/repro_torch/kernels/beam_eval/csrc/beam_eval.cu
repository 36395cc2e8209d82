// Segmented beam node evaluation for Hopper (sm_90a): the child
// log-probabilities of every (query, beam prefix) pair of a pruned LMI level.
//
// Replaces: src/repro/kernels/beam_eval/kernel.py, beam_eval_pallas (the
// Pallas TPU kernel behind repro.kernels.beam_eval.ops.node_scores with
// use_kernel=True). In the port it is repro_torch.kernels.beam_eval.ops.
// node_scores on CUDA tensors.
//
// Operands: queries (Q, d) f32; the pairs sorted by node id (node_s (P,)
// int32, and order (P,) int32 = the original pair index of each sorted
// position; pair p belongs to query p / F); the level's canonical planes,
// mats (N, arity, d) f32 x 1-2 and vecs (N, arity) f32 x 1-3 (ref.py
// documents them per family). Output: (P, arity) f32 child log-probs,
// written straight back in the original pair order (row order[j] for
// sorted position j), so no inverse permutation is needed afterwards.
//
// Contract, as the TPU kernel and the plain version (ref.py): the same
// combine_scores expressions per family, then a row log-softmax spelled as
// max-shift and log-sum-exp. Node ids are clamped into [0, N) like a JAX
// gather. Dot products run over d in index order with fmaf, so they differ
// from the plain version's matmul in the last bits only.
//
// What bounds it on the H100: bytes. At the depth-3 serving point (P =
// 32,768 pairs over N = 4,096 nodes, arity 64, d 45) the product is
// 2 * P * arity * d = 0.19 GFLOP (~3 us at 67 TFLOP/s of float32), while the
// planes of the touched nodes (47 MB for kmeans), the vector planes and
// the 8.4 MB of output take ~17 us at 3.35 TB/s. A per-pair gather would
// read one (arity, d) block per pair: P / N = 8x the plane bytes.
//
// Design: pairs arrive node-sorted, so pairs sharing a node are one
// contiguous run. A block takes a tile of `tp` sorted pairs; at each run
// start it loads the node's (arity, d) block(s) into shared memory once,
// with 8 loads in flight per thread, at an odd row stride so that the 32
// lanes reading 32 rows hit 32 banks. Each warp then takes two pairs of the
// run, so every plane value read from shared memory feeds two dot
// products: it stages both query rows in shared memory (read from the
// (Q, d) queries by the pair's query index, never copied to a (P, d)
// matrix), its lanes split the arity and loop over d, the family's epilogue
// combines the dots with the node's vector planes (read from (N, arity) by
// node id), and the warp finishes each pair with a log-softmax by shuffles
// (max, then sum of exp). When a block does not fit in shared memory (gmm
// at arity 256, d 190: two 195 KB matrices) the children are taken in
// chunks of `ca` rows, reloaded for every wave of warps; the wrapper picks
// `ca` (ops._plan) and the common shapes are resident, with one load per
// run per tile. The kernel is still well above its byte bound: it is bound
// by the latency of the per-run loads, which the wrapper hides with small
// tiles (16 pairs, 4 warps) and so more blocks in flight.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kFamilyKMeans = 0;
constexpr int kFamilyGmm = 1;
constexpr int kFamilyLogreg = 2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One node's (cn, d) rows of 1-2 plane matrices into shared memory at row
// stride ds, with U independent loads in flight per thread before the
// stores (a plain copy loop keeps about one load in flight).
template <int NM>
__device__ __forceinline__ void load_block(float* __restrict__ mat_s, const float* __restrict__ g0,
                                           const float* __restrict__ g1, int total, int d,
                                           int ds, int ca) {
  constexpr int U = 8;
  for (int base = threadIdx.x; base < total; base += U * blockDim.x) {
    float v0[U], v1[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * blockDim.x;
      v0[u] = e < total ? __ldg(g0 + e) : 0.f;
      if (NM == 2) v1[u] = e < total ? __ldg(g1 + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * blockDim.x;
      if (e < total) {
        const int a = e / d;
        const int at = a * ds + (e - a * d);
        mat_s[at] = v0[u];
        if (NM == 2) mat_s[ca * ds + at] = v1[u];
      }
    }
  }
}

template <int FAMILY>
__device__ __forceinline__ float combine(float dot0, float dot1, float qn, const float* v0,
                                         const float* v1, const float* v2, size_t vi) {
  if (FAMILY == kFamilyKMeans) return -fmaxf((qn + __ldg(v0 + vi)) - 2.f * dot0, 0.f);
  if (FAMILY == kFamilyGmm) {
    const float quad = dot1 - 2.f * dot0 + __ldg(v1 + vi);
    return __ldg(v0 + vi) - 0.5f * (__ldg(v2 + vi) + quad);
  }
  return dot0 + __ldg(v0 + vi);
}

// Row log-softmax of one warp's (arity,) scores, written to o.
__device__ __forceinline__ void warp_log_softmax(const float* sw, int arity, int lane,
                                                 float* __restrict__ o) {
  float m = -FLT_MAX;
  for (int a = lane; a < arity; a += 32) m = fmaxf(m, sw[a]);
  m = warp_max(m);
  float se = 0.f;
  for (int a = lane; a < arity; a += 32) se += expf(sw[a] - m);
  const float lse = logf(warp_sum(se));
  for (int a = lane; a < arity; a += 32) o[a] = (sw[a] - m) - lse;
}

template <int FAMILY>
__global__ void beam_eval_kernel(const float* __restrict__ q, int d,
                                 const int32_t* __restrict__ node_s,
                                 const int32_t* __restrict__ order, int P, int F, int N,
                                 const float* __restrict__ m0, const float* __restrict__ m1,
                                 const float* __restrict__ v0, const float* __restrict__ v1,
                                 const float* __restrict__ v2, int arity, int ds, int ca,
                                 int tp, float* __restrict__ out) {
  constexpr int NM = FAMILY == kFamilyGmm ? 2 : 1;
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* mat_s = smem;                   // NM blocks of ca rows at stride ds
  float* x_s = mat_s + NM * ca * ds;     // two query rows per warp
  float* sc_s = x_s + 2 * nw * d;        // two score rows per warp
  int* node_t = reinterpret_cast<int*>(sc_s + 2 * nw * arity);  // the tile's node ids
  float* xa = x_s + 2 * warp * d;
  float* xb = xa + d;
  float* sa = sc_s + 2 * warp * arity;
  float* sb = sa + arity;

  const int t0 = blockIdx.x * tp;
  const int t1 = min(t0 + tp, P);
  for (int i = threadIdx.x; i < t1 - t0; i += blockDim.x) {
    node_t[i] = min(max(node_s[t0 + i], 0), N - 1);
  }
  __syncthreads();
  const bool resident = ca >= arity;

  for (int rs = t0; rs < t1;) {
    const int node = node_t[rs - t0];
    int re = rs + 1;
    while (re < t1 && node_t[re - t0] == node) ++re;  // the run [rs, re) in this tile
    const size_t blk = (size_t)node * arity * d;
    const size_t vrow = (size_t)node * arity;

    // waves: each warp takes two pairs of the run, so every plane value
    // read from shared memory feeds two dot products
    for (int w0 = rs; w0 < re; w0 += 2 * nw) {
      const int ja = w0 + 2 * warp;
      const bool live_a = ja < re;
      const bool live_b = ja + 1 < re;
      int pa = 0, pb = 0;
      float qna = 0.f, qnb = 0.f;
      __syncwarp();  // the previous wave's readers of xa / xb / sa / sb are done
      if (live_a) {
        pa = order[ja];
        pb = live_b ? order[ja + 1] : pa;
        const float* qa = q + (size_t)(pa / F) * d;
        const float* qb = q + (size_t)(pb / F) * d;
        for (int t = lane; t < d; t += 32) {
          const float x = qa[t], y = qb[t];
          xa[t] = x;
          xb[t] = y;
          qna = fmaf(x, x, qna);
          qnb = fmaf(y, y, qnb);
        }
        qna = warp_sum(qna);
        qnb = warp_sum(qnb);
      }
      __syncwarp();
      for (int c0 = 0; c0 < arity; c0 += ca) {
        const int cn = min(ca, arity - c0);
        if (!resident || w0 == rs) {  // resident blocks load once per run
          __syncthreads();            // readers of the previous block are done
          load_block<NM>(mat_s, m0 + blk + (size_t)c0 * d,
                         NM == 2 ? m1 + blk + (size_t)c0 * d : nullptr, cn * d, d, ds, ca);
          __syncthreads();
        }
        if (live_a) {
          for (int a = lane; a < cn; a += 32) {
            const float* r0 = mat_s + a * ds;
            const float* r1 = mat_s + (ca + a) * ds;
            float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll 4
            for (int t = 0; t < d; ++t) {
              const float w = r0[t], x = xa[t], y = xb[t];
              a0 = fmaf(x, w, a0);
              b0 = fmaf(y, w, b0);
              if (NM == 2) {
                const float w1 = r1[t];
                a1 = fmaf(x * x, w1, a1);
                b1 = fmaf(y * y, w1, b1);
              }
            }
            const int ch = c0 + a;
            sa[ch] = combine<FAMILY>(a0, a1, qna, v0, v1, v2, vrow + ch);
            sb[ch] = combine<FAMILY>(b0, b1, qnb, v0, v1, v2, vrow + ch);
          }
        }
      }
      __syncwarp();
      if (live_a) warp_log_softmax(sa, arity, lane, out + (size_t)pa * arity);
      if (live_b) warp_log_softmax(sb, arity, lane, out + (size_t)pb * arity);
    }
    rs = re;
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes (ops._plan mirrors it).
extern "C" int beam_eval_smem_bytes(int n_mats, int arity, int d, int ds, int ca, int warps,
                                    int tp) {
  return 4 * (n_mats * ca * ds + 2 * warps * (d + arity) + tp);
}

// family: 0 kmeans, 1 gmm, 2 kmeans+logreg. q (Q, d); node_s / order (P,);
// mats (N, arity, d); vecs (N, arity); out (P, arity). Unused plane
// pointers may be null. Returns cudaGetLastError() after the launch.
extern "C" int beam_eval_f32(const float* q, int d, const int32_t* node_s, const int32_t* order,
                             int P, int F, int N, const float* m0, const float* m1,
                             const float* v0, const float* v1, const float* v2, int family,
                             int arity, int ds, int ca, int warps, int tp, float* out,
                             cudaStream_t stream) {
  if (P == 0) return 0;
  if (d < 1 || arity < 1 || N < 1 || F < 1 || ca < 1 || ds < d || warps < 1 || warps > 32 ||
      tp < 1 || family < 0 || family > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_mats = family == kFamilyGmm ? 2 : 1;
  const int smem = beam_eval_smem_bytes(n_mats, arity, d, ds, ca, warps, tp);
  const int grid = (P + tp - 1) / tp;
  const int threads = warps * 32;
  cudaError_t err = cudaSuccess;
#define BEAM_EVAL_LAUNCH(FAM)                                                                  \
  err = cudaFuncSetAttribute(beam_eval_kernel<FAM>,                                            \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
  if (err != cudaSuccess) return (int)err;                                                     \
  beam_eval_kernel<FAM><<<grid, threads, smem, stream>>>(q, d, node_s, order, P, F, N, m0, m1, \
                                                         v0, v1, v2, arity, ds, ca, tp, out);
  if (family == kFamilyKMeans) {
    BEAM_EVAL_LAUNCH(kFamilyKMeans)
  } else if (family == kFamilyGmm) {
    BEAM_EVAL_LAUNCH(kFamilyGmm)
  } else {
    BEAM_EVAL_LAUNCH(kFamilyLogreg)
  }
#undef BEAM_EVAL_LAUNCH
  return (int)cudaGetLastError();
}
