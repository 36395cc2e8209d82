// Weighted embedding bag (sum) for Hopper (sm_90a): a row gather and an
// accumulate.
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py, embedding_bag_pallas
// (body _embag_kernel). The TPU kernel turns the lookup into a multi-hot
// count matrix times the table, because a TPU core has no fast random
// gather; its own docstring names the GPU form, which this is. In the port
// it is repro_torch.models.recsys.bag_lookup(use_kernel=True) and
// repro_torch.kernels.embedding_bag.ops.embedding_bag.
//
// Contract: table (V, D) float32 or bfloat16, ids (B, L) int32, weights
// (B, L) float32 (or none: every weight 1), all contiguous -> out (B, D)
// float32, out[b] = sum over l of weights[b, l] * table[ids[b, l]], in
// float32. Duplicate ids add up. An id outside [0, V) adds nothing, as in
// the TPU kernel, where it matches no vocabulary lane. The sum runs in bag
// order l = 0 .. L-1, so the result does not change from run to run.
//
// What bounds it on the H100: bytes. At MIND's shapes (B 4,096, history
// 50, D 64, a 1M-row float32 table) it must read 204,800 rows of 256 B
// (52 MB, at most; repeated rows once) plus ids and weights and write 1 MB:
// ~0.016 ms at 3.35 TB/s. Design: one block per bag (B blocks), one thread
// per output element (D threads, rounded up to a warp), so the reads of a
// row are one coalesced run; each thread keeps 8 rows of its bag in flight
// (ids and weights of the bag staged in shared memory first) and adds them
// in order into one float32 sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBag = 1024;  // ids and weights of one bag in shared memory
constexpr int kInFlight = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void embedding_bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                                     const float* __restrict__ weights, int vocab, int dim,
                                     int bag, float* __restrict__ out) {
  __shared__ int32_t id_s[kMaxBag];
  __shared__ float w_s[kMaxBag];
  const int b = blockIdx.x;
  for (int l = threadIdx.x; l < bag; l += blockDim.x) {
    const int32_t id = ids[(size_t)b * bag + l];
    const bool ok = id >= 0 && id < vocab;
    id_s[l] = ok ? id : 0;
    w_s[l] = ok ? (weights ? weights[(size_t)b * bag + l] : 1.f) : 0.f;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < dim; c += blockDim.x) {
    float acc = 0.f;
    for (int l0 = 0; l0 < bag; l0 += kInFlight) {
      float row[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        row[u] = l0 + u < bag ? to_f32(table[(size_t)id_s[l0 + u] * dim + c]) : 0.f;
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (l0 + u < bag) acc = fmaf(w_s[l0 + u], row[u], acc);
    }
    out[(size_t)b * dim + c] = acc;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 table. weights may be null (all ones).
extern "C" int embedding_bag(const void* table, const int32_t* ids, const float* weights,
                             int dtype, int vocab, int dim, int batch, int bag, float* out,
                             cudaStream_t stream) {
  if (batch == 0 || dim == 0) return 0;
  if (bag < 0 || bag > kMaxBag || vocab < 1) return (int)cudaErrorInvalidValue;
  const int threads = dim >= 256 ? 256 : ((dim + 31) / 32) * 32;
  if (dtype == 0) {
    embedding_bag_kernel<float><<<batch, threads, 0, stream>>>(
        static_cast<const float*>(table), ids, weights, vocab, dim, bag, out);
  } else if (dtype == 1) {
    embedding_bag_kernel<__nv_bfloat16><<<batch, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(table), ids, weights, vocab, dim, bag, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
