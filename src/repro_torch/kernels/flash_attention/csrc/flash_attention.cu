// Blockwise online-softmax attention (forward) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel). In the port it carries every
// attention of the transformer's forward, prefill and decode_step
// (repro_torch.models.layers.attention, impl "chunked", "pallas" and
// "full_masked" on a CUDA tensor).
//
// Contract: q (B, Hq, T, dh), k / v (B, Hkv, S, dh), each with its own
// (batch, head, position) strides in elements and a contiguous last dim;
// out (B, Hq, T, dh) in q's type. Query row t sits at kv position
// q_offset + t; kv position s is visible to it iff s < kv_len and, when
// causal, s <= q_offset + t. The TPU kernel's function is the case
// q_offset = S - T, kv_len = S; prefill into a longer cache is q_offset = 0,
// kv_len = T; a decode step is causal = 0, kv_len = pos + 1. Scores are
// (q * scale) . k in float32 with masked scores set to -1e30 (not -inf, as
// in JAX, so a tile that is all masked for a row gives finite weights), the
// running max starts at -1e30, and the output is acc / max(l, 1e-30). GQA:
// q head h reads kv head h / (Hq / Hkv). Any T and S: the ragged edges are
// masked here, with no 128-alignment.
//
// What bounds it on the H100: at the prefill of stablelm-1.6b (4 x 32 heads
// x 4,096 positions, dh 64) the causal work is ~2.7e11 FLOP a layer, which
// at the tensor cores' 989 TFLOP/s is 0.28 ms while q, k, v and out are
// 268 MB (0.08 ms): it is bound by operations. A decode step reads the
// whole valid cache once for one query row a head: bound by bytes.
// Design: one block per (batch * q head, tile of BQ query rows), the kv
// loop inside the block in place of the TPU grid's sequential kv axis, and
// m / l / acc in registers in place of its VMEM scratch. K (transposed) and
// V tiles of 64 positions are staged in shared memory as float32; each
// thread holds a 4 x 4 tile of scores (4 rows, 4 columns 16 apart) and the
// matching 4 rows of the output, so the row max / row sum reduce over the
// 16 lanes that share a row with shuffles and nothing crosses warps. All
// math is float32 on the CUDA cores. Tiles past kv_len and tiles wholly
// above the diagonal are skipped. Blocks walk the q tiles from the last,
// so the longest causal rows start first. Decode (T <= 16) takes BQ = 16
// and splits the kv range over several blocks (a decode step has only
// batch x heads query blocks, fewer than the card has SMs): each block
// writes its unnormalised acc, m and l to a float32 scratch the wrapper
// allocates, and a second kernel combines them. Tensor cores (wgmma /
// mma.sync on bf16 tiles) and TMA staging are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 64;          // kv positions per tile
constexpr int kTX = 16;          // lanes sharing a query row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long qb, qh, qt, kb, kh, ks, vb, vh, vs, ob, oh, ot;
};

template <int DH, int BQ>
constexpr int smem_floats() {
  return BQ * (DH + 1) + DH * (kBK + 1) + kBK * DH + BQ * (kBK + 1);
}

template <typename T, int DH, int BQ>
__global__ void __launch_bounds__((BQ / 4) * kTX)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int hq, int group, int t_len, Strides st,
                 int causal, int q_offset, int kv_len, float scale, int tiles_per_split,
                 float* __restrict__ part) {
  constexpr int kThreads = (BQ / 4) * kTX;
  constexpr int kCols = DH / kTX;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                      // [BQ][DH + 1], scaled
  float* kt = qs + BQ * (DH + 1);        // [DH][BK + 1], K transposed
  float* vs = kt + DH * (kBK + 1);       // [BK][DH]
  float* ps = vs + kBK * DH;             // [BQ][BK + 1], this tile's weights

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;

  const T* qg = q + b * st.qb + h * st.qh;
  const T* kg = k + b * st.kb + hk * st.kh;
  const T* vg = v + b * st.vb + hk * st.vh;

  for (int e = tid; e < BQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    const float x = (q0 + r < t_len) ? to_f32(qg[(q0 + r) * st.qt + c]) : 0.f;
    qs[r * (DH + 1) + c] = __fmul_rn(x, scale);
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // the last kv position any row of this tile may see, plus one
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + BQ, t_len));
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int tile0 = blockIdx.z * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);

  for (int tile = tile0; tile < tile1; ++tile) {
    const int kv0 = tile * kBK;
    __syncthreads();  // the previous tile's readers are done (and qs is written)
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int r = e / DH, c = e % DH;
      const bool live = kv0 + r < kv_len;
      kt[c * (kBK + 1) + r] = live ? to_f32(kg[(kv0 + r) * st.ks + c]) : 0.f;
      vs[r * DH + c] = live ? to_f32(vg[(kv0 + r) * st.vs + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[d * (kBK + 1) + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + kTX * j;
        const bool ok = col < kv_len && (!causal || col <= qpos);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * (kBK + 1) + tx + kTX * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[r][:] += P[r][:] @ V; this thread's rows are the rows whose
    // weights it (with its 15 row mates) just wrote
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = vs[c * DH + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  if (part != nullptr) {  // this split's share: (splits, B * Hq, T, DH + 2) float32
    float* pb = part + ((size_t)blockIdx.z * gridDim.x + bh) * t_len * (DH + 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      if (r >= t_len) continue;
#pragma unroll
      for (int j = 0; j < kCols; ++j) pb[r * (DH + 2) + tx + kTX * j] = acc[i][j];
      if (tx == 0) {
        pb[r * (DH + 2) + DH] = m[i];
        pb[r * (DH + 2) + DH + 1] = l[i];
      }
    }
    return;
  }
  T* og = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= t_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      og[r * st.ot + tx + kTX * j] = from_f32<T>(acc[i][j] / denom);
  }
}

// out[r] = sum_s acc_s[r] e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30), M = max_s m_s:
// the splits' partial softmax sums merged as the online softmax merges tiles
template <typename T, int DH>
__global__ void flash_combine_kernel(const float* __restrict__ part, int splits, int hq,
                                     int t_len, T* __restrict__ o, Strides st) {
  const int bh = blockIdx.x, r = blockIdx.y, c = threadIdx.x;
  const size_t split_stride = (size_t)gridDim.x * t_len * (DH + 2);
  const float* pr = part + ((size_t)bh * t_len + r) * (DH + 2);
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pr[s * split_stride + DH]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* ps = pr + s * split_stride;
    const float w = expf(ps[DH] - mx);
    l = fmaf(ps[DH + 1], w, l);
    acc = fmaf(ps[c], w, acc);
  }
  const int b = bh / hq, h = bh % hq;
  o[b * st.ob + h * st.oh + r * st.ot + c] = from_f32<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int DH, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int hq, int hkv,
           int t_len, const Strides& st, int causal, int q_offset, int kv_len, float scale,
           int splits, float* part, cudaStream_t stream) {
  constexpr int kSmem = smem_floats<DH, BQ>() * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, DH, BQ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  int tiles_per_split = 1 << 30;
  if (splits > 1) {  // one q tile (t_len <= BQ): split its kv tiles evenly
    const int kv_end = causal ? min(kv_len, q_offset + t_len) : kv_len;
    const int n_tiles = (kv_end + kBK - 1) / kBK;
    tiles_per_split = max(1, (n_tiles + splits - 1) / splits);
    splits = max(1, (n_tiles + tiles_per_split - 1) / tiles_per_split);
  }
  const dim3 grid(batch * hq, (t_len + BQ - 1) / BQ, splits);
  kernel<<<grid, (BQ / 4) * kTX, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hq / hkv, t_len, st, causal, q_offset, kv_len, scale,
      tiles_per_split, splits > 1 ? part : nullptr);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_combine_kernel<T, DH><<<dim3(batch * hq, t_len), DH, 0, stream>>>(
        part, splits, hq, t_len, static_cast<T*>(o), st);
  }
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, void* o, int batch, int hq, int hkv,
              int t_len, const Strides& st, int causal, int q_offset, int kv_len, float scale,
              int splits, float* part, cudaStream_t stream) {
  if (t_len <= 16)
    return launch<T, DH, 16>(q, k, v, o, batch, hq, hkv, t_len, st, causal, q_offset, kv_len,
                             scale, splits, part, stream);
  return launch<T, DH, 64>(q, k, v, o, batch, hq, hkv, t_len, st, causal, q_offset, kv_len,
                           scale, 1, nullptr, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike). strides: 12 element
// strides, (batch, head, position) of q, k, v and out. splits: blocks a
// query block's kv range is split over when t_len <= 16 (else 1); part:
// float32 scratch of splits * batch * hq * t_len * (dh + 2) for them.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int batch, int hq, int hkv, int t_len, int s_len,
                                   int dh, const long long* strides, int causal, int q_offset,
                                   int kv_len, float scale, int splits, float* part,
                                   cudaStream_t stream) {
  if (batch == 0 || t_len == 0 || hq == 0) return 0;
  if (hkv < 1 || hq % hkv != 0 || kv_len < 0 || kv_len > s_len || q_offset < 0 ||
      (t_len + 15) / 16 > 65535 || splits < 1 || splits > 65535 || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2],  strides[3],  strides[4],  strides[5],
                   strides[6], strides[7], strides[8],  strides[9],  strides[10], strides[11]};
  if (dtype == 0 && dh == 64)
    return launch_dh<float, 64>(q, k, v, o, batch, hq, hkv, t_len, st, causal, q_offset, kv_len,
                                scale, splits, part, stream);
  if (dtype == 0 && dh == 128)
    return launch_dh<float, 128>(q, k, v, o, batch, hq, hkv, t_len, st, causal, q_offset, kv_len,
                                 scale, splits, part, stream);
  if (dtype == 1 && dh == 64)
    return launch_dh<__nv_bfloat16, 64>(q, k, v, o, batch, hq, hkv, t_len, st, causal, q_offset,
                                        kv_len, scale, splits, part, stream);
  if (dtype == 1 && dh == 128)
    return launch_dh<__nv_bfloat16, 128>(q, k, v, o, batch, hq, hkv, t_len, st, causal, q_offset,
                                         kv_len, scale, splits, part, stream);
  return (int)cudaErrorInvalidValue;
}
