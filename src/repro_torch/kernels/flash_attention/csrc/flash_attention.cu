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
// q . k * scale in float32 with masked scores set to -1e30 (not -inf, as
// in JAX, so a tile that is all masked for a row gives finite weights), the
// running max starts at -1e30, and the output is acc / max(l, 1e-30). (The
// bf16 kernels give a row's masked scores weight 0 even while it has seen
// no visible key, which changes nothing for a row that sees one; position
// 0 is visible to every row when kv_len > 0.) GQA: q head h reads kv head
// h / (Hq / Hkv). Any T and S: the ragged edges are masked here, with no
// 128-alignment.
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s):
// - stablelm-1.6b prefill, 4 x 32 heads x 4,096 positions, dh 64, causal:
//   ~2.75e11 FLOP a layer (visible query-key pairs x 4 dh) = 0.278 ms of
//   tensor-core work against 0.08 ms of bytes: bound by operations.
// - starcoder2-15b prefill, 1 x 48 / 4 heads x 4,096, dh 128: 0.208 ms, by
//   operations.
// - a decode step, one query row a head over a 4,160-position cache: the
//   valid cache is read once, 0.041 ms (stablelm, 4 x 32 heads) or
//   0.010 ms (starcoder2, 4 x 4 kv heads of 128): bound by bytes.
//
// Three kernels, chosen by the wrapper's plan() (ops.py):
//
// 1. bfloat16, T > 16 (prefill, forward): flash_prefill_bf16. One block
//    per (batch * q head, 128 query rows at dh 64 or 192 at dh 128), a
//    warpgroup (four warps) per 64 rows. Both products run on the tensor
//    cores as wgmma.mma_async: S = Q K^T as m64n64k16 with Q and K read
//    from shared memory by descriptor, O += P V as m64n{dh}k16 with P from
//    registers (the C fragments of S are, two n8 tiles at a time, its A
//    fragments) and V read MN-major. K and V stay bfloat16 in shared
//    memory, in a ring of 64-position tiles (two stages at dh 64, three at
//    dh 128) filled ahead by 16-byte cp.async.cg copies, so the next
//    tile's load overlaps this tile's math. Every tile is laid out in
//    wgmma's 128-byte swizzle (16-byte chunk c ^ row % 8 of each 64-column
//    block), which also keeps the copies free of bank conflicts. The
//    online softmax stays in registers: a thread holds two rows' scores,
//    the row max reduces over its quad with two shuffles, and each weight
//    is one FFMA (the float32 score times scale * log2 e, minus the scaled
//    max) and one ex2. P is split into hi = bf16(p) and lo = bf16(p - hi)
//    and P V is issued for both (half again the tensor-core work): with P
//    rounded to bfloat16 alone, rows with few visible keys moved by more
//    than one bfloat16 step from the float32 result. l sums the float32
//    weights. Only the diagonal tiles and the kv_len edge tile take the
//    mask; tiles past kv_len or above the block's diagonal are not
//    visited, a warpgroup skips tiles above its own rows, and blocks walk
//    the q tiles from the last, so the longest causal rows start first.
// 2. bfloat16, T <= 16 (a decode step, a short block): flash_decode_bf16.
//    One block of 4 warps per (batch * kv head, 16 of the group's T x
//    Hq / Hkv query rows, kv split), so each K / V byte is read once per kv
//    head, not once per query head. The kv range is split over blocks
//    (a decode step has only batch x kv heads blocks, fewer than the card
//    has SMs) and streamed through a cp.async ring of 64-position tiles
//    (four stages at dh 64, three at dh 128). Each warp takes 16 positions
//    of a tile against all 16 rows on mma.sync.m16n8k16 through ldmatrix
//    (ldmatrix.trans for V; rows past T x group are zero: the tensor cores'
//    idle lanes cost nothing at a step bound by bytes), with P split hi +
//    lo as in 1., and keeps its own m / l / acc; the four warps merge in
//    shared memory at the end. With several splits each block writes its
//    unnormalised acc, m (a scaled score) and l to a float32 scratch and
//    flash_combine_kernel merges them.
// 3. float32 (tests only; the LM serves bfloat16): flash_fwd_kernel, the
//    first port's design kept as it was. It stages float32 K (transposed)
//    and V in shared memory; each thread holds a 4 x 4 tile of scores and
//    does all math as float32 FMAs on the CUDA cores, so it keeps the
//    float32 tolerance (2e-4), which TF32 would not. Decode (T <= 16) takes
//    16 rows and splits the kv range like 2.
//
// Left for later: warp specialisation (a producer warp issuing TMA into an
// mbarrier ring, two consumer warpgroups that ping-pong softmax against
// each other's wgmma), persistent blocks that overlap one tile's epilogue
// with the next one's loads, fp8 operands, and one block per kv head for
// GQA prefill (K / V are read once per q head there, from L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 64;          // kv positions per tile
constexpr int kTX = 16;          // lanes sharing a query row (float32 kernel)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
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

// ------------------------------------------------- float32, CUDA cores (3.)

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

// ------------------------------------------ bfloat16 tensor-core helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred (src is
// then any valid address and no byte of it is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> bf16x2 hi = bf16((x, y)) and lo = bf16((x, y) - hi); x in the low half
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x on the SFU (ex2.approx, flush to zero: 2^-1e30 is 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c (8 columns) of row r in a bf16 tile of ROWS
// rows: 64 columns (128 bytes) a row in each of DH / 64 column blocks of
// ROWS x 128 bytes, chunk c % 8 of row r at (c % 8) ^ (r % 8). This is the
// 128-byte swizzle wgmma reads (its atom: 8 rows, 1,024 bytes, aligned)
// and keeps cp.async stores and ldmatrix reads free of bank conflicts.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// rows [row0, row0 + ROWS) of a (position, DH) bf16 operand into a swizzled
// tile; rows at or past `limit` are zero-filled and never read
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int limit, int tid) {
  constexpr int kChunks = DH / 8;
#pragma unroll
  for (int e = tid; e < ROWS * kChunks; e += NT) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = row0 + r < limit;
    const __nv_bfloat16* g = ok ? src + (long long)(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + swz<ROWS>(r, c), g, ok);
  }
}

// the A fragments of a [16][DH] tile of query rows, all of DH
template <int DH>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[DH / 16][4], uint32_t qs, int lane) {
  const int r = (((lane >> 3) & 1) << 3) + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm_x4(qs + swz<16>(r, 2 * kk + (lane >> 4)), qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
}

// s0, s1 += Q . K^T over kv rows 16 jp .. 16 jp + 15 of a [kBK][DH] tile
template <int DH>
__device__ __forceinline__ void qk_pair(float (&s0)[4], float (&s1)[4],
                                        const uint32_t (&qf)[DH / 16][4], uint32_t ks, int jp,
                                        int lane) {
  const int r = 16 * jp + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4(ks + swz<kBK>(r, 2 * kk + ((lane >> 3) & 1)), b0, b1, b2, b3);
    mma_bf16(s0, qf[kk], b0, b1);
    mma_bf16(s1, qf[kk], b2, b3);
  }
}

// P (16 x 16) as the A fragments hi and lo, from the C fragments sa
// (columns 0-7) and sb (8-15) of the scores turned weights
__device__ __forceinline__ void p_frags(const float (&sa)[4], const float (&sb)[4],
                                        uint32_t (&ph)[4], uint32_t (&pl)[4]) {
  split_bf16x2(sa[0], sa[1], ph[0], pl[0]);
  split_bf16x2(sa[2], sa[3], ph[1], pl[1]);
  split_bf16x2(sb[0], sb[1], ph[2], pl[2]);
  split_bf16x2(sb[2], sb[3], ph[3], pl[3]);
}

// acc += P . V over kv rows 16 kk .. 16 kk + 15 of a [kBK][DH] tile, P = hi + lo
template <int DH>
__device__ __forceinline__ void pv_step(float (&acc)[DH / 8][4], const float (&sa)[4],
                                        const float (&sb)[4], uint32_t vs, int kk, int lane) {
  uint32_t ph[4], pl[4];
  p_frags(sa, sb, ph, pl);
  const int r = 16 * kk + (((lane >> 3) & 1) << 3) + (lane & 7);
#pragma unroll
  for (int jp = 0; jp < DH / 16; ++jp) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_trans(vs + swz<kBK>(r, 2 * jp + (lane >> 4)), b0, b1, b2, b3);
    mma_bf16(acc[2 * jp], ph, b0, b1);
    mma_bf16(acc[2 * jp + 1], ph, b2, b3);
    mma_bf16(acc[2 * jp], pl, b0, b1);
    mma_bf16(acc[2 * jp + 1], pl, b2, b3);
  }
}

// one online-softmax step for a thread's two rows (g, g + 8) over N n8
// tiles of raw scores s (q . k, masked ones -1e30) with m the running max
// of raw scores: the weights are 2^(s c - m c), c = scale * log2(e), one
// FFMA and one ex2 each; acc rescaled, s turned into weights. A row that
// has seen only masked scores (m = -1e30) takes 0 for m c, so its weights
// are 0 (s c - m c would be the rounding error of -1e30 c, ~1e22), and its
// l and acc stay 0 until a visible key comes
template <int N, int DH>
__device__ __forceinline__ void softmax_step(float (&s)[N][4], float c, float (&m)[2],
                                             float (&l)[2], float (&acc)[DH / 8][4]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = exp2_approx((m[i] - m_new) * c);
    m[i] = m_new;
  }
  const float mc[2] = {m[0] == kNegInf ? 0.f : m[0] * c, m[1] == kNegInf ? 0.f : m[1] * c};
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_approx(fmaf(s[j][e], c, -mc[e >> 1]));
      rs[e >> 1] += s[j][e];
    }
  }
  // l is this thread's share of the row sum; the quad adds them at the end
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
}

// ------------------------------------------------ wgmma helpers (prefill)

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (LBO, SBO), each in 16-byte units
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// what cp.async wrote (the generic proxy) is visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving uses of wgmma's registers across its issue / wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[j][e])::"memory");
}

// d (64 x 64 a warpgroup, as m16n8 C fragments a warp) = A (64 x 16) . B (16 x 64)
// (_first) or d + A . B, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_first(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]),
        "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]), "=f"(d[1][3]),
        "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]),
        "=f"(d[3][0]), "=f"(d[3][1]), "=f"(d[3][2]), "=f"(d[3][3]),
        "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]), "=f"(d[4][3]),
        "=f"(d[5][0]), "=f"(d[5][1]), "=f"(d[5][2]), "=f"(d[5][3]),
        "=f"(d[6][0]), "=f"(d[6][1]), "=f"(d[6][2]), "=f"(d[6][3]),
        "=f"(d[7][0]), "=f"(d[7][1]), "=f"(d[7][2]), "=f"(d[7][3])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 16; a warp's m16n8k16 A fragment from registers) . B (16 x N,
// MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------ bfloat16 prefill (1.)

// Per head dim: warps (a warpgroup of 64 query rows per four), ring stages
// of kBK-position K / V tiles (filled stages - 1 tiles ahead), and the
// blocks an SM the registers are capped for, none spilled: dh 64, 128 rows
// and two blocks an SM (128 registers); dh 128, 192 rows and one (170).
template <int DH>
struct Prefill;
template <>
struct Prefill<64> {
  static constexpr int kWarps = 8, kStages = 2, kMinBlocks = 2;
};
template <>
struct Prefill<128> {
  static constexpr int kWarps = 12, kStages = 3, kMinBlocks = 1;
};
template <int DH>
constexpr int kPrefillRows = 16 * Prefill<DH>::kWarps;  // query rows a block

template <int DH>
constexpr int prefill_smem_bytes() {  // + 1 KB to align the tiles to the swizzle atom
  return (kPrefillRows<DH> + 2 * Prefill<DH>::kStages * kBK) * DH * 2 + 1024;
}

template <int DH>
__global__ void __launch_bounds__(32 * Prefill<DH>::kWarps, Prefill<DH>::kMinBlocks)
flash_prefill_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int hq,
                   int group, int t_len, Strides st, int causal, int q_offset, int kv_len,
                   float scale_log2) {
  constexpr int kThreads = 32 * Prefill<DH>::kWarps, kRows = kPrefillRows<DH>;
  constexpr int kStages = Prefill<DH>::kStages, kAhead = kStages - 1;
  constexpr int kTile = kBK * DH * 2;  // bytes of one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  const uint32_t qs = (smem_u32(smem_bf16) + 1023u) & ~1023u;
  const uint32_t ks = qs + kRows * DH * 2;
  const uint32_t vs = ks + kStages * kTile;

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest rows first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;  // warpgroup: query rows 64 wg .. 64 wg + 63 of the block
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qg = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kg = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vg = v + b * st.vb + hk * st.vh;

  int kv_end = kv_len;  // one past the last kv position any row of the block sees
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + kRows, t_len));
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  load_rows<DH, kRows, kThreads>(qs, qg, st.qt, q0, t_len, tid);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < n_tiles) {
      load_rows<DH, kBK, kThreads>(ks + j * kTile, kg, st.ks, j * kBK, kv_len, tid);
      load_rows<DH, kBK, kThreads>(vs + j * kTile, vg, st.vs, j * kBK, kv_len, tid);
    }
    cp_async_commit();
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int wg_last = q_offset + q0 + 64 * wg + 63;  // kv position of the warpgroup's last row
  const int wpos = q_offset + q0 + warp * 16;  // and of this warp's first row
  const int pos0 = wpos + g, pos1 = pos0 + 8;  // this thread's two rows
  // Q (A) and K (B) K-major: 8-row atoms 1,024 bytes apart (SBO), a k step
  // of 16 columns 32 bytes into the row, a second 64-column block past the
  // first; V (B) MN-major: a k step of 16 kv rows is two atoms, the second
  // 64 dh columns one block (LBO) on. A descriptor's start address is its
  // low 14 bits in 16-byte units, so an offset within the tile is an add.
  uint64_t dq[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    dq[kk] = gmma_desc(qs + wg * 64 * 128 + (kk >> 2) * (kRows * 128) + (kk & 3) * 32, 0,
                       1024);

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of tile j (and q) have landed
    fence_async_smem();
    __syncthreads();  // everyone's have, and everyone is done with tile j - 1
    const int ahead = j + kAhead;  // into the stage tile j - 1 left
    if (ahead < n_tiles) {
      const int stage = ahead % kStages;
      load_rows<DH, kBK, kThreads>(ks + stage * kTile, kg, st.ks, ahead * kBK, kv_len, tid);
      load_rows<DH, kBK, kThreads>(vs + stage * kTile, vg, st.vs, ahead * kBK, kv_len, tid);
    }
    cp_async_commit();
    const int kv0 = j * kBK;
    if (causal && kv0 > wg_last) continue;  // above the warpgroup's diagonal
    const uint32_t kt = ks + (j % kStages) * kTile;
    const uint32_t vt = vs + (j % kStages) * kTile;

    // S = Q K^T on the tensor cores
    float s[kBK / 8][4];
    wgmma_fence();
    const uint64_t dk = gmma_desc(kt, 0, 1024);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint64_t dkk = dk + (((kk >> 2) * (kBK * 128) + (kk & 3) * 32) >> 4);
      if (kk == 0)
        wgmma_ss_first(s, dq[kk], dkk);
      else
        wgmma_ss(s, dq[kk], dkk);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    if (kv0 + kBK > kv_len || (causal && kv0 + kBK - 1 > wpos)) {  // edge or diagonal tile
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + 8 * n + 2 * t4 + (e & 1);
          const bool ok = col < kv_len && (!causal || col <= ((e >> 1) ? pos1 : pos0));
          s[n][e] = ok ? s[n][e] : kNegInf;
        }
    }
    softmax_step<kBK / 8, DH>(s, scale_log2, m, l, acc);

    // O += P V, P = hi + lo from registers
    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) p_frags(s[2 * kk], s[2 * kk + 1], ph[kk], pl[kk]);
    reg_fence(acc);
    wgmma_fence();
    const uint64_t dv = gmma_desc(vt, kBK * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_rs(acc, ph[kk], dv + ((kk * 16 * 128) >> 4));
      wgmma_rs(acc, pl[kk], dv + ((kk * 16 * 128) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __nv_bfloat16* og = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + g + 8 * i;
    if (r >= t_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(og + r * st.ot + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
  }
}

// ------------------------------------------------- bfloat16 decode (2.)

constexpr int kDecodeWarps = 4;  // each takes 16 of a tile's 64 positions
constexpr int kDecodeRows = 16;  // query rows (T x group) per block
// ring depth: 66 KB (dh 64) or 100 KB (dh 128) a block, three or two blocks an SM
template <int DH>
constexpr int kDecodeStages = DH == 64 ? 4 : 3;

template <int DH>
constexpr int decode_smem_bytes() {
  return (kDecodeRows + 2 * kDecodeStages<DH> * kBK) * DH * 2;
}

template <int DH>
__global__ void __launch_bounds__(32 * kDecodeWarps)
flash_decode_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int hq,
                  int hkv, int group, int t_len, Strides st, int causal, int q_offset,
                  int kv_len, float scale_log2, int tiles_per_split, float* __restrict__ part) {
  constexpr int kThreads = 32 * kDecodeWarps;
  constexpr int kTile = kBK * DH * 2;
  constexpr int kChunks = DH / 8;
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  const uint32_t qs = smem_u32(smem_bf16);
  const uint32_t ks = qs + kDecodeRows * DH * 2;
  const uint32_t vs = ks + kDecodeStages<DH> * kTile;

  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int n_rows = t_len * group, i0 = blockIdx.y * kDecodeRows;  // row i: head i / T, t i % T
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  for (int e = tid; e < kDecodeRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks, i = i0 + r;
    const bool ok = i < n_rows;
    const __nv_bfloat16* src =
        ok ? q + b * st.qb + (hk * group + i / t_len) * st.qh + (i % t_len) * st.qt + c * 8 : q;
    cp_async16(qs + swz<kDecodeRows>(r, c), src, ok);
  }
  cp_async_commit();

  const __nv_bfloat16* kg = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vg = v + b * st.vb + hk * st.vh;
  const int kv_end = causal ? min(kv_len, q_offset + t_len) : kv_len;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int tile0 = blockIdx.z * tiles_per_split;
  const int n = max(0, min(n_tiles, tile0 + tiles_per_split) - tile0);
#pragma unroll
  for (int j = 0; j < kDecodeStages<DH> - 1; ++j) {
    if (j < n) {
      load_rows<DH, kBK, kThreads>(ks + j * kTile, kg, st.ks, (tile0 + j) * kBK, kv_len, tid);
      load_rows<DH, kBK, kThreads>(vs + j * kTile, vg, st.vs, (tile0 + j) * kBK, kv_len, tid);
    }
    cp_async_commit();
  }

  uint32_t qf[DH / 16][4];
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int pos0 = q_offset + (i0 + g) % t_len, pos1 = q_offset + (i0 + g + 8) % t_len;

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kDecodeStages<DH> - 2>();  // this thread's copies of q and tile j have landed
    __syncthreads();  // everyone's have, and everyone is done with tile j - 1
    const int ahead = j + kDecodeStages<DH> - 1;  // into the stage tile j - 1 left
    if (ahead < n) {
      const int stage = ahead % kDecodeStages<DH>;
      load_rows<DH, kBK, kThreads>(ks + stage * kTile, kg, st.ks, (tile0 + ahead) * kBK,
                                   kv_len, tid);
      load_rows<DH, kBK, kThreads>(vs + stage * kTile, vg, st.vs, (tile0 + ahead) * kBK,
                                   kv_len, tid);
    }
    cp_async_commit();
    if (j == 0) load_q_frags<DH>(qf, qs, lane);
    const uint32_t kt = ks + (j % kDecodeStages<DH>) * kTile;
    const uint32_t vt = vs + (j % kDecodeStages<DH>) * kTile;
    const int kv0 = (tile0 + j) * kBK + 16 * warp;  // this warp's 16 positions
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    qk_pair<DH>(s[0], s[1], qf, kt, warp, lane);
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + 8 * nn + 2 * t4 + (e & 1);
        const bool ok = col < kv_len && (!causal || col <= ((e >> 1) ? pos1 : pos0));
        s[nn][e] = ok ? s[nn][e] : kNegInf;
      }
    softmax_step<2, DH>(s, scale_log2, m, l, acc);
    pv_step<DH>(acc, s[0], s[1], vt, warp, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: reuse it for the warps' partial sums

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  constexpr int kW = DH + 2;  // [warp][row][acc..., m, l]
  float* red = reinterpret_cast<float*>(smem_bf16 + kDecodeRows * DH * 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* rw = red + (warp * kDecodeRows + g + 8 * i) * kW;
#pragma unroll
    for (int nn = 0; nn < DH / 8; ++nn) {
      rw[8 * nn + 2 * t4] = acc[nn][2 * i];
      rw[8 * nn + 2 * t4 + 1] = acc[nn][2 * i + 1];
    }
    if (t4 == 0) {
      rw[DH] = m[i];
      rw[DH + 1] = l[i];
    }
  }
  __syncthreads();

  for (int e = tid; e < kDecodeRows * DH; e += kThreads) {
    const int r = e / DH, c = e % DH, i = i0 + r;
    if (i >= n_rows) break;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, red[(w * kDecodeRows + r) * kW + DH]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float* rw = red + (w * kDecodeRows + r) * kW;
      const float wt = exp2f((rw[DH] - mx) * scale_log2);
      lsum = fmaf(rw[DH + 1], wt, lsum);
      a = fmaf(rw[c], wt, a);
    }
    const int h = hk * group + i / t_len, t = i % t_len;
    if (part != nullptr) {  // (splits, B * Hq, T, DH + 2), m as a scaled score
      float* pb = part + (((size_t)blockIdx.z * gridDim.x * group + b * hq + h) * t_len + t) * kW;
      pb[c] = a;
      if (c == 0) {
        pb[DH] = mx * scale_log2 * kLn2;
        pb[DH + 1] = lsum;
      }
    } else {
      o[b * st.ob + h * st.oh + t * st.ot + c] = __float2bfloat16_rn(a / fmaxf(lsum, 1e-30f));
    }
  }
}

// ------------------------------------------------------------- launches

enum Variant { kF32 = 0, kPrefill = 1, kDecode = 2 };

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o, int hq, int hkv, int t_len,
               const Strides& st, int causal, int q_offset, int kv_len, float scale,
               const dim3& grid, int tiles_per_split, float* part, cudaStream_t stream) {
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  float* pp = grid.z > 1 ? part : nullptr;
  int err;
  if (t_len <= 16) {
    constexpr int kSmem = smem_floats<DH, 16>() * (int)sizeof(float);
    if ((err = set_smem(flash_fwd_kernel<float, DH, 16>, kSmem))) return err;
    flash_fwd_kernel<float, DH, 16><<<grid, 4 * kTX, kSmem, stream>>>(
        qq, kk, vv, oo, hq, hq / hkv, t_len, st, causal, q_offset, kv_len, scale,
        tiles_per_split, pp);
  } else {
    constexpr int kSmem = smem_floats<DH, 64>() * (int)sizeof(float);
    if ((err = set_smem(flash_fwd_kernel<float, DH, 64>, kSmem))) return err;
    flash_fwd_kernel<float, DH, 64><<<grid, 16 * kTX, kSmem, stream>>>(
        qq, kk, vv, oo, hq, hq / hkv, t_len, st, causal, q_offset, kv_len, scale,
        tiles_per_split, pp);
  }
  return 0;
}

template <int DH>
int launch_bf16(int variant, const void* q, const void* k, const void* v, void* o, int hq,
                int hkv, int t_len, const Strides& st, int causal, int q_offset, int kv_len,
                float scale, const dim3& grid, int tiles_per_split, float* part,
                cudaStream_t stream) {
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  const float scale_log2 = scale * kLog2e;
  int err;
  if (variant == kPrefill) {
    constexpr int kSmem = prefill_smem_bytes<DH>();
    if ((err = set_smem(flash_prefill_bf16<DH>, kSmem))) return err;
    flash_prefill_bf16<DH><<<grid, 32 * Prefill<DH>::kWarps, kSmem, stream>>>(
        qq, kk, vv, oo, hq, hq / hkv, t_len, st, causal, q_offset, kv_len, scale_log2);
  } else {
    constexpr int kSmem = decode_smem_bytes<DH>();
    if ((err = set_smem(flash_decode_bf16<DH>, kSmem))) return err;
    flash_decode_bf16<DH><<<grid, 32 * kDecodeWarps, kSmem, stream>>>(
        qq, kk, vv, oo, hq, hkv, hq / hkv, t_len, st, causal, q_offset, kv_len, scale_log2,
        tiles_per_split, grid.z > 1 ? part : nullptr);
  }
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike). strides: 12 element
// strides, (batch, head, position) of q, k, v and out. variant, splits and
// tiles_per_split are the wrapper's plan (ops.plan), which picks the
// variant and the kv split; the grid's x and y follow from the variant
// here: 0 the float32 kernel, (B * Hq, q tiles of 16 rows when T <= 16
// else 64); 1 the bfloat16 prefill kernel, (B * Hq, q tiles of
// kPrefillRows); 2 the bfloat16 decode kernel, (B * Hkv, tiles of
// kDecodeRows of the T * Hq / Hkv rows). Splits that leave a split empty
// or a kv tile uncovered are refused. part: float32 scratch of
// splits * B * Hq * T * (dh + 2) when splits > 1.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int batch, int hq, int hkv, int t_len, int s_len,
                                   int dh, const long long* strides, int causal, int q_offset,
                                   int kv_len, float scale, int variant, int splits,
                                   int tiles_per_split, float* part, cudaStream_t stream) {
  if (batch == 0 || t_len == 0 || hq == 0) return 0;
  if (hkv < 1 || hq % hkv != 0 || kv_len < 0 || kv_len > s_len || q_offset < 0 ||
      (dh != 64 && dh != 128) || (dtype == 0) != (variant == kF32) || variant < 0 ||
      variant > kDecode || (variant == kDecode && t_len > 16))
    return (int)cudaErrorInvalidValue;
  const int rows = variant == kF32 ? (t_len <= 16 ? 16 : 64)
                 : variant == kPrefill ? (dh == 64 ? kPrefillRows<64> : kPrefillRows<128>)
                                       : kDecodeRows;
  const int grid_y = ((variant == kDecode ? t_len * (hq / hkv) : t_len) + rows - 1) / rows;
  const int kv_end = causal ? min(kv_len, q_offset + t_len) : kv_len;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  if (grid_y > 65535 || splits < 1 || splits > 65535 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < n_tiles ||
      (splits > 1 && ((splits - 1) * tiles_per_split >= n_tiles || !part ||
                      (variant == kF32 && t_len > 16) || variant == kPrefill)))
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2],  strides[3],  strides[4],  strides[5],
                   strides[6], strides[7], strides[8],  strides[9],  strides[10], strides[11]};
  const dim3 grid(variant == kDecode ? batch * hkv : batch * hq, grid_y, splits);
  int err;
  if (dtype == 0)
    err = dh == 64 ? launch_f32<64>(q, k, v, o, hq, hkv, t_len, st, causal, q_offset, kv_len,
                                    scale, grid, tiles_per_split, part, stream)
                   : launch_f32<128>(q, k, v, o, hq, hkv, t_len, st, causal, q_offset, kv_len,
                                     scale, grid, tiles_per_split, part, stream);
  else
    err = dh == 64 ? launch_bf16<64>(variant, q, k, v, o, hq, hkv, t_len, st, causal, q_offset,
                                     kv_len, scale, grid, tiles_per_split, part, stream)
                   : launch_bf16<128>(variant, q, k, v, o, hq, hkv, t_len, st, causal,
                                      q_offset, kv_len, scale, grid, tiles_per_split, part,
                                      stream);
  if (err) return err;
  if (splits > 1) {
    err = (int)cudaGetLastError();
    if (err) return err;
    const dim3 cgrid(batch * hq, t_len);
    if (dtype == 0) {
      if (dh == 64)
        flash_combine_kernel<float, 64><<<cgrid, 64, 0, stream>>>(part, splits, hq, t_len,
                                                                 static_cast<float*>(o), st);
      else
        flash_combine_kernel<float, 128><<<cgrid, 128, 0, stream>>>(part, splits, hq, t_len,
                                                                   static_cast<float*>(o), st);
    } else {
      if (dh == 64)
        flash_combine_kernel<__nv_bfloat16, 64><<<cgrid, 64, 0, stream>>>(
            part, splits, hq, t_len, static_cast<__nv_bfloat16*>(o), st);
      else
        flash_combine_kernel<__nv_bfloat16, 128><<<cgrid, 128, 0, stream>>>(
            part, splits, hq, t_len, static_cast<__nv_bfloat16*>(o), st);
    }
  }
  return (int)cudaGetLastError();
}
