// Fused candidate filter of the LMI query for Hopper (sm_90a): gather of
// candidate rows from the bucket-sorted store, dequantization, distance to
// the query, then either the full (Q, C) distance matrix (range queries) or
// a top-k (kNN queries).
//
// Replaces: src/repro/kernels/lmi_filter/kernel.py,
//   lmi_filter_topk_desc_pallas  (kernel.py:691)  descriptor gather, top-k
//   lmi_filter_range_desc_pallas (kernel.py:650)  descriptor gather, (Q, C)
//   lmi_filter_topk_pallas       (kernel.py:604)  row gather, top-k
//   lmi_filter_range_pallas      (kernel.py:565)  row gather, (Q, C)
// and the quantized tiers inside them: _dequant (kernel.py:230),
// _run_scale_plane (:212) and _tile_distances_int (:274).
//
// Operands (built by repro_torch/kernels/lmi_filter/ops.py):
//   store (M, d): float32, bfloat16 (raw uint16 bits), int8, or fp8-e4m3
//     (raw bytes); valid (Q, C) u8;
//   gather, one of: rows (Q, C) int32, the slot -> CSR row map; or the
//     per-run descriptors nrun (Q,), dstart / doff / dlen (Q, K) int32 — run
//     r of query q covers slots doff..doff+dlen-1 with CSR rows dstart..;
//     runs are compacted in slot order, so doff is ascending;
//   scales (quantized stores): (M,) f32 read at each slot's row (row mode),
//     or (Q, K) f32, one per descriptor (run mode, bucket granularity);
//   float32 compute: q (Q, d) f32; the tile is widened and multiplied by its
//     slot's scale, then the norm decomposition runs in f32;
//   int8 compute (int8 store): q (Q, d) int8 codes with qscale (Q,) f32 and
//     norms (M,) int32 (the store's integer |c|^2); the dot is int8 x int8 ->
//     int32 (__dp4a, exact: |qc| <= 127^2 d), the scales touch only the
//     epilogue, in the JAX order of operations with rounded (uncontracted)
//     float steps, and cosine is scale-free.
//
// Contract, as the TPU kernel (kernel.py:251-317, :454-466):
//   euclidean  sqrt(max(cn + qn - 2 qc, 0));  sq_euclidean max(cn + qn - 2 qc, 0)
//   cosine     1 - qc / sqrt(max(cn * qn, 1e-24))
//   int8:      max(s_c^2 cn - 2 (s_c s_q) qc + s_q^2 qn, 0) (sqrt for euclidean)
//   invalid or uncovered slots 3.4e38; top-k ascending with ties to the
//   lowest slot (a lexicographic (dist, slot) order, equal to a stable
//   sort), exhausted entries 3.4e38 / -1.
//
// What bounds it on the H100: bytes. A 512-query batch of the paper's
// index gathers ~512 x 5.3k candidate rows of 45 elements (1 or 2 B each in
// the compact tiers); the few operations per gathered element are far below
// the card's rates. A batch touches far fewer distinct rows than it gathers
// and the compact stores fit in the 50 MB L2, so the least DRAM traffic is
// the distinct rows read once (chip_smoke.py computes that bound from the
// run's own operands).
// Design: one block per query; the query's slots go through shared memory
// in tiles of up to 256 slots. Descriptor form: a cursor walks the query's
// runs in slot order; per tile each thread expands one run into the slot ->
// row map (and its run scale). Row form: each thread reads its slot's row.
// Then the block copies the tile's rows cooperatively: consecutive threads
// read consecutive elements of a row, each thread keeps 8 loads in flight;
// bf16 widens with a 16-bit shift, fp8 through cuda_fp8.h (exact). Rows
// start at unaligned addresses in the 1-byte tiers (45 B), so elements are
// loaded one by one. float32 compute keeps f32 rows at an odd word stride
// (conflict-free per-slot reads); int8 compute keeps the raw codes packed 4
// to a word at an odd word stride, zero-padded query words, for __dp4a.
// The top-k keeps a sorted list of k (dist, slot) pairs in shared memory; a
// tile's slots that beat the current k-th are appended and merged by rank
// counting, which makes the result independent of the order threads append.
// Tensor-core (mma) int8 / e4m3 products, TMA bulk copies per run and
// several queries per block are later work.
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 256;
constexpr int kUnroll = 8;  // gather loads in flight per thread
constexpr float kBig = 3.4e38f;
constexpr float kEps2 = 1e-24f;
constexpr int kSmemLimit = 232448;  // 227 KB, the most a block can opt in to

enum StoreType { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };
enum ScaleMode { kNoScale = 0, kRowScale = 1, kRunScale = 2 };

// one raw store element -> f32, exact for every store type
__device__ __forceinline__ float load_elem(const float* s, size_t i) { return __ldg(s + i); }

__device__ __forceinline__ float load_elem(const uint16_t* s, size_t i) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(s + i)) << 16);  // bf16
}

__device__ __forceinline__ float load_elem(const signed char* s, size_t i) {
  return static_cast<float>(__ldg(s + i));
}

__device__ __forceinline__ float load_elem(const __nv_fp8_e4m3* s, size_t i) {
  __nv_fp8_e4m3 v;
  v.__x = __ldg(reinterpret_cast<const unsigned char*>(s) + i);
  return static_cast<float>(v);
}

struct Operands {
  const void* q;          // (Q, d) f32 queries, or int8 codes (int compute)
  const float* qscale;    // (Q,) query scales, int compute only
  const void* store;      // (M, d)
  const float* scales;    // (M,) row mode, (Q, K) run mode
  const int* norms;       // (M,) int compute only
  const uint8_t* valid;   // (Q, C)
  const int* rows;        // (Q, C), row gather only
  const int* nrun;        // descriptor gather only
  const int* dstart;
  const int* doff;
  const int* dlen;
  int C, K, d, M, metric, scale_mode, k;
  int stride;  // shared-memory words per candidate row
  int tile;    // slots per tile
  float* out_d;
  int* out_s;
};

// one query's view of the operands
struct Query {
  const uint8_t* valid;
  const int* rows;
  const int* dstart;
  const int* doff;
  const int* dlen;
  const float* dscale;
  int nrun;
  int ncov;  // slots 0..ncov-1 may hold a candidate
  float qn;
  float qscale;
};

template <bool kDesc>
__device__ __forceinline__ Query make_query(const Operands& op, int qi) {
  Query r;
  r.valid = op.valid + (size_t)qi * op.C;
  r.rows = nullptr;
  r.dstart = r.doff = r.dlen = nullptr;
  r.dscale = nullptr;
  r.nrun = 0;
  r.ncov = op.C;
  r.qn = 0.f;
  r.qscale = 1.f;
  if (kDesc) {
    const size_t base = (size_t)qi * op.K;
    r.dstart = op.dstart + base;
    r.doff = op.doff + base;
    r.dlen = op.dlen + base;
    if (op.scale_mode == kRunScale) r.dscale = op.scales + base;
    r.nrun = min(__ldg(op.nrun + qi), op.K);
    r.ncov = r.nrun > 0 ? min(__ldg(r.doff + r.nrun - 1) + __ldg(r.dlen + r.nrun - 1), op.C) : 0;
  } else {
    r.rows = op.rows + (size_t)qi * op.C;
  }
  return r;
}

__device__ __forceinline__ float finish(float qc, float cn, float qn, int metric) {
  if (metric == 2) return 1.f - qc / sqrtf(fmaxf(cn * qn, kEps2));
  const float d2 = fmaxf(cn + qn - 2.f * qc, 0.f);
  return metric == 0 ? sqrtf(d2) : d2;
}

// The integer-domain epilogue, each float step rounded as in the plain
// version (no FMA contraction): (s*s)*cn - (2*(s*sq))*qc + (sq*sq)*qn.
__device__ __forceinline__ float finish_int(float qc, float cn, float qn, float sc, float sq,
                                            int metric) {
  if (metric == 2) return 1.f - qc / sqrtf(fmaxf(__fmul_rn(cn, qn), kEps2));
  const float a = __fmul_rn(__fmul_rn(sc, sc), cn);
  const float b = __fmul_rn(__fmul_rn(2.f, __fmul_rn(sc, sq)), qc);
  const float c = __fmul_rn(__fmul_rn(sq, sq), qn);
  const float d2 = fmaxf(__fadd_rn(__fsub_rn(a, b), c), 0.f);
  return metric == 0 ? sqrtf(d2) : d2;
}

struct Smem {
  float* q;      // d floats, or the packed int8 query words
  int* row;      // tile
  float* scale;  // tile
  float* cand;   // tile * stride words
  int* cursor;   // first run that can reach the current tile
  int* next;     // the last run that starts before the current tile's end
};

__device__ __forceinline__ int query_words(int d, bool int_compute) {
  return int_compute ? (d + 3) / 4 : d;
}

__device__ __forceinline__ Smem carve(float* base, int* cursor, const Operands& op,
                                      bool int_compute) {
  Smem s;
  s.q = base;
  s.row = reinterpret_cast<int*>(base + query_words(op.d, int_compute));
  s.scale = reinterpret_cast<float*>(s.row + op.tile);
  s.cand = s.scale + op.tile;
  s.cursor = cursor;
  s.next = cursor + 1;
  if (threadIdx.x == 0) cursor[0] = cursor[1] = 0;  // load_query synchronises
  return s;
}

template <bool kInt>
__device__ __forceinline__ void load_query(const Operands& op, int qi, const Smem& sm,
                                           Query& qr) {
  const int d = op.d;
  if (kInt) {
    const signed char* q = static_cast<const signed char*>(op.q) + (size_t)qi * d;
    const int nw = (d + 3) / 4;
    int* qw = reinterpret_cast<int*>(sm.q);
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
      uint32_t word = 0;  // bytes past d stay 0, so padded lanes add nothing
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * w + b;
        if (j < d) word |= static_cast<uint32_t>(static_cast<uint8_t>(q[j])) << (8 * b);
      }
      qw[w] = static_cast<int>(word);
    }
    __syncthreads();
    int qn = 0;
    for (int w = 0; w < nw; ++w) qn = __dp4a(qw[w], qw[w], qn);
    qr.qn = static_cast<float>(qn);  // exact: < 2^24
    qr.qscale = __ldg(op.qscale + qi);
  } else {
    const float* q = static_cast<const float*>(op.q) + (size_t)qi * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) sm.q[j] = q[j];
    __syncthreads();
    float qn = 0.f;
    for (int j = 0; j < d; ++j) qn = fmaf(sm.q[j], sm.q[j], qn);
    qr.qn = qn;
  }
}

// Fill the tile's slot -> row map (and per-slot scale) for slots
// t0..t0+tile-1: -1 where no candidate row is to be read.
template <bool kDesc>
__device__ __forceinline__ void map_tile(const Operands& op, const Query& qr, const Smem& sm,
                                         int t0) {
  const int t = threadIdx.x;
  const int tile = op.tile;
  if (!kDesc) {
    if (t < tile) {
      const int s = t0 + t;
      int row = -1;
      if (s < op.C && qr.valid[s]) {
        row = __ldg(qr.rows + s);
        if (row < 0 || row >= op.M) row = -1;  // never read outside the store
      }
      sm.row[t] = row;
      sm.scale[t] = op.scale_mode == kRowScale && row >= 0 ? __ldg(op.scales + row) : 1.f;
    }
    __syncthreads();
    return;
  }
  const int end = min(t0 + tile, qr.ncov);
  if (t < tile) {
    sm.row[t] = -1;
    sm.scale[t] = 1.f;
  }
  __syncthreads();
  // Runs are in slot order and each covers >= 1 slot, so the runs that
  // reach this tile are cursor .. cursor + tile: each thread maps the
  // slots of one run (independent loads, no search).
  const int first = *sm.cursor;
  for (int r = first + t; r < qr.nrun && r <= first + tile; r += blockDim.x) {
    const int o = __ldg(qr.doff + r);
    if (o >= end) continue;
    const int st = __ldg(qr.dstart + r);
    const int hi = min(o + __ldg(qr.dlen + r), end);
    const float sc = qr.dscale != nullptr ? __ldg(qr.dscale + r) : 1.f;
    for (int sl = max(o, t0); sl < hi; ++sl) {
      sm.row[sl - t0] = st + (sl - o);
      sm.scale[sl - t0] = sc;
    }
    atomicMax(sm.next, r);
  }
  __syncthreads();
  if (t == 0) *sm.cursor = *sm.next;  // read again only after the next tile's first sync
  if (op.scale_mode == kRowScale) {
    if (t < tile && sm.row[t] >= 0) sm.scale[t] = __ldg(op.scales + sm.row[t]);
    __syncthreads();
  }
}

// Gather the tile of slots t0..t0+tile-1 into shared memory and return the
// distance of this thread's slot (kBig when invalid, uncovered or idle).
// Every thread of the block calls it: it synchronises.
template <typename T, bool kDesc, bool kInt>
__device__ float tile_distance(const Operands& op, const Query& qr, const Smem& sm, int t0) {
  const int t = threadIdx.x;
  const int s = t0 + t;
  const int d = op.d;
  const int tile = op.tile;
  const T* __restrict__ store = static_cast<const T*>(op.store);
  __syncthreads();  // readers of the previous tile are done
  map_tile<kDesc>(op, qr, sm, t0);
  // kUnroll independent loads in flight per thread before any is stored:
  // one load at a time would leave the gather waiting on memory latency
  const int n_el = tile * d;
  const bool scaled = op.scale_mode != kNoScale;
  for (int base = t; base < n_el; base += kUnroll * blockDim.x) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * blockDim.x;
      const int sl = e / d;
      const int row = e < n_el ? sm.row[sl] : -1;
      v[u] = row >= 0 ? load_elem(store, (size_t)row * d + (e - sl * d)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * blockDim.x;
      const int sl = e / d;
      if (e >= n_el) continue;
      if (kInt) {  // the raw code, packed 4 to a word
        reinterpret_cast<signed char*>(sm.cand + sl * op.stride)[e - sl * d] =
            static_cast<signed char>(v[u]);
      } else {
        sm.cand[sl * op.stride + (e - sl * d)] = scaled ? v[u] * sm.scale[sl] : v[u];
      }
    }
  }
  __syncthreads();
  if (t >= tile || s >= op.C || sm.row[t] < 0 || !qr.valid[s]) return kBig;
  if (kInt) {
    // bytes past d in the candidate words are stale, but the query's are 0
    const int* c = reinterpret_cast<const int*>(sm.cand + t * op.stride);
    const int* qw = reinterpret_cast<const int*>(sm.q);
    int qc = 0;
    for (int w = 0; w < (d + 3) / 4; ++w) qc = __dp4a(c[w], qw[w], qc);
    const float cn = static_cast<float>(__ldg(op.norms + sm.row[t]));
    return finish_int(static_cast<float>(qc), cn, qr.qn, sm.scale[t], qr.qscale, op.metric);
  }
  const float* c = sm.cand + t * op.stride;
  float qc = 0.f, cn = 0.f;
  for (int j = 0; j < d; ++j) {
    const float v = c[j];
    qc = fmaf(v, sm.q[j], qc);
    cn = fmaf(v, v, cn);
  }
  return finish(qc, cn, qr.qn, op.metric);
}

template <typename T, bool kDesc, bool kInt>
__global__ void __launch_bounds__(kThreads) range_kernel(const Operands op) {
  extern __shared__ float smem[];
  __shared__ int cursor[2];
  const int qi = blockIdx.x;
  const Smem sm = carve(smem, cursor, op, kInt);
  Query qr = make_query<kDesc>(op, qi);
  load_query<kInt>(op, qi, sm, qr);  // synchronises
  float* out_q = op.out_d + (size_t)qi * op.C;
  int t0 = 0;
  for (; t0 < qr.ncov; t0 += op.tile) {
    const float dist = tile_distance<T, kDesc, kInt>(op, qr, sm, t0);
    const int s = t0 + threadIdx.x;
    if (threadIdx.x < op.tile && s < op.C) out_q[s] = dist;
  }
  for (int s = t0 + threadIdx.x; s < op.C; s += blockDim.x) out_q[s] = kBig;
}

__device__ __forceinline__ bool before(float da, int sa, float db, int sb) {
  return da < db || (da == db && sa < sb);
}

template <typename T, bool kDesc, bool kInt>
__global__ void __launch_bounds__(kThreads) topk_kernel(const Operands op) {
  extern __shared__ float smem[];
  __shared__ int n_new;
  __shared__ int cursor[2];
  const int qi = blockIdx.x;
  const int t = threadIdx.x;
  const int k = op.k;
  const int tile = op.tile;
  const Smem sm = carve(smem, cursor, op, kInt);
  float* top_d = sm.cand + tile * op.stride;  // k, ascending (dist, slot)
  int* top_s = reinterpret_cast<int*>(top_d + k);
  float* mrg_d = reinterpret_cast<float*>(top_s + k);  // k + tile
  int* mrg_s = reinterpret_cast<int*>(mrg_d + k + tile);

  // empty entries carry distinct sentinel slots above any real slot, so
  // every (dist, slot) key in a merge is unique and ranks are a permutation
  for (int i = t; i < k; i += blockDim.x) {
    top_d[i] = kBig;
    top_s[i] = INT_MAX - k + 1 + i;
  }
  if (t == 0) n_new = 0;
  Query qr = make_query<kDesc>(op, qi);
  load_query<kInt>(op, qi, sm, qr);  // synchronises

  for (int t0 = 0; t0 < qr.ncov; t0 += tile) {
    const float dist = tile_distance<T, kDesc, kInt>(op, qr, sm, t0);
    const int s = t0 + t;
    if (dist < kBig && before(dist, s, top_d[k - 1], top_s[k - 1])) {
      const int at = atomicAdd(&n_new, 1);
      mrg_d[k + at] = dist;
      mrg_s[k + at] = s;
    }
    __syncthreads();
    const int m = n_new;
    if (m > 0) {
      for (int i = t; i < k; i += blockDim.x) {
        mrg_d[i] = top_d[i];
        mrg_s[i] = top_s[i];
      }
      __syncthreads();
      const int n = k + m;
      for (int i = t; i < n; i += blockDim.x) {
        const float di = mrg_d[i];
        const int si = mrg_s[i];
        int rank = 0;
        for (int j = 0; j < n; ++j) rank += before(mrg_d[j], mrg_s[j], di, si);
        if (rank < k) {
          top_d[rank] = di;
          top_s[rank] = si;
        }
      }
    }
    __syncthreads();
    if (t == 0) n_new = 0;  // the next tile_distance synchronises before any append
  }
  __syncthreads();
  for (int i = t; i < k; i += blockDim.x) {
    const float di = top_d[i];
    op.out_d[(size_t)qi * k + i] = di;
    op.out_s[(size_t)qi * k + i] = di < kBig ? top_s[i] : -1;
  }
}

// Tile width, row stride and shared-memory bytes for a row width d and a
// top-k size k (0: range). Per slot: its row and scale, its candidate row
// (f32 words, or int8 codes packed 4 to a word), and for the top-k two
// merge entries; besides, the query and the k kept entries.
struct Plan {
  int stride;
  int tile;
  size_t smem;
};

Plan plan(int d, int k, bool int_compute) {
  Plan p;
  p.stride = (int_compute ? (d + 3) / 4 : d) | 1;  // odd: conflict-free per-slot reads
  const size_t fixed = (size_t)(int_compute ? (d + 3) / 4 : d) * 4 + (size_t)k * 16;
  const size_t per_slot = 8 + 4 * (size_t)p.stride + (k > 0 ? 8 : 0);
  p.tile = kMaxTile;
  while (p.tile > 32 && fixed + p.tile * per_slot > 96 * 1024) p.tile -= 32;
  p.smem = fixed + p.tile * per_slot;
  return p;
}

template <typename T, bool kDesc, bool kInt>
int launch(Operands op, int Q, cudaStream_t stream) {
  const Plan p = plan(op.d, op.k, kInt);
  if (p.smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  op.stride = p.stride;
  op.tile = p.tile;
  void (*kern)(Operands) =
      op.k > 0 ? &topk_kernel<T, kDesc, kInt> : &range_kernel<T, kDesc, kInt>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  kern<<<Q, kThreads, p.smem, stream>>>(op);
  return (int)cudaGetLastError();
}

template <bool kDesc>
int dispatch(const Operands& op, int Q, int store_type, int int_compute, cudaStream_t stream) {
  if (int_compute)
    return store_type == kI8 ? launch<signed char, kDesc, true>(op, Q, stream)
                             : (int)cudaErrorInvalidValue;
  switch (store_type) {
    case kF32: return launch<float, kDesc, false>(op, Q, stream);
    case kBF16: return launch<uint16_t, kDesc, false>(op, Q, stream);
    case kI8: return launch<signed char, kDesc, false>(op, Q, stream);
    case kFP8: return launch<__nv_fp8_e4m3, kDesc, false>(op, Q, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// store_type: 0 float32, 1 bfloat16, 2 int8, 3 fp8-e4m3. scale_mode: 0 none,
// 1 per row, 2 per run. int_compute: 1 for the int8 domain (int8 store,
// int8 queries + qscale + norms). metric: 0 euclidean, 1 sq_euclidean,
// 2 cosine. k: 0 writes the (Q, C) distances to out_d, k > 0 the top-k to
// out_d / out_s. rows != NULL selects the row gather, else the descriptors.
// Returns cudaGetLastError() after the launch.
extern "C" int lmi_filter(int store_type, int scale_mode, int int_compute, int metric, int k,
                          const void* q, const void* qscale, const void* store,
                          const void* scales, const void* norms, const void* valid,
                          const void* rows, const void* nrun, const void* dstart,
                          const void* doff, const void* dlen, int Q, int C, int K, int d, int M,
                          void* out_d, void* out_s, void* stream) {
  if (Q == 0 || (k == 0 && C == 0)) return 0;
  if (scale_mode == kRunScale && rows != nullptr) return (int)cudaErrorInvalidValue;
  Operands op;
  op.q = q;
  op.qscale = static_cast<const float*>(qscale);
  op.store = store;
  op.scales = static_cast<const float*>(scales);
  op.norms = static_cast<const int*>(norms);
  op.valid = static_cast<const uint8_t*>(valid);
  op.rows = static_cast<const int*>(rows);
  op.nrun = static_cast<const int*>(nrun);
  op.dstart = static_cast<const int*>(dstart);
  op.doff = static_cast<const int*>(doff);
  op.dlen = static_cast<const int*>(dlen);
  op.C = C;
  op.K = K;
  op.d = d;
  op.M = M;
  op.metric = metric;
  op.scale_mode = scale_mode;
  op.k = k;
  op.stride = op.tile = 0;
  op.out_d = static_cast<float*>(out_d);
  op.out_s = static_cast<int*>(out_s);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows != nullptr ? dispatch<false>(op, Q, store_type, int_compute, s)
                         : dispatch<true>(op, Q, store_type, int_compute, s);
}
