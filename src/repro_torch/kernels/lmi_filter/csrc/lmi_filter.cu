// Fused candidate filter of the LMI query for Hopper (sm_90a): per-run
// descriptor gather of candidate rows from the bucket-sorted store,
// norm-decomposition distance to the query, then either the full (Q, C)
// distance matrix (range queries) or a top-k (kNN queries).
//
// Replaces: src/repro/kernels/lmi_filter/kernel.py,
//   lmi_filter_topk_desc_pallas  (kernel.py:691) -> lmi_filter_topk_desc
//   lmi_filter_range_desc_pallas (kernel.py:650) -> lmi_filter_range_desc
// for float32 and bfloat16 stores with float32 compute. The quantized
// tiers and the row / segment gather variants are not ported here.
//
// Operands (built by repro_torch/kernels/lmi_filter/ops.py from the
// search's BucketRuns, as ops._run_descriptors does for the TPU):
//   q (Q, d) f32; store (M, d) f32 or bf16 (raw uint16 bits); valid (Q, C) u8;
//   nrun (Q,) and dstart / doff / dlen (Q, K) int32 — run r of query q
//   covers candidate slots doff..doff+dlen-1 with CSR rows dstart..; runs
//   are compacted in slot order, so doff is ascending.
//
// Contract, as the TPU kernel (kernel.py:251-271, :454-466):
//   euclidean  sqrt(max(cn + qn - 2 qc, 0));  sq_euclidean max(cn + qn - 2 qc, 0)
//   cosine     1 - qc / sqrt(max(cn * qn, 1e-24))
//   invalid or uncovered slots 3.4e38; top-k ascending with ties to the
//   lowest slot (a lexicographic (dist, slot) order, equal to a stable
//   sort), exhausted entries 3.4e38 / -1.
//
// What bounds it on the H100: bytes. A 512-query batch of the paper's
// index gathers ~512 x 5.3k candidate rows of 45 x 2 B (bf16), ~0.25 GB
// if no row were read twice; the ~4 operations per gathered element are
// far below the card's float32 rate. But the whole bf16 store is 46.7 MB,
// about the 50 MB L2, and a batch touches far fewer distinct rows than it
// gathers, so the least DRAM traffic is the distinct rows read once
// (chip_smoke.py computes that bound from the run's own descriptors).
// Design: one block per query; the query's slots go through shared
// memory in tiles of up to 256 slots. A cursor walks the query's runs in
// slot order; per tile each thread expands one run into the slot -> row
// map (the runs reaching a tile are at most tile + 1), then the block
// copies the tile's rows cooperatively: consecutive threads read
// consecutive words of a bucket run, so the loads coalesce, each thread
// keeps 8 loads in flight, and bf16 widens with a 16-bit shift. Rows sit
// in shared memory at an odd stride, so the per-slot dot products are
// free of bank conflicts. The top-k keeps a
// sorted list of k (dist, slot) pairs in shared memory; a tile's slots
// that beat the current k-th are appended and merged by rank counting,
// which makes the result independent of the order the threads append.
// TMA bulk copies per run and several queries per block are later work.
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

__device__ __forceinline__ float load_elem(const float* s, size_t i) { return __ldg(s + i); }

__device__ __forceinline__ float load_elem(const uint16_t* s, size_t i) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(s + i)) << 16);  // bf16 -> f32, exact
}

struct QueryRuns {
  const int* dstart;
  const int* doff;
  const int* dlen;
  int nrun;
  int ncov;  // slots 0..ncov-1 are covered by some run
};

__device__ __forceinline__ QueryRuns query_runs(const int* nrun, const int* dstart,
                                                const int* doff, const int* dlen, int K,
                                                int C, int qi) {
  QueryRuns r;
  r.dstart = dstart + (size_t)qi * K;
  r.doff = doff + (size_t)qi * K;
  r.dlen = dlen + (size_t)qi * K;
  r.nrun = min(__ldg(nrun + qi), K);
  r.ncov = r.nrun > 0 ? min(__ldg(r.doff + r.nrun - 1) + __ldg(r.dlen + r.nrun - 1), C) : 0;
  return r;
}

__device__ __forceinline__ float finish(float qc, float cn, float qn, int metric) {
  if (metric == 2) return 1.f - qc / sqrtf(fmaxf(cn * qn, kEps2));
  const float d2 = fmaxf(cn + qn - 2.f * qc, 0.f);
  return metric == 0 ? sqrtf(d2) : d2;
}

struct Smem {
  float* q;     // d
  int* row;     // tile
  float* cand;  // tile * stride
  int* cursor;  // first run that can reach the current tile
  int* next;    // the last run that starts before the current tile's end
};

__device__ __forceinline__ Smem carve(float* base, int* cursor, int d, int tile, int stride) {
  Smem s;
  s.q = base;
  s.row = reinterpret_cast<int*>(base + d);
  s.cand = reinterpret_cast<float*>(s.row + tile);
  s.cursor = cursor;
  s.next = cursor + 1;
  if (threadIdx.x == 0) cursor[0] = cursor[1] = 0;  // load_query synchronises
  return s;
}

__device__ __forceinline__ float load_query(const float* q, int qi, int d, float* q_s) {
  for (int j = threadIdx.x; j < d; j += blockDim.x) q_s[j] = q[(size_t)qi * d + j];
  __syncthreads();
  float qn = 0.f;
  for (int j = 0; j < d; ++j) qn = fmaf(q_s[j], q_s[j], qn);
  return qn;
}

// Gather the tile of slots t0..t0+tile-1 into shared memory and return the
// distance of this thread's slot (kBig when invalid, uncovered or idle).
// Every thread of the block calls it: it synchronises.
template <typename T>
__device__ float tile_distance(const T* __restrict__ store, const uint8_t* __restrict__ valid_q,
                               const QueryRuns& runs, const Smem& sm, float qn, int d,
                               int stride, int C, int t0, int tile, int metric) {
  const int t = threadIdx.x;
  const int s = t0 + t;
  const int end = min(t0 + tile, runs.ncov);
  __syncthreads();  // readers of the previous tile are done
  if (t < tile) sm.row[t] = -1;
  __syncthreads();
  // Runs are in slot order and each covers >= 1 slot, so the runs that
  // reach this tile are cursor .. cursor + tile: each thread maps the
  // slots of one run (independent loads, no search).
  const int first = *sm.cursor;
  for (int r = first + t; r < runs.nrun && r <= first + tile; r += blockDim.x) {
    const int o = __ldg(runs.doff + r);
    if (o >= end) continue;
    const int st = __ldg(runs.dstart + r);
    const int hi = min(o + __ldg(runs.dlen + r), end);
    for (int sl = max(o, t0); sl < hi; ++sl) sm.row[sl - t0] = st + (sl - o);
    atomicMax(sm.next, r);
  }
  __syncthreads();
  if (t == 0) *sm.cursor = *sm.next;  // read again only after the next tile's first sync
  // kUnroll independent loads in flight per thread before any is stored:
  // one load at a time would leave the gather waiting on memory latency
  const int n_el = tile * d;
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
      if (e < n_el) sm.cand[sl * stride + (e - sl * d)] = v[u];
    }
  }
  __syncthreads();
  if (t >= tile || s >= C || sm.row[t] < 0 || !valid_q[s]) return kBig;
  const float* c = sm.cand + t * stride;
  float qc = 0.f, cn = 0.f;
  for (int j = 0; j < d; ++j) {
    const float v = c[j];
    qc = fmaf(v, sm.q[j], qc);
    cn = fmaf(v, v, cn);
  }
  return finish(qc, cn, qn, metric);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
range_desc_kernel(const float* __restrict__ q, const T* __restrict__ store,
                  const uint8_t* __restrict__ valid, const int* __restrict__ nrun,
                  const int* __restrict__ dstart, const int* __restrict__ doff,
                  const int* __restrict__ dlen, int C, int K, int d, int stride, int tile,
                  int metric, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ int cursor[2];
  const int qi = blockIdx.x;
  const Smem sm = carve(smem, cursor, d, tile, stride);
  const QueryRuns runs = query_runs(nrun, dstart, doff, dlen, K, C, qi);
  const float qn = load_query(q, qi, d, sm.q);
  const uint8_t* valid_q = valid + (size_t)qi * C;
  float* out_q = out + (size_t)qi * C;
  int t0 = 0;
  for (; t0 < runs.ncov; t0 += tile) {
    const float dist = tile_distance(store, valid_q, runs, sm, qn, d, stride, C, t0, tile, metric);
    const int s = t0 + threadIdx.x;
    if (threadIdx.x < tile && s < C) out_q[s] = dist;
  }
  for (int s = t0 + threadIdx.x; s < C; s += blockDim.x) out_q[s] = kBig;
}

__device__ __forceinline__ bool before(float da, int sa, float db, int sb) {
  return da < db || (da == db && sa < sb);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_desc_kernel(const float* __restrict__ q, const T* __restrict__ store,
                 const uint8_t* __restrict__ valid, const int* __restrict__ nrun,
                 const int* __restrict__ dstart, const int* __restrict__ doff,
                 const int* __restrict__ dlen, int C, int K, int d, int stride, int tile,
                 int metric, int k, float* __restrict__ out_d, int* __restrict__ out_s) {
  extern __shared__ float smem[];
  __shared__ int n_new;
  __shared__ int cursor[2];
  const int qi = blockIdx.x;
  const int t = threadIdx.x;
  const Smem sm = carve(smem, cursor, d, tile, stride);
  float* top_d = sm.cand + tile * stride;  // k, ascending (dist, slot)
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
  const QueryRuns runs = query_runs(nrun, dstart, doff, dlen, K, C, qi);
  const float qn = load_query(q, qi, d, sm.q);  // synchronises
  const uint8_t* valid_q = valid + (size_t)qi * C;

  for (int t0 = 0; t0 < runs.ncov; t0 += tile) {
    const float dist = tile_distance(store, valid_q, runs, sm, qn, d, stride, C, t0, tile, metric);
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
    out_d[(size_t)qi * k + i] = di;
    out_s[(size_t)qi * k + i] = di < kBig ? top_s[i] : -1;
  }
}

struct Plan {
  int stride;
  int tile;
  size_t smem;
};

// Tile width and shared-memory bytes for a row width d (and top-k size k).
Plan plan(int d, int k) {
  Plan p;
  p.stride = d | 1;  // odd: conflict-free per-slot row reads
  p.tile = kMaxTile;
  const size_t fixed = (size_t)d * 4 + (size_t)k * 16;
  while (p.tile > 32 &&
         fixed + (size_t)p.tile * (4 + 4 * p.stride + (k > 0 ? 8 : 0)) > 96 * 1024)
    p.tile -= 32;
  p.smem = fixed + (size_t)p.tile * (4 + 4 * p.stride + (k > 0 ? 8 : 0));
  return p;
}

template <typename T>
int launch_range(const float* q, const void* store, const uint8_t* valid, const int* nrun,
                 const int* dstart, const int* doff, const int* dlen, int Q, int C, int K,
                 int d, int metric, float* out, cudaStream_t stream) {
  const Plan p = plan(d, 0);
  if (p.smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kern = range_desc_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  kern<<<Q, kThreads, p.smem, stream>>>(q, static_cast<const T*>(store), valid, nrun, dstart,
                                         doff, dlen, C, K, d, p.stride, p.tile, metric, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_topk(const float* q, const void* store, const uint8_t* valid, const int* nrun,
                const int* dstart, const int* doff, const int* dlen, int Q, int C, int K, int d,
                int metric, int k, float* out_d, int* out_s, cudaStream_t stream) {
  const Plan p = plan(d, k);
  if (p.smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kern = topk_desc_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  kern<<<Q, kThreads, p.smem, stream>>>(q, static_cast<const T*>(store), valid, nrun, dstart,
                                         doff, dlen, C, K, d, p.stride, p.tile, metric, k,
                                         out_d, out_s);
  return (int)cudaGetLastError();
}

}  // namespace

// metric: 0 euclidean, 1 sq_euclidean, 2 cosine. store_bf16: 0 float32 rows, 1 bfloat16 rows.
extern "C" int lmi_filter_range_desc(const float* q, const void* store, int store_bf16,
                                     const uint8_t* valid, const int* nrun, const int* dstart,
                                     const int* doff, const int* dlen, int Q, int C, int K,
                                     int d, int metric, float* out, cudaStream_t stream) {
  if (Q == 0 || C == 0) return 0;
  return store_bf16
      ? launch_range<uint16_t>(q, store, valid, nrun, dstart, doff, dlen, Q, C, K, d, metric,
                               out, stream)
      : launch_range<float>(q, store, valid, nrun, dstart, doff, dlen, Q, C, K, d, metric, out,
                            stream);
}

extern "C" int lmi_filter_topk_desc(const float* q, const void* store, int store_bf16,
                                    const uint8_t* valid, const int* nrun, const int* dstart,
                                    const int* doff, const int* dlen, int Q, int C, int K,
                                    int d, int metric, int k, float* out_d, int* out_s,
                                    cudaStream_t stream) {
  if (Q == 0 || k == 0) return 0;
  return store_bf16
      ? launch_topk<uint16_t>(q, store, valid, nrun, dstart, doff, dlen, Q, C, K, d, metric, k,
                              out_d, out_s, stream)
      : launch_topk<float>(q, store, valid, nrun, dstart, doff, dlen, Q, C, K, d, metric, k,
                           out_d, out_s, stream);
}
