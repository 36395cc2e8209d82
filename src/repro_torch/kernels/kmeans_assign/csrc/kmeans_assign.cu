// Fused K-Means assignment for Hopper (sm_90a): for every point, the index
// and the value of the smallest squared L2 distance to k centroids.
//
// Replaces: src/repro/kernels/kmeans_assign/kernel.py, kmeans_assign_pallas
// (the Pallas TPU kernel behind repro.core.kmeans.assign(use_kernel=True)).
// In the port it also carries every Lloyd assignment of the index build
// (repro_torch.core.kmeans._lloyd_step_many), batched over the groups of a
// level's fit_many: x (G, n, d), centroids (G, k, d) -> labels (G, n) int32,
// min_d2 (G, n) float32.
//
// Contract, as the TPU kernel: d2 = max(|x|^2 + |c|^2 - 2 x.c, 0) in float32,
// argmin ties go to the lowest centroid index (jnp.argmin). Any k is taken,
// and d <= 1024.
//
// What bounds it on the H100: the root fit of the paper's index is
// 518,576 x 256 x 45 multiply-adds per Lloyd step, 11.95 GFLOP against
// 97.5 MB of points (93.3 MB), centroids and outputs. On the tensor cores
// as 3xTF32 that is 3 x 11.95 GFLOP at 495 TFLOP/s = 0.0724 ms, above the
// bytes' 0.0291 ms: bound by operations (on float32 CUDA cores 0.1783 ms).
// Level 1 of the build, (256, cap, 45) x 64, is bound by bytes: a quarter
// of the root's work a row, on as many rows as the padded groups hold.
//
// Two variants, chosen by the wrapper's plan() (ops.py) by shape alone:
//
// 1. tensor_core, d <= 64 (every shape the build drives): x.c on wgmma in
//    TF32, split three ways to keep float32 accuracy: v = hi + lo with
//    hi = tf32(v) (cvt.rna) and lo = tf32(v - hi), and x.c = hi.lo + lo.hi +
//    hi.hi (the dropped lo.lo term is ~2^-22 of a product). Both operands
//    are K-major (point rows, centroid rows), as TF32 wgmma needs, zero-
//    padded to d_pad = 48 or 64 columns and laid out in wgmma's
//    32-byte swizzle (8-column blocks of 32-byte rows; 16-byte chunk c of
//    row r at c ^ (r / 4) % 2), which keeps the split stores free of bank
//    conflicts. A block is two warpgroups; each owns 64-row point tiles
//    in two stages of shared memory. The block keeps its group's
//    centroids resident (hi, lo and |c|^2, k padded to whole chunks of
//    N = 64 or 256 centroids, one wgmma m64nNk8 width), and walks,
//    persistent, a contiguous range of 128-row (group, tile) pairs,
//    reloading the centroids when the group changes. Point rows are d * 4
//    bytes apart (180 at d = 45, no 16-byte multiple), so neither TMA nor
//    16-byte cp.async takes them whole, and the split passes through
//    registers anyway: each thread loads the next tile's values of the two
//    rows its accumulator fragment holds (columns t4, t4 + 4, ...; |x|^2 of
//    those rows is a quad shuffle-sum of them, in a fixed order) and
//    stores their hi / lo while this tile's wgmmas run. The epilogue, on
//    the CUDA cores: d2 from |x|^2 + |c|^2 - 2 x.c per fragment element,
//    each thread's argmin over its columns in ascending order with a
//    strict <, the quad's four reduced by shuffle on (d2, index) in
//    lexicographic order; chunks go in ascending order with a strict <.
//    Columns past k are masked there.
// 2. cuda_core, d > 64 (and a k whose centroids do not fit shared memory
//    beside the point tiles): the first port's design. One thread per
//    point holds its point in registers (DMAX-wide, unrolled); a chunk of
//    centroids and their norms sits in shared memory and every thread of
//    the block reads the same centroid word at the same time (a
//    broadcast). One FMA per shared load on float32 CUDA cores.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

// ------------------------------------------------------- cuda_core (2.)

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

// ----------------------------------------------------- tensor_core (1.)

constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kWgRows = 64;      // point rows of a warpgroup's tile (wgmma's M)
constexpr int kBlockRows = 2 * kWgRows;
constexpr int kSmemMax = 232448;  // the opt-in limit of a block's shared memory

// bytes of dynamic shared memory: centroid hi / lo (kc rows of d_pad) and
// |c|^2, two stages of hi / lo point tiles for each warpgroup, and 1 KB to
// align the tiles to the swizzle atom (plan() in ops.py mirrors this)
__host__ __device__ constexpr int tc_smem_bytes(int kc, int d_pad) {
  return 1024 + 8 * kc * d_pad + 4 * kc + 2 * 2 * 2 * kWgRows * d_pad * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// v rounded to TF32 (to nearest, ties away), as float32 bits with the low
// 13 mantissa bits zero
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// byte offset of element (r, col) in a K-major tile of ROWS rows in the
// 32-byte swizzle: column block col / 8 of ROWS x 32 bytes, row r at 32 r,
// 16-byte chunk (col / 4) % 2 at chunk ^ (r / 4) % 2 (the swizzle's XOR of
// address bit 4 with bit 7; every block starts on a 256-byte atom)
__device__ __forceinline__ uint32_t swz32(int rows, int r, int col) {
  return static_cast<uint32_t>((col >> 3) * (rows * 32) + r * 32 +
                               ((((col >> 2) & 1) ^ ((r >> 2) & 1)) << 4) + (col & 3) * 4);
}

// shared-memory matrix descriptor, 32-byte swizzle, K-major: start address
// and the stride between 8-row atoms (SBO), in 16-byte units; the leading
// offset is unused for a swizzled K-major operand whose k step (8 TF32 =
// 32 bytes) is one atom wide
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(256 >> 4) << 32) |
         (3ull << 62);
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
// what st.shared wrote (the generic proxy) is visible to wgmma (the async proxy)
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
// the 128 threads of one warpgroup (barrier 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// d (64 x N a warpgroup, as m16n8 C fragments a warp) = A (64 x 8) . B (8 x N)
// (accumulate = 0) or d + A . B (accumulate = 1), TF32 in, float32
// accumulate; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32][4], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p, 1, 1;\n}\n"
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
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// one warpgroup's two point rows a thread: this thread's columns t4, t4 + 4,
// ... of rows row0 + 16 warp + g and + 8 of its group's points (zero past
// n and d)
template <int NQ>
__device__ __forceinline__ void load_rows(float (&v)[2][NQ], const float* __restrict__ xg,
                                          int n, int d, int row0, int warp, int g, int t4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * warp + g + 8 * h;
    const float* p = xg + (size_t)(row < n ? row : 0) * d;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int col = 4 * i + t4;
      v[h][i] = (row < n && col < d) ? __ldg(p + col) : 0.f;
    }
  }
}

// split the values into the hi / lo tiles of a stage; xn = |x|^2 of the
// two rows, the quad's partial sums added in a fixed order
template <int NQ>
__device__ __forceinline__ void store_rows(const float (&v)[2][NQ], uint32_t hi, uint32_t lo,
                                           int warp, int g, int t4, float (&xn)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float x = v[h][i];
      part = fmaf(x, x, part);
      const uint32_t xh = to_tf32(x);
      const uint32_t xl = to_tf32(x - __uint_as_float(xh));
      const uint32_t off = swz32(kWgRows, r, 4 * i + t4);
      st_shared(hi + off, xh);
      st_shared(lo + off, xl);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    xn[h] = part + __shfl_xor_sync(0xffffffffu, part, 2);
  }
}

// the running (best, arg) of this thread's two rows over one chunk's
// columns j0 + 8 j + 2 t4 + (e & 1), ascending; columns >= k skipped when MASK
template <int N, bool MASK>
__device__ __forceinline__ void argmin_chunk(const float (&acc)[N / 8][4],
                                             const float* __restrict__ cn, int j0, int k,
                                             int t4, const float (&xn)[2], float (&best)[2],
                                             int (&arg)[2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = j0 + 8 * j + 2 * t4;
    const float2 cc = *reinterpret_cast<const float2*>(cn + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, idx = col + (e & 1);
      const float d2 = fmaxf(fmaf(-2.f, acc[j][e], xn[h] + ((e & 1) ? cc.y : cc.x)), 0.f);
      if ((!MASK || idx < k) && d2 < best[h]) {  // strict: ties keep the lower index
        best[h] = d2;
        arg[h] = idx;
      }
    }
  }
}

template <int N, int KD>
__global__ void __launch_bounds__(kTcThreads, 1)
kmeans_assign_tc(const float* __restrict__ x, const float* __restrict__ c, int n, int k,
                 int d, int kc, int tiles_per_group, long long n_tiles,
                 int32_t* __restrict__ labels, float* __restrict__ mind) {
  constexpr int NQ = 2 * KD;                    // column quads of a row (d_pad / 4)
  constexpr int kDPad = 8 * KD;
  constexpr int kTile = KD * kWgRows * 32;      // bytes of one hi or lo point tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t c_hi = base, c_lo = base + kc * 32 * KD;
  const uint32_t pts = base + 2 * kc * 32 * KD;  // [warpgroup][stage][hi, lo]
  float* cn = reinterpret_cast<float*>(smem_raw + (base - raw) + 2 * kc * 32 * KD + 8 * kTile);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t my = pts + wg * 4 * kTile;  // stage s: hi at my + 2 s kTile, lo kTile on

  float acc[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // this block's contiguous range of (group, 128-row tile) pairs, group-major
  const long long t_end = n_tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long t = n_tiles * blockIdx.x / gridDim.x; t < t_end;) {
    const int grp = (int)(t / tiles_per_group);
    const long long seg_end = min(t_end, (long long)(grp + 1) * tiles_per_group);
    const float* xg = x + (size_t)grp * n * d;
    const float* cg = c + (size_t)grp * k * d;

    __syncthreads();  // every warpgroup is done with the last group's centroids
    for (int e = tid; e < kc * kDPad; e += kTcThreads) {
      const int j = e / kDPad, col = e % kDPad;
      const float v = (j < k && col < d) ? __ldg(cg + (size_t)j * d + col) : 0.f;
      const uint32_t vh = to_tf32(v), vl = to_tf32(v - __uint_as_float(vh));
      const uint32_t off = swz32(kc, j, col);
      st_shared(c_hi + off, vh);
      st_shared(c_lo + off, vl);
    }
    for (int j = tid; j < kc; j += kTcThreads) {
      float s = 0.f;
      if (j < k)
        for (int i = 0; i < d; ++i) s = fmaf(cg[(size_t)j * d + i], cg[(size_t)j * d + i], s);
      cn[j] = s;
    }
    fence_async_smem();
    __syncthreads();

    // this warpgroup's rows of the segment's tiles: 64 rows a tile
    const int row_first = (int)(t - (long long)grp * tiles_per_group) * kBlockRows + wg * kWgRows;
    const int nt = (int)(seg_end - t);
    float v[2][NQ], xn[2], xn_next[2] = {0.f, 0.f};
    load_rows<NQ>(v, xg, n, d, row_first, warp, g, t4);
    store_rows<NQ>(v, my, my + kTile, warp, g, t4, xn);
    fence_async_smem();
    wg_sync(wg);
    for (int j = 0; j < nt; ++j) {
      const int s = j & 1;
      const int row0 = row_first + j * kBlockRows;
      const uint32_t a_hi = my + s * 2 * kTile, a_lo = a_hi + kTile;
      float best[2] = {FLT_MAX, FLT_MAX};
      int arg[2] = {0, 0};
      for (int j0 = 0; j0 < kc; j0 += N) {
        wgmma_fence();
        // the small terms first, then hi.hi
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const uint32_t ao = kk * kWgRows * 32, bo = kk * kc * 32 + j0 * 32;
          wgmma_tf32(acc, desc_sw32(a_hi + ao), desc_sw32(c_lo + bo), kk > 0);
          wgmma_tf32(acc, desc_sw32(a_lo + ao), desc_sw32(c_hi + bo), 1);
        }
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const uint32_t ao = kk * kWgRows * 32, bo = kk * kc * 32 + j0 * 32;
          wgmma_tf32(acc, desc_sw32(a_hi + ao), desc_sw32(c_hi + bo), 1);
        }
        wgmma_commit();
        if (j0 == 0 && j + 1 < nt) {  // the next tile, while these products run
          load_rows<NQ>(v, xg, n, d, row0 + kBlockRows, warp, g, t4);
          const uint32_t n_hi = my + (s ^ 1) * 2 * kTile;
          store_rows<NQ>(v, n_hi, n_hi + kTile, warp, g, t4, xn_next);
        }
        wgmma_wait_all();
        reg_fence(acc);
        if (j0 + N <= k)
          argmin_chunk<N, false>(acc, cn, j0, k, t4, xn, best, arg);
        else
          argmin_chunk<N, true>(acc, cn, j0, k, t4, xn, best, arg);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {  // the quad, (d2, index) lexicographic
          const float ob = __shfl_xor_sync(0xffffffffu, best[h], off);
          const int oa = __shfl_xor_sync(0xffffffffu, arg[h], off);
          if (ob < best[h] || (ob == best[h] && oa < arg[h])) {
            best[h] = ob;
            arg[h] = oa;
          }
        }
        const int row = row0 + 16 * warp + g + 8 * h;
        if (t4 == 0 && row < n) {
          labels[(size_t)grp * n + row] = arg[h];
          mind[(size_t)grp * n + row] = best[h];
        }
      }
      xn[0] = xn_next[0];
      xn[1] = xn_next[1];
      fence_async_smem();  // the next stage's stores are visible to wgmma
      wg_sync(wg);         // and every warp of the warpgroup is done with this stage
    }
    t = seg_end;
  }
}

template <int N, int KD>
int launch_tc(const float* x, const float* c, int groups, int n, int k, int d, int kc,
              int blocks, int32_t* labels, float* mind, cudaStream_t stream) {
  const int smem = tc_smem_bytes(kc, 8 * KD);
  cudaError_t err = cudaFuncSetAttribute(kmeans_assign_tc<N, KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_group = (n + kBlockRows - 1) / kBlockRows;
  const long long n_tiles = (long long)groups * tiles_per_group;
  if (blocks > n_tiles) blocks = (int)n_tiles;
  kmeans_assign_tc<N, KD><<<blocks, kTcThreads, smem, stream>>>(
      x, c, n, k, d, kc, tiles_per_group, n_tiles, labels, mind);
  return (int)cudaGetLastError();
}

template <int N>
int launch_tc_n(const float* x, const float* c, int groups, int n, int k, int d, int kc,
                int d_pad, int blocks, int32_t* labels, float* mind, cudaStream_t stream) {
  switch (d_pad) {
    case 48: return launch_tc<N, 6>(x, c, groups, n, k, d, kc, blocks, labels, mind, stream);
    case 64: return launch_tc<N, 8>(x, c, groups, n, k, d, kc, blocks, labels, mind, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (groups, n, d), c (groups, k, d) float32, contiguous; labels/mind (groups, n).
// variant 0: cuda_core; 1: tensor_core with `chunk` centroids a wgmma (64
// or 256), rows zero-padded to d_pad columns (48 or 64, >= d),
// at most `blocks` persistent blocks. The wrapper's plan() picks them.
extern "C" int kmeans_assign_f32(const float* x, const float* c, int groups, int n, int k,
                                 int d, int variant, int chunk, int d_pad, int blocks,
                                 int32_t* labels, float* mind, cudaStream_t stream) {
  if (groups == 0 || n == 0) return 0;
  if (k < 1 || d < 1 || d > 1024) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (d > d_pad || blocks < 1) return (int)cudaErrorInvalidValue;
    const int kc = (k + chunk - 1) / chunk * chunk;
    if (tc_smem_bytes(kc, d_pad) > kSmemMax) return (int)cudaErrorInvalidValue;
    switch (chunk) {
      case 64:
        return launch_tc_n<64>(x, c, groups, n, k, d, kc, d_pad, blocks, labels, mind, stream);
      case 256:
        return launch_tc_n<256>(x, c, groups, n, k, d, kc, d_pad, blocks, labels, mind, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (variant != 0 || groups > 65535) return (int)cudaErrorInvalidValue;
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
