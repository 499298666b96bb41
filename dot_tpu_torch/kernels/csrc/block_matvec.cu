// K7's solve entry: a whole block solve in ONE cooperative launch. Its
// products are out = op(A) v, or out = c - op(A) v, over a batch of square
// blocks, op in {A, A^T}. A is stored in bf16, f32 or f64 and taken to the
// solve type T (f32 or f64) in registers; v, c and out are T and the sums
// are taken in T.
//
// Replaces the block mat-vecs of dot_tpu/steppers/core.py:1061-1135
// (_cr_solve: Li r_odd, G_lo^T z, G_hi^T z, G_lo x, G_hi x, Li^T t),
// 1219-1261 (_btd_solve: Linv_k (r_k - S_{k-1} y), Linv_k^T (y - S_k^T z)),
// 1296-1317 (_coarse_apply: Lc^{-T} (Lc^{-1} r)) and, with K = 3
// right-hand sides, 1704-1719 (pd_solve: the permutation, the k-column
// einsums of _btd_solve, the inverse permutation).
//
// One entry, dot_block_solve. The host builds the solve once per factor as
// a table of stages (kernels/band.py SolveProgram): each stage is one batch
// of the products above (or a copy, a gather or a scatter), with its A
// (address, batch strides) and the offsets and strides of v, c and out in
// the call's input r, output z and workspace. The kernel walks the stages
// in order, a grid barrier before each stage that reads what an earlier
// one wrote, and each stage's (block, 32-row or 32-column group) items
// grid-stride. The transposes, stacks and interleaves of the host loop it
// replaces are addressing in the table; per solve there is one host call
// and no host read. A refused cooperative launch (too few co-resident
// blocks, no cooperative launch on the device) is an error: there is no
// fallback. The plain version is kernels/band.py block_solve_ref, which
// walks the same table with plain PyTorch products.
//
// Bound on the H100: memory. Each element of A is read once and used for
// one multiply-add: at bar17 one H0 apply reads the bf16 factor twice,
// ~0.48 GB, ~0.15 ms at 3.35 TB/s. The solve adds a grid barrier between
// dependent stages (4 nb - 2 of them for a scan of nb blocks), ~3 us each
// on an H100 SXM at 700 W (tools/torch_solve_bench.py), where a launch a
// stage paid a host launch (20-34 us) and a gap on the device: on small
// stages (bar17's root, P = 1 scans, the coarse pair) the one launch was
// 2-4x faster. On bar135's stages of 133 blocks it streamed ~1.07x slower
// than a launch a stage (neither the grid size nor 5 blocks an SM moved
// that). The inverse factors' stages read their lower triangle only (the
// same bits on finite inputs: kLower); each item asks its A lines into L2
// before its loads.
//
// Design: both directions read A coalesced along its rows, and every
// product sums in the same order wherever it runs (rows_item, cols_item):
//  - op = A: one warp per output row (4 rows a warp, side by side); the
//    lanes stride the row and a fixed xor-shuffle tree sums the lanes
//    (deterministic).
//  - op = A^T: one block per 32 output columns; lane = column, each of the
//    8 warps walks every 8th row, so a warp reads 32 consecutive entries of
//    a row; the 8 partial sums are added in shared memory in a fixed order.
// Several strides of loads are issued before their products (the sums keep
// their order): a stage of bf16 blocks is bound by the loads in flight.
// So a solve's result does not depend on the grid or on which block takes
// an item: two calls agree bit for bit. v and c are read past L1
// (ld.global.cg): they may have been written by another block earlier in
// the launch. `out` may be `c` (each entry is read and written by the same
// thread); it must not overlap v. The blocks of A lie the stage's batch
// strides apart, so one subdomain's blocks of a scan-major (m, P, n, n)
// factor leaf are read in place (the GSDD sweep).
//
// K15, pd_solve in ONE launch (the program's kind "pd", K = 3 columns):
// its stages are the gather (rows permuted by inv, zero-padded, / d), the
// scan's 4 nb - 2 K-column products and the scatter (/ d, un-permuted).
// rows_item_k / cols_item_k read each entry of A once and feed K
// accumulators, each column summed in the K = 1 order of its direction
// (lane strides, shuffle tree, the 8 warps' partials in order). Bound:
// latency. At P = 1 and n = 512 a stage is one 1 MiB block (f32), so the
// op = A stages take one row a warp (64 items, not 16: a row's sum does
// not depend on where it runs); the op = A^T stages keep the 32-column
// items (their 8 partial sums fix the order), 16 at n = 512. The ~130 grid
// barriers (~3 us each) are the design's floor.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace dotk7 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;

template <typename T>
__device__ __forceinline__ T up(__nv_bfloat16 x) {
  return T(__bfloat162float(x));
}
template <typename T>
__device__ __forceinline__ T up(float x) {
  return T(x);
}
template <typename T>
__device__ __forceinline__ T up(double x) {
  return T(x);
}

// a 128 B line of A asked into L2 ahead of its loads (no register held)
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// v's and c's entries: past L1 (kCg, as the solve reads them: another
// block may have written them earlier in the launch), plain loads otherwise
template <bool kCg, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kCg) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// op = A on one block: rows [32 group, 32 group + 32), kRowsPerWarp rows
// a warp; each row's lanes stride it by 32 (lane l sums j = l, l + 32, ...
// in that order) and a fixed xor-shuffle tree sums the lanes. The warp's
// rows run side by side and kStrides strides of loads are issued before
// their products: the sums are the same, more loads are in flight.
template <bool kCg, typename TA, typename T>
__device__ __forceinline__ void rows_item(const TA* __restrict__ a,
                                          const T* v, const T* c, T* out,
                                          int n, int group,
                                          bool lower = false) {
  constexpr int kStrides = 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (group * kWarps + warp) * kRowsPerWarp;
  if (row0 >= n) return;
  // a lower-triangular A: the warp's rows end at column row0 + 3
  const int jend = lower && row0 + kRowsPerWarp < n ? row0 + kRowsPerWarp
                                                   : n;
  const TA* ar[kRowsPerWarp];
  T acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    ar[q] = a + static_cast<int64_t>(row0 + q < n ? row0 + q : row0) * n;
    acc[q] = T(0);
  }
  if constexpr (kCg) {        // the solve: the warp's rows into L2 at once
    const int lines = (jend * static_cast<int>(sizeof(TA)) + 127) / 128;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q)
      for (int l = lane; l < lines; l += 32)
        prefetch_l2(reinterpret_cast<const char*>(ar[q]) + 128 * l);
  }
  int j = lane;
  for (; j + 32 * (kStrides - 1) < jend; j += 32 * kStrides) {
    T x[kRowsPerWarp][kStrides], vj[kStrides];
#pragma unroll
    for (int u = 0; u < kStrides; ++u) vj[u] = ld<kCg>(v + j + 32 * u);
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
      for (int u = 0; u < kStrides; ++u) x[q][u] = up<T>(ar[q][j + 32 * u]);
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
      for (int u = 0; u < kStrides; ++u) acc[q] += x[q][u] * vj[u];
  }
  for (; j < jend; j += 32) {
    const T vv = ld<kCg>(v + j);
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) acc[q] += up<T>(ar[q][j]) * vv;
  }
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int row = row0 + q;
      if (row < n) out[row] = c != nullptr ? ld<kCg>(c + row) - acc[q]
                                           : acc[q];
    }
  }
}

// op = A^T on one block: columns [32 group, 32 group + 32), lane = column,
// warp w summing rows w, w + 8, ... in that order, kStrides rows' loads
// issued before their products; the 8 partials added in order. A block
// barrier before warp 0's sums: `part` may be written again after the
// next block barrier (the solve alternates two of them).
template <bool kCg, typename TA, typename T>
__device__ __forceinline__ void cols_item(const TA* __restrict__ a,
                                          const T* v, const T* c, T* out,
                                          int n, int group, T (*part)[33],
                                          bool lower = false) {
  constexpr int kStrides = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = group * 32 + lane;
  // a lower-triangular A: the group's columns start at row 32 group (the
  // warp's first row there, in its stride of 8)
  const int i0 = lower && 32 * group > warp
                     ? warp + (32 * group - warp + kWarps - 1) / kWarps * kWarps
                     : warp;
  T acc = T(0);
  if constexpr (kCg) {        // the solve: the warp's row pieces into L2
    for (int i = i0 + kWarps * lane; i < n; i += kWarps * 32)
      prefetch_l2(a + static_cast<int64_t>(i) * n + group * 32);
  }
  if (col < n) {
    int i = i0;
    for (; i + kWarps * (kStrides - 1) < n; i += kWarps * kStrides) {
      T x[kStrides], vi[kStrides];
#pragma unroll
      for (int u = 0; u < kStrides; ++u) {
        x[u] = up<T>(a[static_cast<int64_t>(i + kWarps * u) * n + col]);
        vi[u] = ld<kCg>(v + i + kWarps * u);
      }
#pragma unroll
      for (int u = 0; u < kStrides; ++u) acc += x[u] * vi[u];
    }
    for (; i < n; i += kWarps)
      acc += up<T>(a[static_cast<int64_t>(i) * n + col]) * ld<kCg>(v + i);
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < n) {
    T s = part[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][lane];
    out[col] = c != nullptr ? ld<kCg>(c + col) - s : s;
  }
}

// ---- the solve program ------------------------------------------------------
// A stage: kFields int64 (kernels/band.py: the same field order). kA is
// A's address; its block (j, p) starts kAOff + j kASj + p kASp entries
// further. v, c and out name a buffer (0 the input r, 1 the output z, 2 the
// workspace; c: -1 for none) and its block (j, p) at off + j sj + p sp
// (entries; a block of a K-column program is n K of them, (n, K)
// row-major). The stage's batch is kNj x kNp blocks; kOp: 0 op = A, 1
// op = A^T, 2 a copy of v to out (no A), 3 a gather and 4 a scatter (kNj
// rows of K entries, kA their int64 row table, kD the scale d); kSync: a
// grid barrier before the stage; kLower: A is lower triangular (an
// inverse Cholesky factor, whose entries above the diagonal K6 writes as
// exact zeros), and the stage reads its lower part only. Its products are
// the same bits: a partial sum that starts at +0 is never -0, so the zero
// products it skips (+0 or -0 added) leave it as it is on finite v.
enum : int {
  kA, kAOff, kASj, kASp,
  kVBuf, kVOff, kVSj, kVSp,
  kCBuf, kCOff, kCSj, kCSp,
  kOBuf, kOOff, kOSj, kOSp,
  kNj, kNp, kOp, kSync, kLower, kD, kFields
};
constexpr int kOpA = 0, kOpAT = 1, kOpCopy = 2, kOpGather = 3,
              kOpScatter = 4;

// op = A with K right-hand sides on one block, in the solve: row
// kWarps group + warp, one row a warp; lane l sums j = l, l + 32, ... in
// that order for each column, a fixed xor-shuffle tree sums the lanes:
// rows_item's order, kStrides strides of loads in flight.
template <typename TA, typename T, int K>
__device__ __forceinline__ void rows_item_k(const TA* __restrict__ a,
                                            const T* v, const T* c, T* out,
                                            int n, int group, bool lower) {
  constexpr int kStrides = 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = group * kWarps + warp;
  if (row >= n) return;
  const int jend = lower ? row + 1 : n;    // a lower A: columns <= row
  const TA* ar = a + static_cast<int64_t>(row) * n;
  const int lines = (jend * static_cast<int>(sizeof(TA)) + 127) / 128;
  for (int l = lane; l < lines; l += 32)
    prefetch_l2(reinterpret_cast<const char*>(ar) + 128 * l);
  T acc[K];
#pragma unroll
  for (int q = 0; q < K; ++q) acc[q] = T(0);
  int j = lane;
  for (; j + 32 * (kStrides - 1) < jend; j += 32 * kStrides) {
    T x[kStrides], vj[kStrides][K];
#pragma unroll
    for (int u = 0; u < kStrides; ++u) {
      x[u] = up<T>(ar[j + 32 * u]);
#pragma unroll
      for (int q = 0; q < K; ++q) vj[u][q] = __ldcg(v + (j + 32 * u) * K + q);
    }
#pragma unroll
    for (int u = 0; u < kStrides; ++u)
#pragma unroll
      for (int q = 0; q < K; ++q) acc[q] += x[u] * vj[u][q];
  }
  for (; j < jend; j += 32) {
    const T x = up<T>(ar[j]);
#pragma unroll
    for (int q = 0; q < K; ++q) acc[q] += x * __ldcg(v + j * K + q);
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q)
      out[row * K + q] = c != nullptr ? __ldcg(c + row * K + q) - acc[q]
                                      : acc[q];
  }
}

// op = A^T with K right-hand sides on one block, in the solve: columns
// [32 group, 32 group + 32), lane = column, warp w summing rows w, w + 8,
// ... per column, the 8 partials added in order: cols_item's order.
// A block barrier before warp 0's sums (the solve alternates two `part`s).
template <typename TA, typename T, int K>
__device__ __forceinline__ void cols_item_k(const TA* __restrict__ a,
                                            const T* v, const T* c, T* out,
                                            int n, int group,
                                            T (*part)[kWarps][33],
                                            bool lower) {
  constexpr int kStrides = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = group * 32 + lane;
  const int i0 = lower && 32 * group > warp
                     ? warp + (32 * group - warp + kWarps - 1) / kWarps * kWarps
                     : warp;
  for (int i = i0 + kWarps * lane; i < n; i += kWarps * 32)
    prefetch_l2(a + static_cast<int64_t>(i) * n + group * 32);
  T acc[K];
#pragma unroll
  for (int q = 0; q < K; ++q) acc[q] = T(0);
  if (col < n) {
    int i = i0;
    for (; i + kWarps * (kStrides - 1) < n; i += kWarps * kStrides) {
      T x[kStrides], vi[kStrides][K];
#pragma unroll
      for (int u = 0; u < kStrides; ++u) {
        x[u] = up<T>(a[static_cast<int64_t>(i + kWarps * u) * n + col]);
#pragma unroll
        for (int q = 0; q < K; ++q)
          vi[u][q] = __ldcg(v + (i + kWarps * u) * K + q);
      }
#pragma unroll
      for (int u = 0; u < kStrides; ++u)
#pragma unroll
        for (int q = 0; q < K; ++q) acc[q] += x[u] * vi[u][q];
    }
    for (; i < n; i += kWarps) {
      const T x = up<T>(a[static_cast<int64_t>(i) * n + col]);
#pragma unroll
      for (int q = 0; q < K; ++q) acc[q] += x * __ldcg(v + i * K + q);
    }
  }
#pragma unroll
  for (int q = 0; q < K; ++q) part[q][warp][lane] = acc[q];
  __syncthreads();
  if (warp == 0 && col < n) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      T s = part[q][0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += part[q][w][lane];
      out[col * K + q] = c != nullptr ? __ldcg(c + col * K + q) - s : s;
    }
  }
}

// block (j, p) of the stage's field f (kVBuf, kCBuf or kOBuf) in its buffer
template <typename T>
__device__ __forceinline__ T* at(const T* r, T* z, T* ws,
                                 const volatile long long* sd, int f,
                                 int64_t j, int64_t p) {
  const long long buf = sd[f];
  T* base = buf == 0 ? const_cast<T*>(r) : (buf == 1 ? z : ws);
  return base + sd[f + 1] + j * sd[f + 2] + p * sd[f + 3];
}

// Walks the stages. A stage's descriptor is copied to shared memory and
// read there item by item (volatile: not held in registers across the
// item loop, which would cost the kernel its occupancy). v and c are read
// past L1 by each warp (no shared staging), so a block moves from one
// row-group item to the next without a barrier; op = A^T items alternate
// two buffers of partial sums (one barrier an item). K: the right-hand
// sides of every product (1; 3 for pd_solve, whose element-wise gather
// and scatter stages stride over the grid's threads).
template <typename TA, typename T, int K>
__global__ void __launch_bounds__(kThreads)
solve_kernel(const long long* __restrict__ prog, int n_stage, int n,
             const T* r, T* z, T* ws) {
  __shared__ T part[2][K][kWarps][33];
  __shared__ long long stage[kFields];
  const volatile long long* sd = stage;
  cg::grid_group grid = cg::this_grid();
  const int groups = (n + 31) / 32;
  // op = A items: 32 rows (4 a warp) at K = 1, 8 (a row a warp) at K > 1
  const int groups_a = K == 1 ? groups : (n + kWarps - 1) / kWarps;
  int buf = 0;
  for (int s = 0; s < n_stage; ++s) {
    const long long* st = prog + static_cast<int64_t>(s) * kFields;
    if (st[kSync]) grid.sync();
    __syncthreads();              // the last stage's readers of `stage`
    if (threadIdx.x < kFields) stage[threadIdx.x] = st[threadIdx.x];
    __syncthreads();
    const int op = static_cast<int>(sd[kOp]);
    if (op == kOpGather || op == kOpScatter) {
      const int64_t cnt = sd[kNj] * K;
      const int64_t* tab = reinterpret_cast<const int64_t*>(sd[kA]);
      const T* d = reinterpret_cast<const T*>(sd[kD]);
      const T* v = at(r, z, ws, sd, kVBuf, 0, 0);
      T* out = at(r, z, ws, sd, kOBuf, 0, 0);
      for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads
                       + threadIdx.x;
           e < cnt; e += static_cast<int64_t>(gridDim.x) * kThreads) {
        const int64_t row = e / K;
        const int q = static_cast<int>(e - row * K);
        const int64_t i = tab[row];
        if (op == kOpGather)
          out[e] = (i >= 0 ? __ldcg(v + i * K + q) : T(0)) / d[row];
        else
          out[e] = __ldcg(v + i * K + q) / d[i];
      }
      continue;
    }
    const int64_t np = sd[kNp];
    const int64_t per = op == kOpCopy ? 1 : (op == kOpA ? groups_a : groups);
    const int64_t items = sd[kNj] * np * per;
    for (int64_t g = blockIdx.x; g < items; g += gridDim.x) {
      // block b's groups rotated by b: a block's items (g, g + grid, ...)
      // fall on different groups, whose costs differ in a lower-triangular
      // stage (the last rows and the first columns read the most)
      const int64_t b = g / per;
      const int grp = static_cast<int>((g - b * per + b) % per);
      const int64_t j = b / np, p = b - j * np;
      const T* v = at(r, z, ws, sd, kVBuf, j, p);
      T* out = at(r, z, ws, sd, kOBuf, j, p);
      if (op == kOpCopy) {
        for (int e = threadIdx.x; e < n * K; e += kThreads)
          out[e] = __ldcg(v + e);
        continue;
      }
      const T* c = sd[kCBuf] < 0 ? nullptr : at(r, z, ws, sd, kCBuf, j, p);
      const TA* a = reinterpret_cast<const TA*>(sd[kA]) + sd[kAOff]
                    + j * sd[kASj] + p * sd[kASp];
      const bool lower = sd[kLower] != 0;
      if (op == kOpAT) {
        if constexpr (K == 1)
          cols_item<true, TA, T>(a, v, c, out, n, grp, part[buf][0], lower);
        else
          cols_item_k<TA, T, K>(a, v, c, out, n, grp, part[buf], lower);
        buf ^= 1;
      } else if constexpr (K == 1) {
        rows_item<true, TA, T>(a, v, c, out, n, grp, lower);
      } else {
        rows_item_k<TA, T, K>(a, v, c, out, n, grp, lower);
      }
    }
  }
}

// the solve's grid: every co-resident block (occupancy at 256 threads,
// times the SMs), at most one per item of the largest stage; `grid` > 0
// takes that many blocks instead (a grid above the co-resident limit is
// refused by the cooperative launch)
template <typename TA, typename T, int K>
int launch_solve(const long long* prog, int n_stage, int n,
                 long long max_items, const void* r, void* z, void* ws,
                 int grid, cudaStream_t s) {
  if (n_stage <= 0) return 0;
  if (n <= 0 || max_items <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = solve_kernel<TA, T, K>;
  constexpr int kMaxDev = 64;
  static int per_sm_of[kMaxDev] = {0};
  static int sms_of[kMaxDev] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDev) return -4;
  if (per_sm_of[dev] == 0) {
    int coop = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop) return -2;
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return -3;
    per_sm_of[dev] = per_sm;
  }
  const long long most = static_cast<long long>(per_sm_of[dev]) * sms_of[dev];
  const unsigned blocks = static_cast<unsigned>(
      grid > 0 ? grid : (max_items < most ? max_items : most));
  const T* rr = static_cast<const T*>(r);
  T* zz = static_cast<T*>(z);
  T* ww = static_cast<T*>(ws);
  void* args[] = {&prog, &n_stage, &n, &rr, &zz, &ww};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(blocks), dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a refused launch: not left for the next check
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk7

// A solve program in one cooperative launch: prog (n_stage, 22) int64 on
// the device (kernels/band.py SolveProgram.table), every A of one dtype
// (a_dtype: 0 f32, 1 f64, 2 bf16), blocks of width n, k right-hand sides a
// product (1 or 3); r (read), z (written) and ws (scratch) in dtype (0 f32,
// 1 f64); max_items: the
// most items a product or copy stage holds; grid: 0 for the co-resident
// blocks (at most max_items), else that many blocks (a test's way to a
// refused launch). Returns 0, a CUDA error code, -2 when the device has no
// cooperative launch, -3 when no block fits on an SM, -4 for a device
// ordinal beyond the kernel's cache.
template <int K>
int solve_k(int a_dtype, int dtype, const long long* pg, int n_stage, int n,
            long long max_items, const void* r, void* z, void* ws, int grid,
            cudaStream_t s) {
  using dotk7::launch_solve;
  if (dtype == 0) {
    if (a_dtype == 0) return launch_solve<float, float, K>(pg, n_stage, n, max_items, r, z, ws, grid, s);
    if (a_dtype == 1) return launch_solve<double, float, K>(pg, n_stage, n, max_items, r, z, ws, grid, s);
    return launch_solve<__nv_bfloat16, float, K>(pg, n_stage, n, max_items, r, z, ws, grid, s);
  }
  if (a_dtype == 0) return launch_solve<float, double, K>(pg, n_stage, n, max_items, r, z, ws, grid, s);
  if (a_dtype == 1) return launch_solve<double, double, K>(pg, n_stage, n, max_items, r, z, ws, grid, s);
  return launch_solve<__nv_bfloat16, double, K>(pg, n_stage, n, max_items, r, z, ws, grid, s);
}

extern "C" int dot_block_solve(int a_dtype, int dtype, const void* prog,
                               int n_stage, int n, int k,
                               long long max_items, const void* r, void* z,
                               void* ws, int grid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pg = static_cast<const long long*>(prog);
  if (k == 1) return solve_k<1>(a_dtype, dtype, pg, n_stage, n, max_items, r, z, ws, grid, s);
  if (k == 3) return solve_k<3>(a_dtype, dtype, pg, n_stage, n, max_items, r, z, ws, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
