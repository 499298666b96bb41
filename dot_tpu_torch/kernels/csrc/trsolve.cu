// K32 tri_solve: z = L^{-T} L^{-1} r for a batch of P dense Cholesky
// factors L (n x n) and one right-hand side each, forward substitution
// L y = r and then backward substitution L^T z = y, in one launch.
//
// Replaces the two batched library triangular solves of the 2D dense H0
// apply (System2D.solve_local; dot_tpu/dim2.py:623-629 calls the library
// there too, so no TPU kernel is ported: a library call is replaced by a
// kernel written for this card). The factor is read as it is stored: row
// major with L in its lower triangle, or column major (`upper`: the memory
// holds L^T row major, as the batched library Cholesky leaves it).
//
// Bound on the H100 at the spikes shapes (P 4, n 5,248, f32): the bytes.
// One pass reads the P lower triangles, 220 MB (66 us at 3.35 TB/s); a
// pair reads them twice. The library's batched trsv walks each matrix
// with too few blocks to fill the card (2.76 ms a pair, ~160 GB/s).
//
// Design: blocked substitution over 64 x 64 tiles in a wavefront. A work
// item is one tile row of one subdomain in one pass; items run in the
// order forward rows 0..nt-1, then backward rows nt-1..0, each row's P
// subdomains side by side. A persistent cooperative grid (every block
// resident) walks the items in that order, so a block only ever waits on
// an item of lower index, which is running or done: no deadlock, no grid
// barrier. An item
// - loads its diagonal tile into shared memory (coefficient layout, padded
//   rows: the substitution's column reads are conflict-free) and its
//   reciprocal diagonal, before it waits on anything;
// - streams the off-diagonal tiles of its row (forward) or column
//   (backward) through a ring of cp.async stages, and adds each tile's
//   product with the solved piece of the vector as soon as that piece is
//   published; a tile stored in the other orientation is applied
//   transposed inside the tile, so every load stays a coalesced row read;
// - solves its diagonal tile in one warp: panels of 8 rows solved in
//   registers by every lane, the warp's own rows updated by each panel;
// - publishes its piece of y (then of z) as tagged words: each 32 bits of
//   a value beside the call's epoch in one 64-bit store, so a reader that
//   finds its epoch in every word of a piece has the piece, with no flag,
//   fence or second read between them. One warp of a waiting block polls
//   the piece it needs next, and reads the one after ahead. The wrapper
//   passes a new epoch each call: nothing is reset, memset or read back.
// Each output is one thread's sums in a fixed order of tiles, then a
// fixed-order reduction: the result repeats bit for bit from run to run.
// At the spikes shapes (H100 SXM, 700 W) a pair took 0.38 ms, set by the
// chain of 2 x 82 steps and not by the bytes (a P = 1 slice takes as
// long): a step is ~2 us, of which the hand-off is ~0.3 and the diagonal
// substitution ~1.2; a first design that published a progress word after
// a fence, read before the piece itself, took 0.65 ms.

#include <cuda_runtime.h>

#include <cstdint>

namespace dotk32 {

constexpr int kT = 64;          // tile rows = columns
constexpr int kPad = kT + 1;    // the diagonal tile's padded row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kT / kWarps;
constexpr unsigned kFull = 0xffffffffu;

// ring stages and resident blocks an SM (two: the diagonal solve keeps a
// panel's coefficients in registers): ~67 KB of shared memory a block in
// f32, ~102 KB in f64
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = 2;
};
template <>
struct Cfg<double> {
  static constexpr int kStages = 2;
  static constexpr int kMinBlocks = 2;
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (static_cast<size_t>(Cfg<T>::kStages) * kT * kT
                      + kT * kPad + kWarps * kT + kT + 2 * kT);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

template <int kBytes>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(kBytes), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kLeft>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kLeft) : "memory");
}

__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_word(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// a solved vector as tagged words: value bits 32 at a time, each word
// (epoch << 32) | bits
template <typename T>
__device__ __forceinline__ void put(unsigned long long* vec, int row, T v,
                                    unsigned epoch) {
  const unsigned long long tag = static_cast<unsigned long long>(epoch) << 32;
  if constexpr (sizeof(T) == 4) {
    st_word(vec + row, tag | __float_as_uint(v));
  } else {
    const unsigned long long b = __double_as_longlong(v);
    st_word(vec + 2 * row, tag | (b & 0xffffffffull));
    st_word(vec + 2 * row + 1, tag | (b >> 32));
  }
}

// one 64-row piece of a tagged vector as warp 0 holds it: rows lane (h 0)
// and lane + 32 (h 1); rows past n read nothing and count as zeros
template <typename T>
struct Piece {
  static constexpr int kW = sizeof(T) / 4;
  unsigned long long w[2][kW];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < kW; ++k) w[h][k] = 0;
  }
  __device__ __forceinline__ void read(const unsigned long long* vec,
                                       int row0, int n) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + lane + 32 * h;
#pragma unroll
      for (int k = 0; k < kW; ++k)
        w[h][k] = row < n ? ld_word(vec + static_cast<long long>(row) * kW + k)
                          : 0ull;
    }
  }
  // every lane's words carry the epoch (the warp's vote)
  __device__ __forceinline__ bool whole(unsigned epoch, int row0,
                                        int n) const {
    const int lane = threadIdx.x & 31;
    bool ok = true;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < kW; ++k)
        ok = ok && (row0 + lane + 32 * h >= n
                    || static_cast<unsigned>(w[h][k] >> 32) == epoch);
    return __all_sync(kFull, ok);
  }
  // re-read until whole; a wait that outlasts 2^34 cycles (~9 s) traps: a
  // launch error, never a hung card
  __device__ __forceinline__ void wait(const unsigned long long* vec,
                                       unsigned epoch, int row0, int n) {
    long long t0 = 0;
    while (!whole(epoch, row0, n)) {
      if (t0 == 0) {
        t0 = clock64();
      } else if (clock64() - t0 > (1ll << 34)) {
        __trap();
      }
      read(vec, row0, n);
    }
  }
  __device__ __forceinline__ T value(int h) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(static_cast<unsigned>(w[h][0]));
    } else {
      return __longlong_as_double(static_cast<long long>(
          (w[h][0] & 0xffffffffull) | (w[h][1] << 32)));
    }
  }
};

// a stored 64 x 64 tile at (tr0, tc0) of one n x n matrix into the ring;
// entries past n come in as zeros
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* m, int n, int tr0,
                                          int tc0, bool vec) {
  if (vec) {
    constexpr int kEpc = 16 / sizeof(T);   // elements a 16-byte chunk
    constexpr int kCpr = kT / kEpc;        // chunks a row
#pragma unroll
    for (int it = 0; it < kT * kCpr / kThreads; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int row = c / kCpr, col = (c % kCpr) * kEpc;
      const bool ok = tr0 + row < n && tc0 + col < n;
      const T* src =
          ok ? m + static_cast<long long>(tr0 + row) * n + tc0 + col : m;
      cp_async16(dst + row * kT + col, src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kT * kT / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int row = e / kT, col = e % kT;
      const bool ok = tr0 + row < n && tc0 + col < n;
      const T* src =
          ok ? m + static_cast<long long>(tr0 + row) * n + tc0 + col : m;
      cp_async_elem<sizeof(T)>(dst + e, src, ok ? sizeof(T) : 0);
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// the diagonal tile's solve in one warp: lane l holds rows l (b0) and
// l + 32 (b1) of the right-hand side and leaves the solution there (each
// panel's solution goes through `ysol` in shared memory, off the chain).
// D[i * kPad + j] is the coefficient by which solved row i enters row j
// (rows after i in the solve's order: j > i ascending, j < i descending).
// Panels of 8 rows: every lane solves the panel in registers, then the
// lanes update their own later rows with the panel's 8 values. A panel's
// coefficients are read into registers before its chain of dependent
// products starts: the chain waits on no shared-memory read.
template <typename T, bool kAsc>
__device__ __forceinline__ void solve_diag(const T* D, const T* rinv,
                                           T* ysol, T& b0, T& b1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int step = 0; step < kT / 8; ++step) {
    const int pb = kAsc ? 8 * step : kT - 8 - 8 * step;
    const bool hi = pb >= 32;
    T c[8][8], ri[8], c0[8], c1[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const T* col = D + (pb + i) * kPad;
      ri[i] = rinv[pb + i];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        c[i][k] = (kAsc ? k > i : k < i) ? col[pb + k] : T(0);
      c0[i] = col[lane];
      c1[i] = col[lane + 32];
    }
    T q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      q[k] = __shfl_sync(kFull, hi ? b1 : b0, (pb + k) & 31);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int i = kAsc ? s : 7 - s;
      q[i] *= ri[i];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (kAsc ? k > i : k < i) q[k] = fma(-c[i][k], q[i], q[k]);
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int i = kAsc ? s : 7 - s;
      if (kAsc ? lane >= pb + 8 : lane < pb) b0 = fma(-c0[i], q[i], b0);
      if (kAsc ? lane + 32 >= pb + 8 : lane + 32 < pb)
        b1 = fma(-c1[i], q[i], b1);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) ysol[pb + k] = q[k];
    }
  }
  __syncwarp();
  b0 = ysol[lane];
  b1 = ysol[lane + 32];
}

// one tile row I of subdomain p in one pass (fwd: L y = r; else L^T z = y)
template <typename T>
__device__ __forceinline__ void item(const T* __restrict__ S,
                                     const T* __restrict__ r, T* z, int n,
                                     int nt, int P, bool upper, bool vec,
                                     bool fwd, int p, int I, unsigned epoch,
                                     unsigned long long* words,
                                     unsigned char* smem) {
  constexpr int kStages = Cfg<T>::kStages;
  constexpr int kW = sizeof(T) / 4;
  T* ring = reinterpret_cast<T*>(smem);
  T* D = ring + kStages * kT * kT;
  T* red = D + kT * kPad;
  T* rinv = red + kWarps * kT;
  T* piece = rinv + kT;   // two buffers of the vector's piece
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* m = S + static_cast<long long>(p) * n * n;
  const int r0 = I * kT, nrows = min(kT, n - r0);
  // the tiles this item streams are stored as (I, J): read by rows; else
  // stored as (J, I): applied transposed
  const bool rows = fwd != upper;
  // y's tagged words (forward's output, backward's right-hand side) and
  // the words this pass writes and reads
  const unsigned long long* ywords =
      words + static_cast<long long>(p) * n * kW;
  unsigned long long* mine =
      words + (static_cast<long long>(fwd ? 0 : P) + p) * n * kW;

  __syncthreads();   // the previous item is done with D, red, rinv, piece
  const int nj = fwd ? I : nt - 1 - I;
  auto tile_row = [&](int k) { return (fwd ? k : nt - 1 - k) * kT; };
  auto issue = [&](int k) {
    if (k < nj) {
      load_tile(ring + (k % kStages) * kT * kT, m, n, rows ? r0 : tile_row(k),
                rows ? tile_row(k) : r0, vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  Piece<T> next, base;
  base.clear();
  if (warp == 0 && nj > 0) next.read(mine, tile_row(0), n);

  // the diagonal tile in coefficient layout: the solved row i enters row
  // j by L[j][i] (forward) or L[i][j] (backward); zeros past n, a unit
  // diagonal past the last row
  {
    const bool tr = rows;
#pragma unroll
    for (int it = 0; it < kT * kT / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int a = e / kT, b = e % kT;
      T v = a < nrows && b < nrows
                ? __ldg(m + static_cast<long long>(r0 + a) * n + r0 + b)
                : T(0);
      if (a == b && a >= nrows) v = T(1);
      D[tr ? b * kPad + a : a * kPad + b] = v;
    }
  }
  __syncthreads();   // D whole
  if (tid < kT) rinv[tid] = T(1) / D[tid * kPad + tid];
  // warp 0's rows of the right-hand side (forward: r; backward: y, read
  // once the first piece is in, checked at the end)
  T base0 = T(0), base1 = T(0);
  if (warp == 0 && fwd) {
    const T* src = r + static_cast<long long>(p) * n + r0;
    if (lane < nrows) base0 = __ldg(src + lane);
    if (lane + 32 < nrows) base1 = __ldg(src + lane + 32);
  }

  T acc[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) acc[k] = T(0);
  for (int k = 0; k < nj; ++k) {
    T* v = piece + (k & 1) * kT;
    if (warp == 0) {
      next.wait(mine, epoch, tile_row(k), n);
      v[lane] = next.value(0);
      v[lane + 32] = next.value(1);
      if (!fwd && k == 0) base.read(ywords, r0, n);
      if (k + 1 < nj) next.read(mine, tile_row(k + 1), n);
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const T* tile = ring + (k % kStages) * kT * kT;
    if (rows) {
      // acc[q] = row 8 warp + q, over the columns lane, lane + 32
      const T v0 = v[lane], v1 = v[lane + 32];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const T* row = tile + (warp * kRowsPerWarp + q) * kT;
        acc[q] = fma(row[lane], v0, acc[q]);
        acc[q] = fma(row[lane + 32], v1, acc[q]);
      }
    } else {
      // acc[0], acc[1] = columns lane, lane + 32 over the warp's 8 rows
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int j = warp * kRowsPerWarp + q;
        const T vj = v[j];
        acc[0] = fma(tile[j * kT + lane], vj, acc[0]);
        acc[1] = fma(tile[j * kT + lane + 32], vj, acc[1]);
      }
    }
    issue(k + kStages - 1);
  }
  cp_async_wait<0>();

  if (rows) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = warp_sum(acc[q]);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q)
        red[warp * kRowsPerWarp + q] = acc[q];
    }
  } else {
    red[warp * kT + lane] = acc[0];
    red[warp * kT + lane + 32] = acc[1];
  }
  __syncthreads();
  if (warp != 0) return;
  if (!fwd) {
    base.wait(ywords, epoch, r0, n);
    base0 = base.value(0);
    base1 = base.value(1);
  }
  T s0, s1;
  if (rows) {
    s0 = red[lane];
    s1 = red[lane + 32];
  } else {
    s0 = T(0);
    s1 = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s0 += red[w * kT + lane];
      s1 += red[w * kT + lane + 32];
    }
  }
  T b0 = base0 - s0, b1 = base1 - s1;
  __syncwarp();   // every lane has read red: it holds the solution next
  if (fwd)
    solve_diag<T, true>(D, rinv, red, b0, b1);
  else
    solve_diag<T, false>(D, rinv, red, b0, b1);
  if (lane < nrows) put(mine, r0 + lane, b0, epoch);
  if (lane + 32 < nrows) put(mine, r0 + lane + 32, b1, epoch);
  if (!fwd) {
    T* zp = z + static_cast<long long>(p) * n + r0;
    if (lane < nrows) zp[lane] = b0;
    if (lane + 32 < nrows) zp[lane + 32] = b1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Cfg<T>::kMinBlocks)
    tri_solve_kernel(const T* __restrict__ S, const T* __restrict__ r, T* z,
                     int n, int nt, int P, int upper, int vec,
                     unsigned epoch, unsigned long long* words) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long per = static_cast<long long>(P) * nt;
  for (long long t = blockIdx.x; t < 2 * per; t += gridDim.x) {
    const bool fwd = t < per;
    const long long u = fwd ? t : t - per;
    const int I = static_cast<int>(fwd ? u / P : nt - 1 - u / P);
    const int p = static_cast<int>(u % P);
    item<T>(S, r, z, n, nt, P, upper != 0, vec != 0, fwd, p, I, epoch, words,
            smem);
  }
}

template <typename T>
int launch(const void* S, const void* r, void* z, int P, int n, int upper,
           unsigned epoch, void* words, cudaStream_t s) {
  auto kern = tri_solve_kernel<T>;
  constexpr size_t kSmem = smem_bytes<T>();
  constexpr int kMaxDev = 64;
  static int blocks_of[kMaxDev] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDev) return -4;
  if (blocks_of[dev] == 0) {
    int coop = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop) return -2;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return -3;
    blocks_of[dev] = per_sm * sms;
  }
  int nt = (n + kT - 1) / kT;
  const long long items = 2ll * P * nt;
  const unsigned grid = static_cast<unsigned>(
      items < blocks_of[dev] ? items : blocks_of[dev]);
  // 16-byte tile loads where every row starts on a 16-byte boundary
  int vec = n % (16 / static_cast<int>(sizeof(T))) == 0
            && reinterpret_cast<uintptr_t>(S) % 16 == 0;
  const T* a = static_cast<const T*>(S);
  const T* b = static_cast<const T*>(r);
  T* c = static_cast<T*>(z);
  auto* w = static_cast<unsigned long long*>(words);
  void* args[] = {&a, &b, &c, &n, &nt, &P, &upper, &vec, &epoch, &w};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), grid,
                                  kThreads, args, kSmem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk32

// dtype: 0 f32, 1 f64. S: (P, n, n) contiguous, L row major (upper 0) or
// L^T row major (upper 1); r, z: (P, n) contiguous, z != r; words: 2 P n
// (f32) or 4 P n (f64) 64-bit words, zeros once at allocation, then left
// to the kernel; epoch: nonzero, a new one each call on the words. Returns
// 0, a CUDA error code, -2 without cooperative launch, -3 when no block
// fits on an SM, -4 for a device ordinal beyond the cache, -6 for another
// dtype.
extern "C" int dot_tri_solve(int dtype, const void* S, const void* r,
                             void* z, int P, int n, int upper,
                             unsigned epoch, void* words, void* stream) {
  if (P == 0 || n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dotk32::launch<float>(S, r, z, P, n, upper, epoch, words, s);
  if (dtype == 1)
    return dotk32::launch<double>(S, r, z, P, n, upper, epoch, words, s);
  return -6;
}
