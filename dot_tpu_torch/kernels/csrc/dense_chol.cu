// K33 dense_chol: the lower Cholesky factors L of a batch of P dense SPD
// matrices A (n x n), read from their lower triangles, and the flag "some
// matrix failed", in one launch. A matrix with a pivot that is <= 0 or not
// finite comes back all NaN; the others are untouched by it.
//
// Replaces the batched library Cholesky of the 2D dense H0 rebuild and the
// passes around it that made its NaN contract (System2D._cholesky_nan: a
// `where` on the info codes, an add over every factor, the diagonal's
// isnan().any(); the library's triu_tril). dot_tpu/dim2.py:604-621 calls
// the library there too (jnp.linalg.cholesky), so no TPU kernel is ported:
// a library call is replaced by a kernel written for this card.
//
// Bound on the H100 at the spikes shapes (P 4, n 5,248, f32): the
// operations. P n^3 / 3 = 1.93e11 operations at the CUDA cores' f32 rate
// of 66.9 TFLOP/s take 2.88 ms; the bytes (A's lower triangles read, L
// written) are ~0.66 GB, 0.2 ms. Numerics: f32 (or f64) FFMA on the CUDA
// cores; no TF32, no bf16.
//
// Design: a left-looking blocked Cholesky over kB x kB tiles (128 in f32,
// 64 in f64), on the transposed factor U = L^T stored row major (that is,
// L column major: the layout the batched library left and K32 reads):
// a task is one tile of U above the diagonal, (J, I) with J <= I (L's tile
// (I, J)) of one matrix:
// - it takes U_KJ^T U_KI for K < J from A's tile (read from A's lower
//   triangle, transposed into shared memory), each K's product summed in
//   registers (each thread an 8 x 8 block of the 128 x 128 tile, f32
//   FFMA) from the 2 J row panels streamed through a ring of cp.async
//   stages, each K's pair of tiles as soon as both are published; sums 64
//   deep keep the rounding near the library's right-looking updates (128
//   deep read 1.52x its error against an f64 factor on the spikes
//   matrices, 16 deep 1.67x on a random batch); the tile is read and
//   written once;
// - a diagonal tile (J == I) is factored in shared memory: panels of 16, a
//   warp factors the panel's diagonal block in registers, the panel rows
//   are solved column by column, the trailing triangle updated; a pivot
//   that is <= 0 or not finite marks the matrix failed;
// - an off-diagonal tile waits for its column's diagonal tile and solves
//   U_JJ^T X = (A - G) by blocked forward substitution (panels of 32),
//   then writes zeros into the mirrored tile (L's upper triangle).
// Tasks are dealt from one counter in a fixed order (tiles by kLead J + I,
// the matrices side by side), and a task only ever waits on tasks dealt
// before it: a persistent cooperative grid (every block resident) cannot
// deadlock, and the deep sums of later columns run while the chain of
// diagonal tiles advances (a diagonal factor, the solve of the tile below
// it, the last product of the next diagonal tile: the latency the sums
// hide). A tile is published by a word holding the call's epoch (stored
// with release after a fence; waiters load it with acquire); the counter
// carries the epoch in its upper half: nothing is reset or memset between
// calls. After the tiles, a task per (matrix, tile row) fills a failed
// matrix with NaN, and a last task writes the flag. Each tile's sums run in
// one fixed order whatever block computes it: the factor repeats bit for
// bit from run to run.
// At the spikes shapes (H100 SXM, 700 W) a call took 7.2-7.4 ms (39-40 %
// of the f32 peak; the library and its passes 31.6-32.3 ms): the products
// run at ~270 GFLOP/s a block (one block an SM: the 8 x 8 register blocks'
// shared-memory reads keep pace with the FFMAs only just), and a column's
// off-diagonal tiles wait on its diagonal factor (44-70 us a tile with
// panels of 32, two thirds of it the warp's panel factors; panels of 16
// and the kLead order took the call from 7.7 to 7.2 ms); P 1, n 10,171
// (the 2D PD factor, rows not 16-byte aligned) took 15.1-15.8 ms, the
// library 14.1.

#include <cuda_runtime.h>

#include <cstdint>

namespace dotk33 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKc = 16;       // rows of U a ring stage holds for each panel
constexpr int kStages = 4;
constexpr int kDepth = 64;    // rows of U summed in registers before W takes
                              // the sum
constexpr int kFw = 16;       // panel width of the diagonal tile's factor
constexpr int kPw = 32;       // panel width of the off-diagonal tiles' solve
constexpr int kLead = 6;      // the dealing order's keys: kLead J + I
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kB = 128;
};
template <>
struct Cfg<double> {
  static constexpr int kB = 64;
};

// shared memory, in elements: the ring (or, once the sums are done, the
// diagonal tile an off-diagonal task solves against), the working tile,
// the reciprocal diagonal
template <typename T>
struct Smem {
  static constexpr int kB = Cfg<T>::kB;
  static constexpr int kLd = kB + 4;   // a padded tile row (16-byte rows)
  static constexpr int kRing = kStages * 2 * kKc * kB;
  static constexpr int kTile = kB * kLd;
  static constexpr int kFirst = kRing > kTile ? kRing : kTile;
  static constexpr size_t kBytes = sizeof(T) * (kFirst + kTile + kB);
};

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

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// every calling thread waits (acquire) until the word holds the epoch; a
// wait that outlasts 2^34 cycles (~9 s) traps: a launch error, never a
// hung card
__device__ __forceinline__ void wait_word(const unsigned* p, unsigned epoch) {
  if (ld_acquire(p) == epoch) return;
  const long long t0 = clock64();
  while (ld_acquire(p) != epoch) {
    __nanosleep(64);
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// the next task of this call: the counter holds (epoch << 32) | tasks
// dealt; the first block to find an older epoch restarts it
__device__ __forceinline__ long long next_task(unsigned long long* ctr,
                                               unsigned epoch) {
  unsigned long long cur = atomicAdd(ctr, 0ull);
  for (;;) {
    const bool ours = static_cast<unsigned>(cur >> 32) == epoch;
    const unsigned long long want =
        ours ? cur + 1 : (static_cast<unsigned long long>(epoch) << 32) | 1ull;
    const unsigned long long got = atomicCAS(ctr, cur, want);
    if (got == cur)
      return ours ? static_cast<long long>(cur & 0xffffffffull) : 0ll;
    cur = got;
  }
}

template <typename T>
__device__ __forceinline__ T nan_of();
template <>
__device__ __forceinline__ float nan_of<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double nan_of<double>() {
  return __longlong_as_double(0x7ff8000000000000ll);
}

// four consecutive elements of a 16-byte aligned shared row
__device__ __forceinline__ void ld4(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ __forceinline__ void ld4(double* d, const double* s) {
  const double2 a = *reinterpret_cast<const double2*>(s);
  const double2 b = *reinterpret_cast<const double2*>(s + 2);
  d[0] = a.x;
  d[1] = a.y;
  d[2] = b.x;
  d[3] = b.y;
}
__device__ __forceinline__ void st4(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ void st4(double* d, const double* s) {
  *reinterpret_cast<double2*>(d) = make_double2(s[0], s[1]);
  *reinterpret_cast<double2*>(d + 2) = make_double2(s[2], s[3]);
}
// 16 bytes of a 16-byte aligned shared row: 4 floats or 2 doubles
__device__ __forceinline__ void ld16(float* d, const float* s) { ld4(d, s); }
__device__ __forceinline__ void ld16(double* d, const double* s) {
  const double2 a = *reinterpret_cast<const double2*>(s);
  d[0] = a.x;
  d[1] = a.y;
}
__device__ __forceinline__ void st16(float* d, const float* s) { st4(d, s); }
__device__ __forceinline__ void st16(double* d, const double* s) {
  *reinterpret_cast<double2*>(d) = make_double2(s[0], s[1]);
}

// kKc rows of U (from row k0) over the kB columns from c0 into the ring;
// columns past n come in as zeros (the rows are a whole tile's: < n)
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* U, int n, int k0,
                                          int c0, bool vec) {
  constexpr int kB = Cfg<T>::kB;
  if (vec) {
    constexpr int kEpc = 16 / sizeof(T);
    constexpr int kCpr = kB / kEpc;
#pragma unroll
    for (int it = 0; it < kKc * kCpr / kThreads; ++it) {
      const int ch = threadIdx.x + it * kThreads;
      const int row = ch / kCpr, col = (ch % kCpr) * kEpc;
      const bool ok = c0 + col < n;
      const T* src =
          ok ? U + static_cast<long long>(k0 + row) * n + c0 + col : U;
      cp_async16(dst + row * kB + col, src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kKc * kB / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int row = e / kB, col = e % kB;
      const bool ok = c0 + col < n;
      const T* src =
          ok ? U + static_cast<long long>(k0 + row) * n + c0 + col : U;
      cp_async_elem<sizeof(T)>(dst + e, src, ok ? sizeof(T) : 0);
    }
  }
}

// the kW x kW diagonal block of panel p0 of the tile A (upper form, in
// place) in warp 0: lane l < kW holds column p0 + l; rinv gets the
// reciprocal pivots. Returns whether a pivot was <= 0 or not finite (on
// every lane).
template <typename T, int kW>
__device__ __forceinline__ bool factor_block(T* A, T* rinv, int p0) {
  constexpr int kLd = Smem<T>::kLd;
  const int lane = threadIdx.x & 31;
  const int col = p0 + min(lane, kW - 1);
  T c[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) c[k] = A[(p0 + k) * kLd + col];
  bool bad = false;
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const T d = __shfl_sync(kFull, c[k], k);
    bad = bad || !(d > T(0)) || !isfinite(d);
    const T u = sqrt(d);
    const T ri = T(1) / u;
    if (lane == k) {
      c[k] = u;
    } else if (lane > k) {
      c[k] *= ri;
    }
#pragma unroll
    for (int m = k + 1; m < kW; ++m) {
      const T um = __shfl_sync(kFull, c[k], m);
      if (lane >= m) c[m] = fma(-um, c[k], c[m]);
    }
    if (lane == 0) rinv[p0 + k] = ri;
  }
#pragma unroll
  for (int k = 0; k < kW; ++k)
    if (k <= lane && lane < kW) A[(p0 + k) * kLd + col] = c[k];
  return bad;
}

// rows p0..p0+kW-1 of X over the columns [c0, kB): X <- D_pp^{-T} X,
// D_pp the factored diagonal block of panel p0 of D (upper), one thread a
// column; D's rows are read 4 entries at a time
template <typename T, int kW>
__device__ __forceinline__ void solve_panel(const T* D, const T* rinv, T* X,
                                            int p0, int c0) {
  constexpr int kB = Cfg<T>::kB, kLd = Smem<T>::kLd;
  const int col = c0 + static_cast<int>(threadIdx.x);
  if (col >= kB) return;
  T x[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) x[k] = X[(p0 + k) * kLd + col];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    x[k] *= rinv[p0 + k];
    const T* drow = D + (p0 + k) * kLd + p0;
#pragma unroll
    for (int g = (k + 1) / 4; g < kW / 4; ++g) {
      T d[4];
      ld4(d, drow + 4 * g);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * g + e > k) x[4 * g + e] = fma(-d[e], x[k], x[4 * g + e]);
    }
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) X[(p0 + k) * kLd + col] = x[k];
}

// the rows below the kW rows of panel p0 over the columns [c0, kB):
// X[m][c] -= sum_k D[p0 + k][m] X[p0 + k][c]; `upper`: only where m <= c
// matters (a lane leaves the row groups wholly below its columns). A warp
// takes 4 rows at a time, a lane 16 bytes of consecutive columns.
template <typename T, int kW>
__device__ __forceinline__ void update_below(const T* D, T* X, int p0,
                                             int c0, bool upper) {
  constexpr int kB = Cfg<T>::kB, kLd = Smem<T>::kLd;
  constexpr int kCpl = kB / 32;   // a lane's columns: 4 (f32), 2 (f64)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = p0 + kW;
  const int col = kCpl * lane;
  if (col < c0) return;
  for (int g = warp; g < (kB - m0) / 4; g += kWarps) {
    const int m = m0 + 4 * g;
    if (upper && m > col + kCpl - 1) break;
    T s[4][kCpl];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kCpl; ++j) s[r][j] = T(0);
#pragma unroll 4
    for (int k = 0; k < kW; ++k) {
      T d[4], xv[kCpl];
      ld4(d, D + (p0 + k) * kLd + m);
      ld16(xv, X + (p0 + k) * kLd + col);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < kCpl; ++j) s[r][j] = fma(d[r], xv[j], s[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      T o[kCpl];
      ld16(o, X + (m + r) * kLd + col);
#pragma unroll
      for (int j = 0; j < kCpl; ++j) o[j] -= s[r][j];
      st16(X + (m + r) * kLd + col, o);
    }
  }
}

// the working tile A (upper form) factored in place: A = U^T U. Returns
// whether some pivot was <= 0 or not finite (the same on every thread).
template <typename T>
__device__ __forceinline__ bool factor_tile(T* A, T* rinv) {
  constexpr int kB = Cfg<T>::kB;
  __shared__ int s_bad;
  if (threadIdx.x == 0) s_bad = 0;
  for (int p0 = 0; p0 < kB; p0 += kFw) {
    if (threadIdx.x < 32) {
      const bool bad = factor_block<T, kFw>(A, rinv, p0);
      if (bad && threadIdx.x == 0) s_bad = 1;
    }
    __syncthreads();
    if (p0 + kFw < kB) {
      solve_panel<T, kFw>(A, rinv, A, p0, p0 + kFw);
      __syncthreads();
      update_below<T, kFw>(A, A, p0, p0 + kFw, true);
      __syncthreads();
    }
  }
  return s_bad != 0;
}

// X <- D^{-T} X over the whole tile, D factored (upper) with its
// reciprocal pivots in rinv
template <typename T>
__device__ __forceinline__ void solve_tile(const T* D, const T* rinv, T* X) {
  constexpr int kB = Cfg<T>::kB;
  for (int p0 = 0; p0 < kB; p0 += kPw) {
    solve_panel<T, kPw>(D, rinv, X, p0, 0);
    __syncthreads();
    if (p0 + kPw < kB) {
      update_below<T, kPw>(D, X, p0, 0, false);
      __syncthreads();
    }
  }
}

struct Args {
  const void* A;      // (P, n, n) row major, lower triangles read
  void* U;            // (P, n, n) row major: U = L^T
  int n, nt, P;
  unsigned epoch;
  unsigned* words;    // P nt (nt + 1) / 2 tile words, then P failure words
  unsigned long long* ctr;
  unsigned char* bad;
  int vec;
};

// one tile task: U's tile (J, I), J <= I, of matrix p
template <typename T>
__device__ __forceinline__ void tile_task(const Args& a, int p, int I, int J,
                                          unsigned char* smem) {
  using Sm = Smem<T>;
  constexpr int kB = Sm::kB, kLd = Sm::kLd, kTm = kB / 16;
  T* ring = reinterpret_cast<T*>(smem);
  T* D = ring;
  T* W = ring + Sm::kFirst;
  T* rinv = W + Sm::kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n;
  const long long ntri = static_cast<long long>(a.nt) * (a.nt + 1) / 2;
  unsigned* words = a.words + p * ntri;
  unsigned* failed = a.words + a.P * ntri + p;
  auto word = [&](int row, int col) {
    return words + static_cast<long long>(row) * (row + 1) / 2 + col;
  };
  const T* Ap = static_cast<const T*>(a.A) + static_cast<long long>(p) * n * n;
  T* Up = static_cast<T*>(a.U) + static_cast<long long>(p) * n * n;
  const int rI = I * kB, rJ = J * kB;
  const unsigned epoch = a.epoch;

  // a failed matrix is filled with NaN at the end: skip its work
  __shared__ int s_skip;
  if (tid == 0) s_skip = ld_acquire(failed) == epoch;
  __syncthreads();
  if (s_skip) {
    if (tid == 0) st_release(word(I, J), epoch);
    return;
  }

  // ---- W = A's tile, W[j][i] = A[rI + i][rJ + j] (U's rows j, columns
  // i); past n: the identity on a diagonal tile, else zeros
  const bool diag = I == J;
#pragma unroll 4
  for (int it = 0; it < kB * kB / kThreads; ++it) {
    const int e = tid + it * kThreads;
    const int r = e / kB, c = e % kB;   // A's row rI + r, column rJ + c
    const int gr = rI + r, gc = rJ + c;
    T v;
    if (gr < n && gc < n) {
      v = (!diag || r >= c) ? __ldg(Ap + static_cast<long long>(gr) * n + gc)
                            : T(0);
    } else {
      v = diag && r == c ? T(1) : T(0);
    }
    W[c * kLd + r] = v;
  }

  // ---- W -= U_KJ^T U_KI for K < J: kDepth rows of the product at a time
  // summed in registers (kKc rows of U a stage), then taken from W (a
  // thread its own 8 x 8 entries, 16-byte rows; the chunks' barriers order
  // it after the fill above)
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  T acc[kTm][kTm];
#pragma unroll
  for (int i = 0; i < kTm; ++i)
#pragma unroll
    for (int j = 0; j < kTm; ++j) acc[i][j] = T(0);
  constexpr int kChunks = kB / kKc;   // chunks a K tile
  const int nch = J * kChunks;
  const bool vec = a.vec != 0;
  auto issue = [&](int c) {
    if (c < nch) {
      const int k0 = c * kKc;
      if (c % kChunks == 0) {
        const int K = c / kChunks;
        wait_word(word(J, K), epoch);
        wait_word(word(I, K), epoch);
      }
      T* st = ring + (c % kStages) * 2 * kKc * kB;
      load_rows(st, Up, n, k0, rJ, vec);
      load_rows(st + kKc * kB, Up, n, k0, rI, vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const T* As = ring + (c % kStages) * 2 * kKc * kB;
    const T* Bs = As + kKc * kB;
#pragma unroll
    for (int k = 0; k < kKc; ++k) {
      T fa[kTm], fb[kTm];
#pragma unroll
      for (int h = 0; h < kTm / 4; ++h) {
        ld4(fa + 4 * h, As + k * kB + 64 * h + 4 * ty);
        ld4(fb + 4 * h, Bs + k * kB + 64 * h + 4 * tx);
      }
#pragma unroll
      for (int i = 0; i < kTm; ++i)
#pragma unroll
        for (int j = 0; j < kTm; ++j) acc[i][j] = fma(fa[i], fb[j], acc[i][j]);
    }
    if ((c + 1) % (kDepth / kKc) == 0) {
#pragma unroll
      for (int i = 0; i < kTm; ++i)
#pragma unroll
        for (int h = 0; h < kTm / 4; ++h) {
          T* w = W + (64 * (i >> 2) + 4 * ty + (i & 3)) * kLd + 64 * h + 4 * tx;
          T v[4];
          ld4(v, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[q] -= acc[i][4 * h + q];
            acc[i][4 * h + q] = T(0);
          }
          st4(w, v);
        }
    }
    issue(c + kStages - 1);
  }
  cp_async_wait<0>();
  __syncthreads();

  if (diag) {
    const bool bad = factor_tile(W, rinv);
#pragma unroll 4
    for (int it = 0; it < kB * kB / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int c = e / kB, r = e % kB;   // U's row rJ + c, column rJ + r
      if (rJ + c < n && rJ + r < n)
        Up[static_cast<long long>(rJ + c) * n + rJ + r] =
            r >= c ? W[c * kLd + r] : T(0);
    }
    if (bad && tid == 0) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(failed),
                   "r"(epoch)
                   : "memory");
    }
  } else {
    // the column's factored diagonal tile (whole: J < nt - 1)
    wait_word(word(J, J), epoch);
    __syncthreads();   // the ring is free
#pragma unroll 4
    for (int it = 0; it < kB * kB / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int c = e / kB, r = e % kB;
      D[c * kLd + r] = r >= c ? __ldcg(Up + static_cast<long long>(rJ + c) * n
                                       + rJ + r)
                              : T(0);
    }
    __syncthreads();
    if (tid < kB) rinv[tid] = T(1) / D[tid * kLd + tid];
    __syncthreads();
    solve_tile(D, rinv, W);
#pragma unroll 4
    for (int it = 0; it < kB * kB / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int c = e / kB, r = e % kB;   // U's row rJ + c, column rI + r
      if (rI + r < n)
        Up[static_cast<long long>(rJ + c) * n + rI + r] = W[c * kLd + r];
    }
    // L's upper triangle: U's mirrored tile (rows rI.., columns rJ..)
#pragma unroll 4
    for (int it = 0; it < kB * kB / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / kB, c = e % kB;
      if (rI + r < n) Up[static_cast<long long>(rI + r) * n + rJ + c] = T(0);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) st_release(word(I, J), epoch);
}

// every tile word of matrix p holds the epoch (each thread a share, then
// the block's barrier)
__device__ __forceinline__ void wait_matrix(const Args& a, int p) {
  const long long ntri = static_cast<long long>(a.nt) * (a.nt + 1) / 2;
  const unsigned* words = a.words + p * ntri;
  for (long long w = threadIdx.x; w < ntri; w += kThreads)
    wait_word(words + w, a.epoch);
  __syncthreads();
}

// tile row r of a failed matrix p: all NaN
template <typename T>
__device__ __forceinline__ void fill_task(const Args& a, int p, int r) {
  constexpr int kB = Cfg<T>::kB;
  wait_matrix(a, p);
  const long long ntri = static_cast<long long>(a.nt) * (a.nt + 1) / 2;
  if (ld_acquire(a.words + a.P * ntri + p) != a.epoch) return;
  const int n = a.n;
  const int r0 = r * kB, r1 = min(n, r0 + kB);
  T* Up = static_cast<T*>(a.U) + static_cast<long long>(p) * n * n;
  const long long len = static_cast<long long>(r1 - r0) * n;
  T* base = Up + static_cast<long long>(r0) * n;
  for (long long e = threadIdx.x; e < len; e += kThreads) base[e] = nan_of<T>();
}

// the flag: some matrix failed
__device__ __forceinline__ void flag_task(const Args& a) {
  for (int p = 0; p < a.P; ++p) wait_matrix(a, p);
  if (threadIdx.x != 0) return;
  const long long ntri = static_cast<long long>(a.nt) * (a.nt + 1) / 2;
  bool any = false;
  for (int p = 0; p < a.P; ++p)
    any = any || ld_acquire(a.words + a.P * ntri + p) == a.epoch;
  *a.bad = any ? 1 : 0;
}

// the tile (I, J) of rank q in the dealing order: keys kLead J + I
// ascending, then J (then the matrices side by side). Every tile a task
// waits on has a smaller key, and the diagonal tile of column J + 1 comes
// before the tiles of column J more than kLead + 1 tiles below its
// diagonal: its factor is under way while they sum.
__device__ __forceinline__ void tile_of(long long q, int nt, int& I, int& J) {
  for (int s = 0;; ++s) {
    const int lo = max(0, (s - nt + kLead) / kLead);   // I <= nt - 1
    const int hi = s / (kLead + 1);                     // I >= J
    if (hi < lo) continue;
    if (q <= hi - lo) {
      J = lo + static_cast<int>(q);
      I = s - kLead * J;
      return;
    }
    q -= hi - lo + 1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) dense_chol_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_task;
  const long long ntri = static_cast<long long>(a.nt) * (a.nt + 1) / 2;
  const long long n_tile = a.P * ntri;
  const long long n_fill = static_cast<long long>(a.P) * a.nt;
  const long long n_task = n_tile + n_fill + 1;
  for (;;) {
    __syncthreads();   // the previous task is done with shared memory
    if (threadIdx.x == 0) s_task = next_task(a.ctr, a.epoch);
    __syncthreads();
    const long long t = s_task;
    if (t >= n_task) return;
    if (t < n_tile) {
      int I, J;
      tile_of(t / a.P, a.nt, I, J);
      tile_task<T>(a, static_cast<int>(t % a.P), I, J, smem);
    } else if (t < n_tile + n_fill) {
      const long long u = t - n_tile;
      fill_task<T>(a, static_cast<int>(u / a.nt), static_cast<int>(u % a.nt));
    } else {
      flag_task(a);
    }
  }
}

template <typename T>
int launch(Args a, cudaStream_t s) {
  auto kern = dense_chol_kernel<T>;
  constexpr size_t kSmem = Smem<T>::kBytes;
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
  constexpr int kB = Cfg<T>::kB;
  a.nt = (a.n + kB - 1) / kB;
  const long long tasks = static_cast<long long>(a.P) * a.nt * (a.nt + 1) / 2
                          + static_cast<long long>(a.P) * a.nt + 1;
  const unsigned grid = static_cast<unsigned>(
      tasks < blocks_of[dev] ? tasks : blocks_of[dev]);
  // 16-byte row loads where every row of U starts on a 16-byte boundary
  a.vec = a.n % (16 / static_cast<int>(sizeof(T))) == 0
          && reinterpret_cast<uintptr_t>(a.U) % 16 == 0;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), grid,
                                  kThreads, args, kSmem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk33

// A: (P, n, n) contiguous, its lower triangles read; U: (P, n, n)
// contiguous, not A, written with L^T (L column major, zeros below U's
// diagonal; a failed matrix all NaN); bad: one byte, written 1 if some
// matrix failed, else 0. words: at least P nt (nt + 1) / 2 + P 32-bit words
// for nt = ceil(n / 64), ctr: one 64-bit word; both zeros once at
// allocation, then left to the kernel; epoch: nonzero, a new one each call
// on them. Returns 0, a CUDA error code, -2 without cooperative launch, -3
// when no block fits on an SM, -4 for a device ordinal beyond the cache.
// The f32 entry and the f64 one (built with DOT_K33_F64) are two libraries
// of this source: each compiles in its own nvcc process, beside the other
// sources, in about half the time of both.
#ifdef DOT_K33_F64
#define DOT_K33_T double
#define DOT_K33_ENTRY dot_dense_chol64
#else
#define DOT_K33_T float
#define DOT_K33_ENTRY dot_dense_chol
#endif
extern "C" int DOT_K33_ENTRY(const void* A, void* U, int P, int n,
                             unsigned epoch, void* words, void* ctr,
                             void* bad, void* stream) {
  if (P == 0 || n == 0) return 0;
  dotk33::Args a{A, U, n, 0, P, epoch, static_cast<unsigned*>(words),
                 static_cast<unsigned long long*>(ctr),
                 static_cast<unsigned char*>(bad), 0};
  return dotk33::launch<DOT_K33_T>(a, static_cast<cudaStream_t>(stream));
}
