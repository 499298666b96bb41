// K6 chol_inv: for a batch of SPD (n x n) blocks, the lower Cholesky
// factor L and its inverse L^{-1}, in f32 or f64, at any width, in one
// (cooperative) launch.
//
// Replaces the diagonal-block factorizations of dot_tpu/steppers/core.py:
// 904-914 (the scan's chol_inv: lax.linalg.cholesky(symmetrize_input=
// False) + triangular_solve against I), 1016-1019 and 1034-1038 (cyclic
// reduction's level and root blocks: jnp.linalg.cholesky, which factors
// (A + A^T) / 2, + triangular_solve) and 1161 (factorize_fast's diagonal
// tiles). `sym` = 1 factors (A + A^T) / 2; `sym` = 0 reads the lower
// triangle only.
//
// Failure semantics: a pivot that is not > 0 (or NaN), or a non-finite
// entry of L, sets info[b] = 1 and fills both outputs of block b with NaN
// (as cholesky_ex's info != 0 mapped to NaN; the robustness tiers of the
// H0 rebuild key on NaN). Its neighbours in the batch are untouched.
//
// Bound on the H100: the operations, n^3/3 flops for L and n^3/3 for
// L^{-1} per matrix (2 x 151 M at n = 768: 0.1623 ms for 36 blocks at the
// 67 TFLOP/s f32 SIMT peak); the bytes (A read, L and L^{-1} written) are
// 7 MB per 768^2 block in f32, 2.1 us at 3.35 TB/s.
//
// Design: a persistent kernel, launched cooperatively with as many blocks
// of 256 threads as are co-resident, runs a blocked right-looking
// Cholesky over T x T tiles of every matrix of the batch at once (T = 32
// in f64; in f32 the caller picks 32 below 16 blocks, where the diagonal
// tiles' serial factor sets the pace, and 64 from 16 up, where the GEMM
// updates do). Tiles live in device memory (L and L^{-1} are the working
// storage, L2-resident for the tiles in use), so there is no width
// limit. Work items of a phase are spread over the grid as (item, matrix)
// pairs, with grid-wide barriers between phases:
//   init   L = the lower triangle of A (or of (A + A^T)/2 via a shared-
//          memory transpose), X = I on its lower tiles, zeros above;
//   for k = 0 .. nt-1:
//     U(k) the diagonal tile k: the update by column k-1, then factored
//          and inverted by all 256 threads in T/2 pair-steps, one sync
//          each, on registers (factor_inv); every other tile (i, j),
//          j >= k, updated by column k-1 (SYRK / GEMM), and the right-hand
//          side B[i, j], i >= k, j < k, of the inverse updated by
//          -L[i, k-1] X[k-1, j] (the inverse is built in the same sweep:
//          the forward recurrence in right-looking order, so a row block's
//          column tiles never wait on a long serial chain). With 4 blocks
//          a matrix or more, the diagonal items get blocks of their own;
//     P(k) the panel L[i, k] = A[i, k] Td^T (Td = L[k, k]^{-1}), i > k,
//          and the row X[k, j] = Td B[k, j], j < k.
//   A flagged matrix is filled with NaN after the last barrier.
// 2 nt + 1 barriers a call; the diagonal tile's factor is the serial
// path, so a batch of 1 at 768^2 still keeps dozens of SMs busy on the
// updates. The micro-kernel: each thread holds a (T/16) x (T/16) block of
// the T x T output in registers and reads its operands as 8- or 16-byte
// vectors from k-major shared tiles (rows padded by 16 bytes). Plain FMA
// in the working precision (no TF32). No atomics: every sum has a fixed
// order, and the result is deterministic. Loads of data written in this
// launch bypass L1 (ld.global.cg) and are all issued before their first
// use; the barriers order them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace dotk6 {

constexpr int kThreads = 256;

template <typename Tp>
__device__ __forceinline__ Tp nan_of();
template <>
__device__ __forceinline__ float nan_of<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double nan_of<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// a thread's RM operand values as one vector load
__device__ __forceinline__ void loadv(float (&v)[4], const float* s) {
  const float4 t = *reinterpret_cast<const float4*>(s);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void loadv(float (&v)[2], const float* s) {
  const float2 t = *reinterpret_cast<const float2*>(s);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void loadv(double (&v)[2], const double* s) {
  const double2 t = *reinterpret_cast<const double2*>(s);
  v[0] = t.x; v[1] = t.y;
}

template <typename Tp, int T>
struct Cfg {
  static constexpr int RM = T / 16;                   // outputs/thread/dim
  static constexpr int LDG = T + 16 / int(sizeof(Tp));  // GEMM operand ld
  static constexpr int LDW = T + 1;                   // factor tiles' ld
  static constexpr int EPT = T * T / kThreads;        // elements/thread
  static constexpr int ROWS = kThreads / T;           // rows a pass covers
  static constexpr size_t kSmem =
      (2 * static_cast<size_t>(T) * LDG + static_cast<size_t>(T) * LDW
       + 9 * T) * sizeof(Tp);
  static_assert(RM * sizeof(Tp) == 8 || RM * sizeof(Tp) == 16,
                "8- or 16-byte operand fragments");
};

// v[s] = M[r0 + r, c0 + c] of this thread's elements e = tid + s 256
// (r = e / T, c = e % T), 0 outside n: every load is issued before any
// of them is used
template <typename Tp, int T>
__device__ __forceinline__ void load_tile(Tp (&v)[T * T / kThreads],
                                          const Tp* M, int n, int r0,
                                          int c0) {
#pragma unroll
  for (int s = 0; s < T * T / kThreads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    const int gr = r0 + e / T, gc = c0 + e % T;
    v[s] = (gr < n && gc < n) ? __ldcg(M + static_cast<int64_t>(gr) * n + gc)
                              : Tp(0);
  }
}

// dst[p][r] = M[r0 + r, c0 + p] (k-major, transposed), 0 outside n
template <typename Tp, int T>
__device__ __forceinline__ void load_t(Tp* dst, const Tp* M, int n, int r0,
                                       int c0) {
  using C = Cfg<Tp, T>;
  Tp v[C::EPT];
  load_tile<Tp, T>(v, M, n, r0, c0);
#pragma unroll
  for (int s = 0; s < C::EPT; ++s) {
    const int e = threadIdx.x + s * kThreads;
    dst[(e % T) * C::LDG + e / T] = v[s];
  }
}

// dst[p][c] = M[r0 + p, c0 + c], 0 outside n
template <typename Tp, int T>
__device__ __forceinline__ void load_n(Tp* dst, const Tp* M, int n, int r0,
                                       int c0) {
  using C = Cfg<Tp, T>;
  Tp v[C::EPT];
  load_tile<Tp, T>(v, M, n, r0, c0);
#pragma unroll
  for (int s = 0; s < C::EPT; ++s) {
    const int e = threadIdx.x + s * kThreads;
    dst[(e / T) * C::LDG + e % T] = v[s];
  }
}

// acc[a][b] = sum_p As[p][ty RM + a] Bs[p][tx RM + b]
template <typename Tp, int T>
__device__ __forceinline__ void mma(const Tp* As, const Tp* Bs,
                                    Tp (&acc)[T / 16][T / 16]) {
  using C = Cfg<Tp, T>;
  constexpr int RM = C::RM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RM; ++b) acc[a][b] = Tp(0);
#pragma unroll 8
  for (int p = 0; p < T; ++p) {
    Tp av[RM], bv[RM];
    loadv(av, As + p * C::LDG + ty * RM);
    loadv(bv, Bs + p * C::LDG + tx * RM);
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < RM; ++b) acc[a][b] = fma(av[a], bv[b], acc[a][b]);
  }
}

// The factor and inverse of the diagonal tile W (lower part valid,
// identity on padding), written to L and X at (o, o). Each thread owns
// column j = tid % T of the tile, rows i0 + s ROWS, in registers: w (the
// Schur complement) and y (Y = D L^{-1}, D = diag(l), starting as I).
// Step c: column c of W is final (w_ic = d_c l_ic, d_c^2 = w_cc). The
// columns right of it take the Schur update (l_ic l_jc = w_ic w_jc / w_cc)
// and, in the same pass, the rows of Y below c take the inverse's right-
// looking step -(l_ic / l_cc) Y[c, :] = -(w_ic / w_cc) Y[c, :] (row c is
// final at step c). A thread's column is either right of c (factor) or at
// or left of it (inverse): both updates run on every element with the
// other's coefficient 0, so no thread branches. Steps go in pairs: the
// owners of columns c, c+1 of W and of rows c, c+1 of Y publish them to
// double-buffered shared vectors (cb, rb), and every thread derives column
// c+1 and row c+1 after step c itself, with the same operations the
// owners would use; one sync a pair of columns; one division a step (the
// pivot's reciprocal). dv: the T pivots, then their roots; *bad set on a
// pivot that is not > 0 or a non-finite entry of L.
template <typename Tp, int T>
__device__ void factor_inv(const Tp* W, Tp* cb, Tp* rb, Tp* dv, int* bad,
                           Tp* L, Tp* X, int n, int o) {
  using C = Cfg<Tp, T>;
  constexpr int LD = C::LDW, EPT = C::EPT, ROWS = C::ROWS;
  const int j = threadIdx.x % T, i0 = threadIdx.x / T;
  Tp w[EPT], y[EPT];
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const int i = i0 + s * ROWS;
    w[s] = W[i * LD + j];
    y[s] = Tp(i == j ? 1 : 0);
    if (j < 2) cb[j * T + i] = w[s];
    if (i < 2) rb[i * T + j] = y[s];
  }
  __syncthreads();
  for (int c = 0; c < T; c += 2) {
    const Tp* c0 = cb + ((c >> 1) & 1) * 2 * T;
    const Tp* c1 = c0 + T;
    const Tp* r0 = rb + ((c >> 1) & 1) * 2 * T;
    const Tp* r1 = r0 + T;
    Tp* nc = cb + (((c >> 1) & 1) ^ 1) * 2 * T;
    Tp* nr = rb + (((c >> 1) & 1) ^ 1) * 2 * T;
    const Tp p0 = c0[c], ip0 = Tp(1) / p0;
    const Tp h = c0[c + 1] * ip0;             // column c+1's step-c factor
    const Tp p1 = fma(-c0[c + 1], h, c1[c + 1]), ip1 = Tp(1) / p1;
    if (threadIdx.x == 0) {
      if (!(p0 > Tp(0)) || !(p1 > Tp(0))) *bad = 1;
      dv[c] = p0;
      dv[c + 1] = p1;
    }
    // this column's coefficients at steps c and c+1
    const Tp g0 = r0[j] * ip0;
    const Tp f0 = c0[j] * ip0;
    const Tp f1 = fma(-c0[j], h, c1[j]) * ip1;
    const Tp g1 = fma(-c0[c + 1], g0, r1[j]) * ip1;
    const Tp F0 = j > c ? f0 : Tp(0), G0 = j > c ? Tp(0) : g0;
    const Tp F1 = j > c + 1 ? f1 : Tp(0), G1 = j > c + 1 ? Tp(0) : g1;
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      const int i = i0 + s * ROWS;
      const Tp a0 = c0[i];
      const Tp x0 = i > c ? a0 : Tp(0);
      const Tp x1 = i > c + 1 ? fma(-a0, h, c1[i]) : Tp(0);
      w[s] = fma(-x1, F1, fma(-x0, F0, w[s]));
      y[s] = fma(-x1, G1, fma(-x0, G0, y[s]));
    }
    if (j == c + 2 || j == c + 3) {
#pragma unroll
      for (int s = 0; s < EPT; ++s) nc[(j - c - 2) * T + i0 + s * ROWS] = w[s];
    }
#pragma unroll
    for (int q = 2; q < 4; ++q) {
      const int r = c + q, sr = r / ROWS;
      Tp v = y[0];
#pragma unroll
      for (int s = 1; s < EPT; ++s) v = s == sr ? y[s] : v;
      if (r < T && i0 == r % ROWS) nr[(q - 2) * T + j] = v;
    }
    __syncthreads();
  }
  if (threadIdx.x < T) dv[threadIdx.x] = sqrt(dv[threadIdx.x]);
  __syncthreads();
  bool nonfinite = false;
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const int i = i0 + s * ROWS, gr = o + i, gc = o + j;
    if (gr < n && gc < n) {
      const Tp l = i > j ? w[s] / dv[j] : (i == j ? dv[j] : Tp(0));
      if (!isfinite(l)) nonfinite = true;
      L[static_cast<int64_t>(gr) * n + gc] = l;
      X[static_cast<int64_t>(gr) * n + gc] = y[s] / dv[i];
    }
  }
  if (nonfinite) *bad = 1;
}

// init: L tile (ti, tj) = the lower triangle of A or of (A + A^T)/2, X tile
// = I (diagonal tiles) or 0
template <typename Tp, int T>
__device__ void init_item(const Tp* __restrict__ a, Tp* L, Tp* X, int n,
                          int ti, int tj, int sym, Tp* S) {
  using C = Cfg<Tp, T>;
  const int r0 = ti * T, c0 = tj * T;
  __syncthreads();
  Tp v[C::EPT];
  if (ti >= tj) {
#pragma unroll
    for (int s = 0; s < C::EPT; ++s) {
      const int e = threadIdx.x + s * kThreads;
      const int gr = r0 + e / T, gc = c0 + e % T;
      v[s] = (gr < n && gc < n) ? a[static_cast<int64_t>(gr) * n + gc]
                                : Tp(0);
    }
    if (sym) {   // S[q][p] = A[c0 + q, r0 + p]
      Tp u[C::EPT];
#pragma unroll
      for (int s = 0; s < C::EPT; ++s) {
        const int e = threadIdx.x + s * kThreads;
        const int gr = c0 + e / T, gc = r0 + e % T;
        u[s] = (gr < n && gc < n) ? a[static_cast<int64_t>(gr) * n + gc]
                                  : Tp(0);
      }
#pragma unroll
      for (int s = 0; s < C::EPT; ++s) {
        const int e = threadIdx.x + s * kThreads;
        S[(e / T) * C::LDW + e % T] = u[s];
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int s = 0; s < C::EPT; ++s) {
    const int e = threadIdx.x + s * kThreads;
    const int r = e / T, c = e % T, gr = r0 + r, gc = c0 + c;
    if (gr >= n || gc >= n) continue;
    const int64_t o = static_cast<int64_t>(gr) * n + gc;
    Tp l = Tp(0);
    if (gr >= gc) l = sym ? (v[s] + S[c * C::LDW + r]) / Tp(2) : v[s];
    L[o] = l;
    X[o] = Tp(gr == gc ? 1 : 0);
  }
}

// U(k)'s diagonal item: A[k, k] - L[k, k-1] L[k, k-1]^T, factored and
// inverted; L[k, k] and Td = L[k, k]^{-1} (into X[k, k]) written
template <typename Tp, int T>
__device__ void diag_item(Tp* L, Tp* X, int n, int k, Tp* As, Tp* W, Tp* cb,
                          Tp* rb, Tp* dv, int* bad, int* info_b) {
  using C = Cfg<Tp, T>;
  constexpr int RM = C::RM, LD = C::LDW;
  const int o = k * T;
  __syncthreads();
  if (threadIdx.x == 0) *bad = 0;
  if (k > 0) {
    load_t<Tp, T>(As, L, n, o, o - T);
    __syncthreads();
    Tp acc[RM][RM];
    mma<Tp, T>(As, As, acc);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    Tp cur[RM][RM];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < RM; ++b) {
        const int gr = o + ty * RM + a, gc = o + tx * RM + b;
        cur[a][b] = (gr < n && gc < n)
                        ? __ldcg(L + static_cast<int64_t>(gr) * n + gc)
                        : Tp(0);
      }
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < RM; ++b) {
        const int r = ty * RM + a, c = tx * RM + b;
        W[r * LD + c] = (o + r < n && o + c < n) ? cur[a][b] - acc[a][b]
                                                 : Tp(r == c ? 1 : 0);
      }
  } else {
    Tp v[C::EPT];
    load_tile<Tp, T>(v, L, n, 0, 0);
#pragma unroll
    for (int s = 0; s < C::EPT; ++s) {
      const int e = threadIdx.x + s * kThreads;
      const int r = e / T, c = e % T;
      W[r * LD + c] = (r < n && c < n) ? v[s] : Tp(r == c ? 1 : 0);
    }
  }
  __syncthreads();
  factor_inv<Tp, T>(W, cb, rb, dv, bad, L, X, n, o);
  __syncthreads();
  if (threadIdx.x == 0 && *bad) *info_b = 1;
}

// the GEMM items: out tile (oi, oj) of M gets `mode`:
//   0  M -= A B^T-form product, lower entries only (trailing SYRK/GEMM)
//   1  M -= product (the inverse's right-hand side)
//   2  M = product, non-finite entries flag the matrix (the panel)
//   3  M = product (the inverse's row)
template <typename Tp, int T>
__device__ void gemm_item(const Tp* As, const Tp* Bs, Tp* M, int n, int oi,
                          int oj, int mode, int* bad, int* info_b) {
  using C = Cfg<Tp, T>;
  constexpr int RM = C::RM;
  __syncthreads();
  Tp acc[RM][RM];
  mma<Tp, T>(As, Bs, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  bool nonfinite = false;
  if (mode <= 1) {   // every load issued before the first store
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < RM; ++b) {
        const int gr = oi * T + ty * RM + a, gc = oj * T + tx * RM + b;
        acc[a][b] = (gr < n && gc < n)
                        ? __ldcg(M + static_cast<int64_t>(gr) * n + gc)
                              - acc[a][b]
                        : Tp(0);
      }
  }
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RM; ++b) {
      const int gr = oi * T + ty * RM + a, gc = oj * T + tx * RM + b;
      if (gr >= n || gc >= n || (mode == 0 && gr < gc)) continue;
      M[static_cast<int64_t>(gr) * n + gc] = acc[a][b];
      if (mode == 2 && !isfinite(acc[a][b])) nonfinite = true;
    }
  if (mode == 2) {
    if (threadIdx.x == 0) *bad = 0;
    __syncthreads();
    if (nonfinite) *bad = 1;
    __syncthreads();
    if (threadIdx.x == 0 && *bad) *info_b = 1;
  }
}

// (ii, jj), ii >= jj, of the t-th entry of a lower triangle, row by row
__device__ __forceinline__ void tri_index(int t, int& ii, int& jj) {
  ii = static_cast<int>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while (ii * (ii + 1) / 2 > t) --ii;
  while ((ii + 1) * (ii + 2) / 2 <= t) ++ii;
  jj = t - ii * (ii + 1) / 2;
}

template <typename Tp, int T>
__global__ void __launch_bounds__(kThreads, 2)
chol_inv_kernel(const Tp* __restrict__ A, int n, long long batch, int sym,
                Tp* Lg, Tp* Xg, int* info) {
  using C = Cfg<Tp, T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int bad;
  Tp* As = reinterpret_cast<Tp*>(smem_raw);
  Tp* Bs = As + T * C::LDG;
  Tp* W = Bs + T * C::LDG;
  Tp* cb = W + T * C::LDW;      // 2 x 2 x T: columns c, c+1 of W
  Tp* rb = cb + 4 * T;          // 2 x 2 x T: rows c, c+1 of Y
  Tp* dv = rb + 4 * T;
  cg::grid_group grid = cg::this_grid();
  const int nt = (n + T - 1) / T;
  const int64_t nn = static_cast<int64_t>(n) * n;

  // init: every tile of every matrix
  const int64_t n0 = batch * nt * nt;
  for (int64_t g = blockIdx.x; g < n0; g += gridDim.x) {
    const int64_t b = g % batch;
    const int t = static_cast<int>(g / batch);
    if (t == 0 && threadIdx.x == 0) info[b] = 0;
    init_item<Tp, T>(A + b * nn, Lg + b * nn, Xg + b * nn, n, t / nt, t % nt,
                     sym, W);
  }
  grid.sync();

  for (int k = 0; k < nt; ++k) {
    const int m = nt - k;
    const int tri = m * (m + 1) / 2;
    // U(k): the diagonal items first (the serial path), then the updates
    // by column k-1 of the trailing tiles and of the inverse's rows >= k
    // when the grid holds 4 blocks a matrix or more, blocks 0 .. batch-1
    // take the diagonal items alone (the serial path) and the others share
    // the rest; with fewer, every block takes its share of all items
    const int64_t nu = batch * (k > 0 ? tri + m * k : 1);
    const int64_t gs = gridDim.x < 4 * batch ? gridDim.x
                       : (blockIdx.x < batch ? nu : gridDim.x - batch);
    for (int64_t g = blockIdx.x; g < nu; g += gs) {
      const int64_t b = g % batch;
      const int t = static_cast<int>(g / batch);
      Tp* L = Lg + b * nn;
      Tp* X = Xg + b * nn;
      if (t == 0) {
        diag_item<Tp, T>(L, X, n, k, As, W, cb, rb, dv, &bad, info + b);
      } else if (t < tri) {
        int ii, jj;
        tri_index(t, ii, jj);
        __syncthreads();
        load_t<Tp, T>(As, L, n, (k + ii) * T, (k - 1) * T);
        load_t<Tp, T>(Bs, L, n, (k + jj) * T, (k - 1) * T);
        gemm_item<Tp, T>(As, Bs, L, n, k + ii, k + jj, 0, &bad, info + b);
      } else {
        const int r = t - tri, i = k + r / k, j = r % k;
        __syncthreads();
        load_t<Tp, T>(As, L, n, i * T, (k - 1) * T);
        load_n<Tp, T>(Bs, X, n, (k - 1) * T, j * T);
        gemm_item<Tp, T>(As, Bs, X, n, i, j, 1, &bad, info + b);
      }
    }
    grid.sync();
    // P(k): the panel below the diagonal tile and the inverse's row k
    const int64_t np = batch * (nt - 1);
    for (int64_t g = blockIdx.x; g < np; g += gridDim.x) {
      const int64_t b = g % batch;
      const int t = static_cast<int>(g / batch);
      Tp* L = Lg + b * nn;
      Tp* X = Xg + b * nn;
      __syncthreads();
      if (t < m - 1) {
        const int i = k + 1 + t;
        load_t<Tp, T>(As, L, n, i * T, k * T);
        load_t<Tp, T>(Bs, X, n, k * T, k * T);   // Bs[p][c] = Td[c][p]
        gemm_item<Tp, T>(As, Bs, L, n, i, k, 2, &bad, info + b);
      } else {
        const int j = t - (m - 1);
        load_t<Tp, T>(As, X, n, k * T, k * T);   // As[p][r] = Td[r][p]
        load_n<Tp, T>(Bs, X, n, k * T, j * T);
        gemm_item<Tp, T>(As, Bs, X, n, k, j, 3, &bad, info + b);
      }
    }
    grid.sync();
  }

  // a flagged matrix: L and L^{-1} all NaN
  const Tp nanv = nan_of<Tp>();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t b = 0; b < batch; ++b) {
    if (!__ldcg(info + b)) continue;
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads
                     + threadIdx.x;
         e < nn; e += stride) {
      Lg[b * nn + e] = nanv;
      Xg[b * nn + e] = nanv;
    }
  }
}

// the grid: every co-resident block (occupancy at 256 threads and the
// tile's shared memory, times the SMs), at most one per init item
template <typename Tp, int T>
int launch(const void* A, int n, long long batch, int sym, void* L, void* X,
           int* info, cudaStream_t s) {
  using C = Cfg<Tp, T>;
  if (batch == 0 || n == 0) return 0;
  auto kern = chol_inv_kernel<Tp, T>;
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
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return -3;
    per_sm_of[dev] = per_sm;
  }
  const long long nt = (n + T - 1) / T;
  const long long items = batch * nt * nt;
  const long long most = static_cast<long long>(per_sm_of[dev]) * sms_of[dev];
  const unsigned grid =
      static_cast<unsigned>(items < most ? items : most);
  const Tp* a = static_cast<const Tp*>(A);
  Tp* l = static_cast<Tp*>(L);
  Tp* x = static_cast<Tp*>(X);
  void* args[] = {&a, &n, &batch, &sym, &l, &x, &info};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(grid), dim3(kThreads), args, C::kSmem,
                                  s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk6

// dtype: 0 f32, 1 f64; tile: 64 or 32 in f32, 32 in f64. Returns 0, a
// CUDA error code, -2 when the device has no cooperative launch, -3 when
// no block fits on an SM, -4 for a device ordinal beyond the cache, -6 for
// a tile width the dtype does not take.
extern "C" int dot_chol_inv(int dtype, int tile, const void* A, int n,
                            long long batch, int sym, void* L, void* X,
                            void* info, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto inf = static_cast<int*>(info);
  if (dtype == 0 && tile == 64)
    return dotk6::launch<float, 64>(A, n, batch, sym, L, X, inf, s);
  if (dtype == 0 && tile == 32)
    return dotk6::launch<float, 32>(A, n, batch, sym, L, X, inf, s);
  if (dtype == 1 && tile == 32)
    return dotk6::launch<double, 32>(A, n, batch, sym, L, X, inf, s);
  return -6;
}
