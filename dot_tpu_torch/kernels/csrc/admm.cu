// K17, K18, K20: the kernels of the two ADMM steppers that are not entry
// points of an earlier source, with a plain C interface (loaded through
// ctypes by ops.py). Built with -fmad=false, like elem.cu, so that products
// and sums round as the plain PyTorch versions' elementwise ops do and the
// data-dependent stop tests of K17 take the same branch.
//
// K17 admm_local_step -- replaces dot_tpu/steppers/admm.py:142-213
//   (_local_step with _solve_sym3, :50) and the make_pd3_soa inside it
//   (dot_tpu/kernels/soa.py:263): per element, flip-SVD of Dx + u, a
//   projected Newton on the three singular values (sigma-space psi, dpsi,
//   SPD-clamped d2psi, scaled by vol dt^2, plus the ADMM weight; adjugate
//   solve; energy line search that halves at most 40 times; stop on
//   |dE / E0| < 1e-3 alpha or after 100 iterations), then
//   z = U diag(sigma) V^T and du = Dx - z.
//   Bound on the H100: it reads 2 x 9 + 4 and writes 2 x 9 values per
//   element (160 B in f32, 13.8 MB at bar17's 86,016 tets: 4 us at
//   3.35 TB/s); the work is one flip-SVD (~600 dependent flops) and, per
//   Newton iteration, a 3x3 Jacobi eigendecomposition (~4 sweeps x 3
//   rotations) and 1 + halvings energy evaluations: operations, not bytes,
//   set its time, and the count depends on the data.
//   Design: one thread per element; everything stays in registers; each
//   thread runs its Newton and line-search loops to its own exit. That
//   equals dot_tpu's lockstep masked loops: there an element's alpha halves
//   only while its own trial energy exceeds its start and a converged
//   element keeps its sigma, so the global `any` only sets how long the
//   others idle. A NaN energy is accepted (e > e0 is false) and ends the
//   element's loop, as there.
// K18 dtw_scatter -- replaces dot_tpu/steppers/admm.py:216-240 (_apply_A,
//   _scatter) and the rhs of :288-295: D^T (w M) per corner, summed per
//   vertex over the (element, corner) incidences sorted by vertex, then one
//   of two per-vertex epilogues.
//   Bound: memory. Each incidence reads w, 3 entries of M and 3 (9 for
//   corner 0) of restTriInv: 4 x 86K incidences x 3 coordinates x ~28-52 B
//   at bar17, ~40 MB of (L2-resident) gathers in f32, ~12 us.
//   Design: one thread per (vertex, coordinate) walks the vertex's run of
//   the sorted incidence list (the CSR offsets K13 uses) and adds each
//   corner's sum_j D[c][j] (w M[i][j]) in that order: the plain version's
//   sequential index_add_. No atomics: the result is the right-hand side
//   of the global solve, and the Dirichlet offsets.
// K20 w_matvec -- replaces dot_tpu/steppers/admm_dd.py:213-252 (_w_masked,
//   w_matvec, w_diag, _md3f): y = W a for ADMM-DD's compact
//   interface-weight operator, masked to free rows and columns, plus the
//   masked mass-diff diagonal; with diag_only the operator's diagonal.
//   Bound: memory, and small: nUW entries (value, column, a[col],
//   free[col]) + 4 vectors of P n3; at bar17 with 6 parts ~0.4M entries,
//   ~10 MB, 3 us: a launch costs more.
//   Design: CSR by row (the entries arrive sorted by row; offsets built
//   once on the host); one thread per row sums its entries in order, so
//   the line search's a0c, a1c, a2c are the same from run to run.
// K20 w_quad -- replaces the line search's setup of
//   dot_tpu/steppers/admm_dd.py:524-529: W aug0 and W pa and the per-part
//   quadratic terms a0c = aug0.W aug0 / 2, a1c = (pa.W aug0 + aug0.W pa)
//   / 2, a2c = pa.W pa / 2, (3, P), in ONE cooperative launch (the two
//   w_matvec launches and the four sums and products they fed: ~12
//   launches a line search).
//   Bound: memory, and small: the nUW entries once (value, column, and the
//   two gathered columns) for both products + 4 vectors of P n3; at bar17
//   with 6 parts ~10 MB, ~3 us. Launches cost more.
//   Design: items of 64 rows of one part (a part's rows in fixed chunks),
//   grid-strided over the co-resident blocks; four lanes a row, each
//   summing every 4th entry in order for both columns at once (each W
//   entry read once; the rows' gathers are latency-bound, and an
//   interface row holds tens of entries), a fixed xor tree over the four;
//   the row's four products into its first lane's partials, and a fixed
//   shuffle tree plus the warps in order give the item's four sums; after
//   a grid barrier a warp a part adds its chunks (lanes in order, then a
//   fixed tree). No atomics: two runs give the same bits, and the grid
//   size changes no sum.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "elem.cuh"

namespace cg = cooperative_groups;

namespace dotadmm {

using dotk::Mat;
using dotk::Num;

constexpr int kThreads = 128;
constexpr int kRowThreads = 256;
constexpr int kLocalMaxIter = 100;   // ADMMTimeStepper.cpp:385
constexpr int kLocalLsCap = 40;

// SPD projection of a packed symmetric 3x3 (00, 01, 02, 11, 12, 22) by
// eigenvalue clamping (make_pd3_soa)
template <typename T>
__device__ __forceinline__ void make_pd3(const T a[6], T out[6]) {
  T w[3], Q[9];
  dotk::jacobi_eigh(a, w, Q);
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = dotk::cl0(w[k]);
  int o = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j)
      out[o++] = w[0] * Q[3 * i] * Q[3 * j] + w[1] * Q[3 * i + 1] * Q[3 * j + 1]
               + w[2] * Q[3 * i + 2] * Q[3 * j + 2];
}

// H p = g for SPD H (00, 01, 02, 11, 12, 22) by the adjugate
template <typename T>
__device__ __forceinline__ void solve_sym3(const T h[6], const T g[3], T p[3]) {
  const T a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5];
  const T det = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d);
  const T inv_det = T(1) / det;
  const T i00 = (d * f - e * e) * inv_det;
  const T i01 = (c * e - b * f) * inv_det;
  const T i02 = (b * e - c * d) * inv_det;
  const T i11 = (a * f - c * c) * inv_det;
  const T i12 = (b * c - a * e) * inv_det;
  const T i22 = (a * d - b * b) * inv_det;
  p[0] = i00 * g[0] + i01 * g[1] + i02 * g[2];
  p[1] = i01 * g[0] + i11 * g[1] + i12 * g[2];
  p[2] = i02 * g[0] + i12 * g[1] + i22 * g[2];
}

template <typename T, int M>
__device__ __forceinline__ T local_energy(const T s[3], const T s_hat[3], T mu,
                                          T lam, T vd, T w) {
  const T d0 = s_hat[0] - s[0], d1 = s_hat[1] - s[1], d2 = s_hat[2] - s[2];
  return Mat<T, M>::psi(s, mu, lam) * vd
       + T(0.5) * w * (d0 * d0 + d1 * d1 + d2 * d2);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
admm_local_step_kernel(const T* __restrict__ Dx, const T* __restrict__ u9,
                       const T* __restrict__ w_e, const T* __restrict__ vol_dtsq,
                       const T* __restrict__ mu_e, const T* __restrict__ lam_e,
                       int n, T* __restrict__ z_out, T* __restrict__ du_out,
                       int* __restrict__ counts) {
  const int e_id = blockIdx.x * kThreads + threadIdx.x;
  if (e_id >= n) return;
  T dxu[9], U[9], s_hat[3], V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) dxu[k] = Dx[k * n + e_id] + u9[k * n + e_id];
  dotk::svd3_flip(dxu, U, s_hat, V);
  const T w = w_e[e_id], vd = vol_dtsq[e_id], mu = mu_e[e_id], lam = lam_e[e_id];

  T s[3] = {s_hat[0], s_hat[1], s_hat[2]};
  T e0 = local_energy<T, M>(s, s_hat, mu, lam, vd, w);
  bool active = true;
  int n_it = 0, n_ev = 1;   // Newton iterations, energy evaluations
  for (int it = 0; it < kLocalMaxIter && active; ++it) {
    T g[3], a6[6], h[6], ng[3], p[3], st[3];
    Mat<T, M>::dpsi(s, mu, lam, g);
#pragma unroll
    for (int i = 0; i < 3; ++i) ng[i] = -(g[i] * vd - w * (s_hat[i] - s[i]));
    Mat<T, M>::d2psi(s, mu, lam, a6);
    make_pd3(a6, h);
#pragma unroll
    for (int k = 0; k < 6; ++k) h[k] = h[k] * vd;
    h[0] = h[0] + w;
    h[3] = h[3] + w;
    h[5] = h[5] + w;
    solve_sym3(h, ng, p);

    T alpha = T(1);
#pragma unroll
    for (int i = 0; i < 3; ++i) st[i] = s[i] + p[i];
    T e = local_energy<T, M>(st, s_hat, mu, lam, vd, w);
    ++n_it;
    ++n_ev;
    for (int k = 0; k < kLocalLsCap && e > e0; ++k) {
      alpha = alpha * T(0.5);
#pragma unroll
      for (int i = 0; i < 3; ++i) st[i] = s[i] + alpha * p[i];
      e = local_energy<T, M>(st, s_hat, mu, lam, vd, w);
      ++n_ev;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i] = s[i] + alpha * p[i];
    // local convergence: |(E0 - E) / E0| < 1e-3 alpha
    const T den = e0 == T(0) ? T(1) : e0;
    active = fabs((e0 - e) / den) >= T(1.0e-3) * alpha;
    e0 = e;
  }
  if (counts != nullptr) {
    counts[e_id] = n_it;
    counts[n + e_id] = n_ev;
  }

#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = 3 * i + j;
      const T zk = U[3 * i] * s[0] * V[3 * j] + U[3 * i + 1] * s[1] * V[3 * j + 1]
                 + U[3 * i + 2] * s[2] * V[3 * j + 2];
      const T uk = u9[k * n + e_id];
      z_out[k * n + e_id] = zk;
      du_out[k * n + e_id] = dxu[k] - uk - zk;       // Dx - z
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
make_pd3_kernel(const T* __restrict__ a6, int n, T* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  T a[6], o[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = a6[k * n + e];
  make_pd3(a, o);
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * n + e] = o[k];
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
dtw_scatter_kernel(const T* __restrict__ M9, const T* __restrict__ g9,
                   const T* __restrict__ w_e, int64_t n,
                   const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ seg_off, int64_t n_vert,
                   const T* __restrict__ x, const T* __restrict__ mass,
                   const T* __restrict__ base, const T* __restrict__ offset,
                   const T* __restrict__ free_v, T* __restrict__ out) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kRowThreads) + threadIdx.x;
  if (t >= n_vert * 3) return;
  const int64_t v = t / 3;
  const int i = static_cast<int>(t - v * 3);
  T s = T(0);
  const int64_t end = seg_off[v + 1];
  for (int64_t k = seg_off[v]; k < end; ++k) {
    const int64_t item = perm[k];          // element * 4 + corner
    const int64_t e = item >> 2;
    const int c = static_cast<int>(item & 3);
    T D[3];
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        D[j] = -(g9[j * n + e] + g9[(3 + j) * n + e] + g9[(6 + j) * n + e]);
    } else {
#pragma unroll
      for (int j = 0; j < 3; ++j) D[j] = g9[(3 * (c - 1) + j) * n + e];
    }
    const T w = w_e[e];
    s += D[0] * (w * M9[(3 * i) * n + e]) + D[1] * (w * M9[(3 * i + 1) * n + e])
       + D[2] * (w * M9[(3 * i + 2) * n + e]);
  }
  if (mass != nullptr) {
    out[t] = s + mass[v] * x[t];
  } else {
    const T fr = free_v[v];
    out[t] = (base[t] + s - offset[t]) * fr + x[t] * (T(1) - fr);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
w_matvec_kernel(const T* __restrict__ w_vals, const T* __restrict__ free3f,
                const T* __restrict__ a, const int64_t* __restrict__ col,
                const int64_t* __restrict__ row_off, const T* __restrict__ md3,
                int64_t n_rows, int diag_only, T* __restrict__ out) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(kRowThreads) + threadIdx.x;
  if (r >= n_rows) return;
  const T fr = free3f[r];
  T y = T(0);
  const int64_t end = row_off[r + 1];
  for (int64_t k = row_off[r]; k < end; ++k) {
    const int64_t c = col[k];
    const T wm = w_vals[k] * fr * free3f[c];
    y += diag_only ? wm * (c == r ? T(1) : T(0)) : wm * a[c];
  }
  const T md = md3[r] * fr;
  out[r] = diag_only ? y + md : y + md * a[r];
}

// the K20 line-search entry. Stage 1: item = part p's rows [ch rows_per,
// (ch + 1) rows_per), four lanes a row (kLanesRow): lane u of a row sums
// its entries u, u + 4, ... in order for both columns, a fixed xor tree
// adds the four, and the row's first lane adds the row's four products to
// its partials; the item's four sums by a fixed shuffle tree and the
// warps in order. Stage 2 (after the grid barrier): a warp a part, lane l
// adding chunks l, l + 32, ... in order, then a fixed shuffle tree.
constexpr int kLanesRow = 4;

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
w_quad_kernel(const T* __restrict__ w_vals, const T* __restrict__ free3f,
              const T* __restrict__ aug0, const T* __restrict__ pa,
              const int64_t* __restrict__ col,
              const int64_t* __restrict__ row_off, const T* __restrict__ md3,
              int64_t n3, int n_parts, int chunks, T* part, T* out) {
  constexpr int kWarpsQ = kRowThreads / 32;
  constexpr int kRowsPass = kRowThreads / kLanesRow;
  __shared__ T red[4][kWarpsQ];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = threadIdx.x % kLanesRow;
  const int64_t rows_per = (n3 + chunks - 1) / chunks;
  const int64_t items = static_cast<int64_t>(n_parts) * chunks;
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
    const int64_t p = it / chunks, ch = it - p * chunks;
    const int64_t r1 = p * n3 + (ch * rows_per + rows_per < n3
                                     ? ch * rows_per + rows_per : n3);
    T s[4] = {T(0), T(0), T(0), T(0)};
    // the pass's condition is the block's: every lane reaches the shuffles
    for (int64_t r0 = p * n3 + ch * rows_per; r0 < r1; r0 += kRowsPass) {
      const int64_t r = r0 + threadIdx.x / kLanesRow;
      const bool on = r < r1;
      T fr = T(0), y0 = T(0), y1 = T(0);
      if (on) {
        fr = free3f[r];
        const int64_t end = row_off[r + 1];
        int64_t k = row_off[r] + sub;
        for (; k + kLanesRow < end; k += 2 * kLanesRow) {
          const int64_t c0 = col[k], c1 = col[k + kLanesRow];
          const T w0 = w_vals[k] * fr * free3f[c0];
          const T w1 = w_vals[k + kLanesRow] * fr * free3f[c1];
          const T a0 = aug0[c0], a1 = aug0[c1], q0 = pa[c0], q1 = pa[c1];
          y0 += w0 * a0;
          y1 += w0 * q0;
          y0 += w1 * a1;
          y1 += w1 * q1;
        }
        if (k < end) {
          const int64_t c = col[k];
          const T wm = w_vals[k] * fr * free3f[c];
          y0 += wm * aug0[c];
          y1 += wm * pa[c];
        }
      }
#pragma unroll
      for (int o = 1; o < kLanesRow; o <<= 1) {
        y0 += __shfl_xor_sync(0xffffffffu, y0, o);
        y1 += __shfl_xor_sync(0xffffffffu, y1, o);
      }
      if (on && sub == 0) {
        const T md = md3[r] * fr;
        const T a = aug0[r], q = pa[r];
        const T wa = y0 + md * a;          // (W aug0)[r]
        const T wq = y1 + md * q;          // (W pa)[r]
        s[0] += a * wa;
        s[1] += q * wa;
        s[2] += a * wq;
        s[3] += q * wq;
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[m] += __shfl_xor_sync(0xffffffffu, s[m], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m) red[m][warp] = s[m];
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      T t = red[threadIdx.x][0];
#pragma unroll
      for (int w = 1; w < kWarpsQ; ++w) t += red[threadIdx.x][w];
      part[it * 4 + threadIdx.x] = t;
    }
    __syncthreads();               // red is written again by the next item
  }
  grid.sync();
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kWarpsQ + warp;
       p < n_parts; p += static_cast<int64_t>(gridDim.x) * kWarpsQ) {
    T t[4] = {T(0), T(0), T(0), T(0)};
    for (int ch = lane; ch < chunks; ch += 32) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        t[m] += __ldcg(part + (p * chunks + ch) * 4 + m);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        t[m] += __shfl_xor_sync(0xffffffffu, t[m], o);
    }
    if (lane == 0) {
      out[p] = T(0.5) * t[0];
      out[n_parts + p] = T(0.5) * (t[1] + t[2]);
      out[2 * n_parts + p] = T(0.5) * t[3];
    }
  }
}

// w_quad's cooperative launch: the co-resident blocks, at most one an item
template <typename T>
int launch_w_quad(const void* w_vals, const void* free3f, const void* aug0,
                  const void* pa, const int64_t* col, const int64_t* row_off,
                  const void* md3, long long n3, int n_parts, int chunks,
                  void* part, void* out, cudaStream_t st) {
  auto kern = w_quad_kernel<T>;
  constexpr int kMaxDev = 64;
  static int most_of[kMaxDev] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDev) return -4;
  if (most_of[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop) return -2;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kRowThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return -3;
    most_of[dev] = per_sm * sms;
  }
  const long long items = static_cast<long long>(n_parts) * chunks;
  const unsigned nb = static_cast<unsigned>(items < most_of[dev]
                                                ? items : most_of[dev]);
  auto wv = static_cast<const T*>(w_vals);
  auto fr = static_cast<const T*>(free3f);
  auto a0 = static_cast<const T*>(aug0);
  auto pp = static_cast<const T*>(pa);
  auto md = static_cast<const T*>(md3);
  auto pt = static_cast<T*>(part);
  auto o = static_cast<T*>(out);
  int64_t n3v = n3;
  void* args[] = {&wv, &fr, &a0, &pp, &col, &row_off, &md, &n3v, &n_parts,
                  &chunks, &pt, &o};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(nb), dim3(kRowThreads), args, 0, st);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a refused launch: not left for the next check
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

inline unsigned blocks(int64_t n, int t) {
  return static_cast<unsigned>((n + t - 1) / t);
}

template <typename T, int M>
void launch_local(const void* Dx, const void* u9, const void* w, const void* vd,
                  const void* mu, const void* lam, int n, void* z, void* du,
                  int* counts, cudaStream_t st) {
  admm_local_step_kernel<T, M><<<blocks(n, kThreads), kThreads, 0, st>>>(
      (const T*)Dx, (const T*)u9, (const T*)w, (const T*)vd, (const T*)mu,
      (const T*)lam, n, (T*)z, (T*)du, counts);
}

}  // namespace dotadmm

extern "C" {

// dtype: 0 float32, 1 float64; mat: 0 FCR, 1 SNH, 2 SNHWL. Dx, u9, z, du:
// (9, n); w, vol_dtsq, mu, lam: (n,); counts: null, or (2, n) int32 that
// receives each element's Newton iterations and energy evaluations.
int dot_admm_local_step(int dtype, int mat, const void* Dx, const void* u9,
                        const void* w, const void* vol_dtsq, const void* mu,
                        const void* lam, int n, void* z, void* du,
                        void* counts, void* stream) {
  if (n == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto ct = static_cast<int*>(counts);
#define DOT_LOCAL(T)                                                         \
  if (mat == 0) dotadmm::launch_local<T, dotk::FCR>(Dx, u9, w, vol_dtsq, mu, \
                                                    lam, n, z, du, ct, st);  \
  else if (mat == 1) dotadmm::launch_local<T, dotk::SNH>(                    \
      Dx, u9, w, vol_dtsq, mu, lam, n, z, du, ct, st);                       \
  else if (mat == 2) dotadmm::launch_local<T, dotk::SNHWL>(                  \
      Dx, u9, w, vol_dtsq, mu, lam, n, z, du, ct, st);                       \
  else return 1;
  if (dtype == 0) { DOT_LOCAL(float) }
  else if (dtype == 1) { DOT_LOCAL(double) }
  else return 1;
#undef DOT_LOCAL
  return static_cast<int>(cudaGetLastError());
}

// a6, out: (6, n) packed symmetric 3x3 matrices.
int dot_make_pd3(int dtype, const void* a6, int n, void* out, void* stream) {
  if (n == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned nb = dotadmm::blocks(n, dotadmm::kThreads);
  if (dtype == 0)
    dotadmm::make_pd3_kernel<float><<<nb, dotadmm::kThreads, 0, st>>>(
        static_cast<const float*>(a6), n, static_cast<float*>(out));
  else
    dotadmm::make_pd3_kernel<double><<<nb, dotadmm::kThreads, 0, st>>>(
        static_cast<const double*>(a6), n, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// M9, g9: (9, n); w: (n,); perm: incidences e*4+c sorted by vertex;
// seg_off (n_vert + 2,) their CSR offsets; x, base, offset, out:
// (n_vert, 3); mass, free: (n_vert,). mass != null: out = s + mass x;
// else out = (base + s - offset) free + x (1 - free).
int dot_dtw_scatter(int dtype, const void* M9, const void* g9, const void* w,
                    long long n, const void* perm, const void* seg_off,
                    long long n_vert, const void* x, const void* mass,
                    const void* base, const void* offset, const void* free_v,
                    void* out, void* stream) {
  if (n_vert == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<const int64_t*>(perm);
  auto so = static_cast<const int64_t*>(seg_off);
  const unsigned nb = dotadmm::blocks(n_vert * 3, dotadmm::kRowThreads);
#define DOT_DTW(T)                                                            \
  dotadmm::dtw_scatter_kernel<T><<<nb, dotadmm::kRowThreads, 0, st>>>(        \
      static_cast<const T*>(M9), static_cast<const T*>(g9),                   \
      static_cast<const T*>(w), n, pm, so, n_vert, static_cast<const T*>(x),  \
      static_cast<const T*>(mass), static_cast<const T*>(base),               \
      static_cast<const T*>(offset), static_cast<const T*>(free_v),           \
      static_cast<T*>(out));
  if (dtype == 0) { DOT_DTW(float) } else { DOT_DTW(double) }
#undef DOT_DTW
  return static_cast<int>(cudaGetLastError());
}

// w_vals (nUW,), col (nUW,) sorted by row, row_off (n_rows + 1,); free3f, a,
// md3, out: (n_rows,). diag_only: a is not read.
int dot_w_matvec(int dtype, const void* w_vals, const void* free3f,
                 const void* a, const void* col, const void* row_off,
                 const void* md3, long long n_rows, int diag_only, void* out,
                 void* stream) {
  if (n_rows == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto cl = static_cast<const int64_t*>(col);
  auto ro = static_cast<const int64_t*>(row_off);
  const unsigned nb = dotadmm::blocks(n_rows, dotadmm::kRowThreads);
  if (dtype == 0)
    dotadmm::w_matvec_kernel<float><<<nb, dotadmm::kRowThreads, 0, st>>>(
        static_cast<const float*>(w_vals), static_cast<const float*>(free3f),
        static_cast<const float*>(a), cl, ro, static_cast<const float*>(md3),
        n_rows, diag_only, static_cast<float*>(out));
  else
    dotadmm::w_matvec_kernel<double><<<nb, dotadmm::kRowThreads, 0, st>>>(
        static_cast<const double*>(w_vals), static_cast<const double*>(free3f),
        static_cast<const double*>(a), cl, ro, static_cast<const double*>(md3),
        n_rows, diag_only, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K20's line-search entry: w_vals (nUW,), col, row_off as dot_w_matvec;
// free3f, aug0, pa, md3: (n_parts n3,); part: (n_parts chunks 4,)
// scratch; out (3, n_parts): a0c, a1c, a2c. Cooperative; returns 0, a
// CUDA error code, or -2 / -3 / -4 as dot_block_solve.
int dot_w_quad(int dtype, const void* w_vals, const void* free3f,
               const void* aug0, const void* pa, const void* col,
               const void* row_off, const void* md3, long long n3,
               int n_parts, int chunks, void* part, void* out,
               void* stream) {
  if (n_parts <= 0) return 0;
  if (n3 <= 0 || chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto cl = static_cast<const int64_t*>(col);
  auto ro = static_cast<const int64_t*>(row_off);
  if (dtype == 0)
    return dotadmm::launch_w_quad<float>(w_vals, free3f, aug0, pa, cl, ro,
                                         md3, n3, n_parts, chunks, part, out,
                                         st);
  return dotadmm::launch_w_quad<double>(w_vals, free3f, aug0, pa, cl, ro, md3,
                                        n3, n_parts, chunks, part, out, st);
}

}  // extern "C"
