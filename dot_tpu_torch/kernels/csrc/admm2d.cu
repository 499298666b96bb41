// K29, K30: the kernels of 2D ADMM-PD, with a plain C interface (loaded
// through ctypes by ops.py). The plain PyTorch versions are in
// kernels/admm2d.py. Built with -fmad=false, like elem2d.cu, so that products
// and sums round as the plain versions' elementwise ops do and the
// data-dependent stop tests of K29 take the same branch (up to the device
// library's atan2 / sin / cos inside the flip-SVD: see elem2d.cuh).
//
// K29 admm_local_step2d -- replaces dot_tpu/steppers/admm.py:142-213
//   (_local_step) at DIM = 2 with dot_tpu/dim2.py:780-821's hooks
//   (svd2_flip_soa, make_pd2_soa, _solve_sym2 at admm.py:66, _z_usv): per
//   triangle, flip-SVD of Dx + u, a projected Newton on the two singular
//   values (sigma-space psi, dpsi, SPD-clamped d2psi, scaled by area dt^2,
//   plus the ADMM weight; 2x2 adjugate solve; energy line search that halves
//   at most 40 times; stop on |dE / E0| < 1e-3 alpha or after 100
//   iterations), then z = U diag(sigma) V^T and du = Dx - z.
//   Bound on the H100: it reads 2 x 4 + 4 and writes 2 x 4 values per
//   triangle (80 B in f32, 1.6 MB at 19,873 triangles: 0.5 us at 3.35 TB/s);
//   the work is one flip-SVD (two atan2, two sincos) and, per Newton
//   iteration, a 2x2 eigendecomposition (one atan2, one sincos) and 1 +
//   halvings energy evaluations: operations, not bytes, set its time, and
//   their count depends on the data.
//   Design: K17's. One thread per triangle; everything stays in registers;
//   each thread runs its Newton and line-search loops to its own exit. That
//   equals dot_tpu's lockstep masked loops: an element's alpha halves only
//   while its own trial energy exceeds its start, and a converged element
//   keeps its sigma. A NaN energy is accepted (e > e0 is false) and ends
//   the element's loop, as there.
// K30 dtw_scatter2d -- replaces dot_tpu/dim2.py:823-832 (_scatter) with
//   admm.py:216-226 (_apply_A) and the rhs of :288-297 at DIM = 2:
//   D^T (w M) per triangle corner, summed per vertex, then one of two
//   per-vertex epilogues; the z column is 0 before its epilogue.
//   Bound: memory. Each incidence reads w, 2 entries of M and 2 (4 for
//   corner 0) of restTriInv: ~3 x 19,873 incidences x 2 coordinates x 20-28
//   B, ~3 MB of (L2-resident) gathers in f32: a few microseconds, so the
//   launch sets the time.
//   Design: K22's vertex pass. One thread per vertex walks its run of the
//   (triangle, corner) incidences sorted by vertex on the host
//   (System2D.scatter_plan) and adds each corner's sum_j D[c][j] (w M[i][j])
//   in that order: the plain version's sequential index_add_. No atomics:
//   the result is the right-hand side of the global solve, and the
//   Dirichlet offsets.

#include <cuda_runtime.h>

#include <cstdint>

#include "elem2d.cuh"

namespace dotadmm2 {

using dotk2::Mat2;

constexpr int kThreads = 128;
constexpr int kLocalMaxIter = 100;   // ADMMTimeStepper.cpp:385
constexpr int kLocalLsCap = 40;

// H p = g for SPD H (00, 01, 11) by the adjugate (_solve_sym2)
template <typename T>
__device__ __forceinline__ void solve_sym2(const T h[3], const T g[2], T p[2]) {
  const T inv_det = T(1) / (h[0] * h[2] - h[1] * h[1]);
  p[0] = (h[2] * g[0] - h[1] * g[1]) * inv_det;
  p[1] = (h[0] * g[1] - h[1] * g[0]) * inv_det;
}

template <typename T, int M>
__device__ __forceinline__ T local_energy(const T s[2], const T s_hat[2], T mu,
                                          T lam, T vd, T w) {
  const T d0 = s_hat[0] - s[0], d1 = s_hat[1] - s[1];
  return Mat2<T, M>::psi(s, mu, lam) * vd + T(0.5) * w * (d0 * d0 + d1 * d1);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
admm_local_step2d_kernel(const T* __restrict__ Dx, const T* __restrict__ u4,
                         const T* __restrict__ w_e,
                         const T* __restrict__ vol_dtsq,
                         const T* __restrict__ mu_e, const T* __restrict__ lam_e,
                         int n, T* __restrict__ z_out, T* __restrict__ du_out,
                         int* __restrict__ counts) {
  const int e_id = blockIdx.x * kThreads + threadIdx.x;
  if (e_id >= n) return;
  T dxu[4], U[4], s_hat[2], V[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) dxu[k] = Dx[k * n + e_id] + u4[k * n + e_id];
  dotk2::svd2_flip(dxu, U, s_hat, V);
  const T w = w_e[e_id], vd = vol_dtsq[e_id], mu = mu_e[e_id], lam = lam_e[e_id];

  T s[2] = {s_hat[0], s_hat[1]};
  T e0 = local_energy<T, M>(s, s_hat, mu, lam, vd, w);
  bool active = true;
  int n_it = 0, n_ev = 1;   // Newton iterations, energy evaluations
  for (int it = 0; it < kLocalMaxIter && active; ++it) {
    T g[2], a3[3], h[3], ng[2], p[2], st[2];
    Mat2<T, M>::dpsi(s, mu, lam, g);
#pragma unroll
    for (int i = 0; i < 2; ++i) ng[i] = -(g[i] * vd - w * (s_hat[i] - s[i]));
    Mat2<T, M>::d2psi(s, mu, lam, a3);
    dotk2::make_pd2(a3, h);
#pragma unroll
    for (int k = 0; k < 3; ++k) h[k] = h[k] * vd;
    h[0] = h[0] + w;
    h[2] = h[2] + w;
    solve_sym2(h, ng, p);

    T alpha = T(1);
#pragma unroll
    for (int i = 0; i < 2; ++i) st[i] = s[i] + p[i];
    T e = local_energy<T, M>(st, s_hat, mu, lam, vd, w);
    ++n_it;
    ++n_ev;
    for (int k = 0; k < kLocalLsCap && e > e0; ++k) {
      alpha = alpha * T(0.5);
#pragma unroll
      for (int i = 0; i < 2; ++i) st[i] = s[i] + alpha * p[i];
      e = local_energy<T, M>(st, s_hat, mu, lam, vd, w);
      ++n_ev;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) s[i] = s[i] + alpha * p[i];
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
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 2 * i + j;
      const T zk = U[2 * i] * s[0] * V[2 * j] + U[2 * i + 1] * s[1] * V[2 * j + 1];
      z_out[k * n + e_id] = zk;
      du_out[k * n + e_id] = dxu[k] - u4[k * n + e_id] - zk;    // Dx - z
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dtw_scatter2d_kernel(const T* __restrict__ M4, const T* __restrict__ g4,
                     const T* __restrict__ w_e, int64_t n,
                     const int64_t* __restrict__ inc_perm,
                     const int64_t* __restrict__ inc_off, int64_t n_vert,
                     const T* __restrict__ x, const T* __restrict__ mass,
                     const T* __restrict__ base, const T* __restrict__ offset,
                     const T* __restrict__ free_v, T* __restrict__ out) {
  const int64_t v = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (v >= n_vert) return;
  T s[3] = {T(0), T(0), T(0)};
  const int64_t end = inc_off[v + 1];
  for (int64_t k = inc_off[v]; k < end; ++k) {
    const int64_t inc = inc_perm[k];        // triangle * 3 + corner
    const int64_t e = inc / 3;
    const int c = static_cast<int>(inc - e * 3);
    // D[c][j]: D_0 = -(row 0 + row 1) of restTriInv, D_{k+1} = row k
    T D0, D1;
    if (c == 0) {
      D0 = -(g4[e] + g4[2 * n + e]);
      D1 = -(g4[n + e] + g4[3 * n + e]);
    } else {
      D0 = g4[(2 * c - 2) * n + e];
      D1 = g4[(2 * c - 1) * n + e];
    }
    const T w = w_e[e];
    s[0] += D0 * (w * M4[e]) + D1 * (w * M4[n + e]);
    s[1] += D0 * (w * M4[2 * n + e]) + D1 * (w * M4[3 * n + e]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int64_t t = v * 3 + i;
    if (mass != nullptr) {
      out[t] = s[i] + mass[v] * x[t];
    } else {
      const T fr = free_v[v];
      out[t] = (base[t] + s[i] - offset[t]) * fr + x[t] * (T(1) - fr);
    }
  }
}

inline unsigned blocks(int64_t n, int t) {
  return static_cast<unsigned>((n + t - 1) / t);
}

template <typename T, int M>
void launch_local(const void* Dx, const void* u4, const void* w, const void* vd,
                  const void* mu, const void* lam, int n, void* z, void* du,
                  int* counts, cudaStream_t st) {
  admm_local_step2d_kernel<T, M><<<blocks(n, kThreads), kThreads, 0, st>>>(
      (const T*)Dx, (const T*)u4, (const T*)w, (const T*)vd, (const T*)mu,
      (const T*)lam, n, (T*)z, (T*)du, counts);
}

}  // namespace dotadmm2

extern "C" {

// dtype: 0 float32, 1 float64; mat: 0 FCR, 1 SNH, 2 SNHWL. Dx, u4, z, du:
// (4, n); w, vol_dtsq, mu, lam: (n,); counts: null, or (2, n) int32 that
// receives each triangle's Newton iterations and energy evaluations.
int dot_admm_local_step2d(int dtype, int mat, const void* Dx, const void* u4,
                          const void* w, const void* vol_dtsq, const void* mu,
                          const void* lam, int n, void* z, void* du,
                          void* counts, void* stream) {
  if (n == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto ct = static_cast<int*>(counts);
#define DOT_LOCAL2(T)                                                          \
  if (mat == 0) dotadmm2::launch_local<T, dotk2::FCR>(Dx, u4, w, vol_dtsq, mu, \
                                                      lam, n, z, du, ct, st);  \
  else if (mat == 1) dotadmm2::launch_local<T, dotk2::SNH>(                    \
      Dx, u4, w, vol_dtsq, mu, lam, n, z, du, ct, st);                         \
  else if (mat == 2) dotadmm2::launch_local<T, dotk2::SNHWL>(                  \
      Dx, u4, w, vol_dtsq, mu, lam, n, z, du, ct, st);                         \
  else return 1;
  if (dtype == 0) { DOT_LOCAL2(float) }
  else if (dtype == 1) { DOT_LOCAL2(double) }
  else return 1;
#undef DOT_LOCAL2
  return static_cast<int>(cudaGetLastError());
}

// M4, g4: (4, n); w: (n,); inc_perm (3 n,) incidences e*3 + c sorted by
// vertex, inc_off (n_vert + 1,) their CSR offsets; x, base, offset, out:
// (n_vert, 3); mass, free: (n_vert,). mass != null: out = s + mass x; else
// out = (base + s - offset) free + x (1 - free).
int dot_dtw_scatter2d(int dtype, const void* M4, const void* g4, const void* w,
                      long long n, const void* inc_perm, const void* inc_off,
                      long long n_vert, const void* x, const void* mass,
                      const void* base, const void* offset, const void* free_v,
                      void* out, void* stream) {
  if (n_vert == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<const int64_t*>(inc_perm);
  auto io = static_cast<const int64_t*>(inc_off);
  const unsigned nb = dotadmm2::blocks(n_vert, dotadmm2::kThreads);
#define DOT_DTW2(T)                                                            \
  dotadmm2::dtw_scatter2d_kernel<T><<<nb, dotadmm2::kThreads, 0, st>>>(        \
      static_cast<const T*>(M4), static_cast<const T*>(g4),                    \
      static_cast<const T*>(w), n, ip, io, n_vert, static_cast<const T*>(x),   \
      static_cast<const T*>(mass), static_cast<const T*>(base),                \
      static_cast<const T*>(offset), static_cast<const T*>(free_v),            \
      static_cast<T*>(out));
  if (dtype == 0) { DOT_DTW2(float) }
  else if (dtype == 1) { DOT_DTW2(double) }
  else return 1;
#undef DOT_DTW2
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
