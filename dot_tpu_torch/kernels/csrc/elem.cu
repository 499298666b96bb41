// K1-K3: the per-element kernels of the DOT main path, one element per
// thread, with a plain C interface (loaded through ctypes by ops.py).
//
// Layouts (as dot_tpu's SoA buffers): F, restTriInv: (9, N) row-major
// component rows; corner ids: (4, N) int32; x: (nV, 3); the element Hessian
// (144, N) block-major, component (a*4+b)*9 + i*3+j holds H[(a,i),(b,j)].
//
// K1 ls_trial_energy -- replaces the line-search trial of
//   dot_tpu/steppers/quasi_newton.py:32-81 (line_search.trial: F0 + a Fp ->
//   svd3_flip_soa, kernels/soa.py:196 -> sum w Psi). Bound on the H100: it
//   reads 2 x 9 + 3 values per element (84 B in f32) -- 7.2 MB at the bar17
//   size, 2 us at 3.35 TB/s -- so the flip-SVD's ~600 dependent flops and
//   its ~60 live registers set the time, and at 86K elements the launch
//   does. Design: one thread per element keeps F, U, V in registers and
//   never writes them (sigma only on request); each block reduces its
//   w*Psi in shared memory and a one-block second pass sums the block
//   partials in a fixed order, so the line search's e <= e0 decision is
//   the same from run to run (no atomics).
// K2 elem_gradient -- replaces element_gradient_soa (kernels/soa.py:450)
//   plus the vertex scatter-add of System.gradient (steppers/core.py:556-574).
//   Bound: 4 corner gathers of x (48 B f32, random but L2-resident: x is
//   200 KB at bar17), 64 B of statics, 12 atomic adds of 4 B: ~160 B per
//   element, memory time ~4 us; the SVD's registers again set the pace.
//   Design: gather, F, SVD, P and D (w P) all stay in registers (D is
//   derived from restTriInv, not stored); atomicAdd into an (nV+1, 3)
//   accumulator whose last row is the padding elements' dump. A padding
//   element (all four scatter ids the dump row; its weight is 0, so its
//   forces are 0) returns at once: at bar135 the 198K pads' 2.4M atomics
//   on that one row serialised to ~4 ms a launch. The atomics make the
//   f32 sum order vary from run to run: compare norm-wise at rtol 1e-4 in
//   f32 (1e-10 in f64).
// K3 elem_hessian -- replaces element_hessian_soa (kernels/soa.py:458) and
//   System.element_hessians (steppers/core.py:590-597). Bound: it writes
//   144 values per element (576 B f32, 50 MB at bar17: 15 us at 3.35 TB/s)
//   and computes 9 rank-1 terms over the 78 upper entries (~1.4K flops)
//   after two Jacobi solves; the 9 x 12 term vectors (108 values) exceed
//   the register file in f64 and spill. Design: one thread per element
//   writes each symmetric entry pair straight to its two block-major rows,
//   so every store instruction of a warp is one coalesced 128 B (f32) row
//   segment; the dt^2 scale is folded into the store.
//
// Two more entry points serve ADMM-DD:
// dot_ls_trial_energy_parts -- K1 with one step length and one sum per
//   subdomain slab; replaces trial_e / e0 of
//   dot_tpu/steppers/admm_dd.py:532-543 (and :274-279). Same bytes and
//   flops as K1. Design: grid (blocks per slab, slabs); alpha is read at
//   the block's slab; each block's sum goes to its slab's row of the
//   partials and one block per slab sums that row in a fixed order: each
//   subdomain's accept / halve decision reads its own sum.
// dot_elem_gradient_from_F -- K2 without the gather of x; replaces the
//   element part of _local_gradient (admm_dd.py:295-311), which takes the
//   CARRIED local deformation gradients (updated linearly along each
//   accepted step, never re-gathered). Same scatter and padding rule as K2;
//   reads 9 + 9 + 3 values and 4 ids per element (100 B in f32).
//
// Built with -fmad=false so that products and sums round as the plain
// PyTorch version's elementwise ops do (see elem.cuh).

#include <cuda_runtime.h>

#include "elem.cuh"

namespace dotk {

constexpr int kRedThreads = 256;   // K1 block size (power of two)
constexpr int kElemThreads = 128;  // K2 / K3 block size

template <typename T>
__device__ __forceinline__ void block_sum_store(T v, T* out) {
  __shared__ T sh[kRedThreads];
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kRedThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = sh[0];
}

template <typename T, int M>
__global__ void __launch_bounds__(kRedThreads)
ls_trial_energy_kernel(const T* __restrict__ F0, const T* __restrict__ Fp,
                       const T* __restrict__ alpha, const T* __restrict__ u,
                       const T* __restrict__ lam, const T* __restrict__ w,
                       int n, T* __restrict__ partials, T* __restrict__ sigma) {
  const int e = blockIdx.x * kRedThreads + threadIdx.x;
  T v = T(0);
  if (e < n) {
    T f[9], U[9], s[3], V[9];
    if (Fp != nullptr) {
      const T a = *alpha;
#pragma unroll
      for (int k = 0; k < 9; ++k) f[k] = F0[k * n + e] + a * Fp[k * n + e];
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) f[k] = F0[k * n + e];
    }
    svd3_flip(f, U, s, V);
    v = Mat<T, M>::psi(s, u[e], lam[e]) * w[e];
    if (sigma != nullptr) {
      sigma[e] = s[0];
      sigma[n + e] = s[1];
      sigma[2 * n + e] = s[2];
    }
  }
  block_sum_store(v, partials + blockIdx.x);
}

// one block: thread t sums partials t, t + 256, ... in order, then a fixed
// shared-memory tree
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
sum_partials_kernel(const T* __restrict__ partials, int m, T* __restrict__ out) {
  T v = T(0);
  for (int i = threadIdx.x; i < m; i += kRedThreads) v += partials[i];
  block_sum_store(v, out);
}

// K1 per slab: block (b, p) covers elements p * n_slab + b * 256 ... of slab
// p, reads alpha[p] and writes partials[p * gridDim.x + b]
template <typename T, int M>
__global__ void __launch_bounds__(kRedThreads)
ls_trial_energy_parts_kernel(const T* __restrict__ F0, const T* __restrict__ Fp,
                             const T* __restrict__ alpha,
                             const T* __restrict__ u, const T* __restrict__ lam,
                             const T* __restrict__ w, int n, int n_slab,
                             T* __restrict__ partials) {
  const int i = blockIdx.x * kRedThreads + threadIdx.x;
  const int e = blockIdx.y * n_slab + i;
  T v = T(0);
  if (i < n_slab) {
    T f[9], U[9], s[3], V[9];
    if (Fp != nullptr) {
      const T a = alpha[blockIdx.y];
#pragma unroll
      for (int k = 0; k < 9; ++k) f[k] = F0[k * n + e] + a * Fp[k * n + e];
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) f[k] = F0[k * n + e];
    }
    svd3_flip(f, U, s, V);
    v = Mat<T, M>::psi(s, u[e], lam[e]) * w[e];
  }
  block_sum_store(v, partials + blockIdx.y * gridDim.x + blockIdx.x);
}

// one block per slab: sums its m partials as sum_partials_kernel does
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
sum_slab_partials_kernel(const T* __restrict__ partials, int m,
                         T* __restrict__ out) {
  T v = T(0);
  const T* row = partials + blockIdx.x * m;
  for (int i = threadIdx.x; i < m; i += kRedThreads) v += row[i];
  block_sum_store(v, out + blockIdx.x);
}

template <typename T>
__device__ __forceinline__ void gather_defgrad(const T* __restrict__ x,
                                               const int* __restrict__ conn,
                                               const T* __restrict__ g9, int n,
                                               int e, T f[9], T g[9]) {
  T xc[4][3];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long v = conn[c * n + e];
#pragma unroll
    for (int d = 0; d < 3; ++d) xc[c][d] = x[v * 3 + d];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) g[k] = g9[k * n + e];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      f[3 * i + j] = (xc[1][i] - xc[0][i]) * g[j] + (xc[2][i] - xc[0][i]) * g[3 + j]
                   + (xc[3][i] - xc[0][i]) * g[6 + j];
}

// D[c][j]: D_0 = -(row0 + row1 + row2) of restTriInv, D_{k+1} = row k
template <typename T>
__device__ __forceinline__ void corner_basis(const T g[9], T D[4][3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    D[0][j] = -(g[j] + g[3 + j] + g[6 + j]);
    D[1][j] = g[j];
    D[2][j] = g[3 + j];
    D[3][j] = g[6 + j];
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kElemThreads)
elem_gradient_kernel(const T* __restrict__ x, const int* __restrict__ conn,
                     const int* __restrict__ conn_s, const T* __restrict__ g9,
                     const T* __restrict__ u, const T* __restrict__ lam,
                     const T* __restrict__ w, int n, T* __restrict__ acc) {
  const int e = blockIdx.x * kElemThreads + threadIdx.x;
  if (e >= n || conn_s[e] == conn_s[n + e]) return;   // padding element
  T f[9], g[9], U[9], s[3], V[9], P[9], D[4][3];
  gather_defgrad(x, conn, g9, n, e, f, g);
  svd3_flip(f, U, s, V);
  Mat<T, M>::first_piola(f, U, s, V, u[e], lam[e], P);
  const T we = w[e];
#pragma unroll
  for (int k = 0; k < 9; ++k) P[k] = P[k] * we;
  corner_basis(g, D);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long v = conn_s[c * n + e];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      atomicAdd(acc + v * 3 + d, D[c][0] * P[3 * d] + D[c][1] * P[3 * d + 1]
                                     + D[c][2] * P[3 * d + 2]);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kElemThreads)
elem_gradient_from_F_kernel(const T* __restrict__ F, const int* __restrict__ conn_s,
                            const T* __restrict__ g9, const T* __restrict__ u,
                            const T* __restrict__ lam, const T* __restrict__ w,
                            int n, T* __restrict__ acc) {
  const int e = blockIdx.x * kElemThreads + threadIdx.x;
  if (e >= n || conn_s[e] == conn_s[n + e]) return;   // padding element
  T f[9], g[9], U[9], s[3], V[9], P[9], D[4][3];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    f[k] = F[k * n + e];
    g[k] = g9[k * n + e];
  }
  svd3_flip(f, U, s, V);
  Mat<T, M>::first_piola(f, U, s, V, u[e], lam[e], P);
  const T we = w[e];
#pragma unroll
  for (int k = 0; k < 9; ++k) P[k] = P[k] * we;
  corner_basis(g, D);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long v = conn_s[c * n + e];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      atomicAdd(acc + v * 3 + d, D[c][0] * P[3 * d] + D[c][1] * P[3 * d + 1]
                                     + D[c][2] * P[3 * d + 2]);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kElemThreads)
elem_hessian_kernel(const T* __restrict__ x, const int* __restrict__ conn,
                    const T* __restrict__ g9, const T* __restrict__ u,
                    const T* __restrict__ lam, const T* __restrict__ w, T dt_sq,
                    int n, T* __restrict__ out) {
  const int e = blockIdx.x * kElemThreads + threadIdx.x;
  if (e >= n) return;
  T f[9], g[9], U[9], s[3], V[9], D[4][3];
  gather_defgrad(x, conn, g9, n, e, f, g);
  svd3_flip(f, U, s, V);
  corner_basis(g, D);
  const T ue = u[e], le = lam[e];

  T a6[6], alpha[3], Q[9], dps[3], bl[3];
  Mat<T, M>::d2psi(s, ue, le, a6);
  jacobi_eigh(a6, alpha, Q);
  Mat<T, M>::dpsi(s, ue, le, dps);
  Mat<T, M>::b_left(s, ue, le, bl);

  T coef[9];
  const int pr[3][2] = {{0, 1}, {1, 2}, {2, 0}};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int ci = pr[k][0], cj = pr[k][1];
    const T ssum = s[ci] + s[cj];
    const T denom = ssum < T(1.0e-6) ? T(1.0e-6) : ssum;
    const T right = (dps[ci] + dps[cj]) / (T(2) * denom);
    coef[k] = cl0(alpha[k]);
    coef[3 + k] = cl0(bl[k]);
    coef[6 + k] = cl0(right);
  }

  T DV[4][3];  // DV[c][b] = sum_j D[c][j] V[j][b]
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      DV[c][b] = D[c][0] * V[b] + D[c][1] * V[3 + b] + D[c][2] * V[6 + b];

  T vec[9][12];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int r = c * 3 + i;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        vec[a][r] = Q[a] * U[3 * i] * DV[c][0] + Q[3 + a] * U[3 * i + 1] * DV[c][1]
                  + Q[6 + a] * U[3 * i + 2] * DV[c][2];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int px = pr[k][0], py = pr[k][1];
        const T wx = U[3 * i + px] * DV[c][py];
        const T wy = U[3 * i + py] * DV[c][px];
        vec[3 + k][r] = wx + wy;
        vec[6 + k][r] = wx - wy;
      }
    }

  const T we = w[e];
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int c = r; c < 12; ++c) {
      T acc = coef[0] * vec[0][r] * vec[0][c];
#pragma unroll
      for (int t = 1; t < 9; ++t) acc = acc + coef[t] * vec[t][r] * vec[t][c];
      acc = acc * we * dt_sq;
      const int ar = r / 3, ir = r % 3, bc = c / 3, jc = c % 3;
      out[((ar * 4 + bc) * 9 + ir * 3 + jc) * n + e] = acc;
      if (c != r) out[((bc * 4 + ar) * 9 + jc * 3 + ir) * n + e] = acc;
    }
}

inline int blocks(int n, int t) { return (n + t - 1) / t; }

template <typename T, int M>
void launch_trial(const void* F0, const void* Fp, const void* alpha, const void* u,
                  const void* lam, const void* w, int n, void* partials, void* out,
                  void* sigma, cudaStream_t st) {
  const int nb = blocks(n, kRedThreads);
  ls_trial_energy_kernel<T, M><<<nb, kRedThreads, 0, st>>>(
      (const T*)F0, (const T*)Fp, (const T*)alpha, (const T*)u, (const T*)lam,
      (const T*)w, n, (T*)partials, (T*)sigma);
  sum_partials_kernel<T><<<1, kRedThreads, 0, st>>>((const T*)partials, nb, (T*)out);
}

template <typename T, int M>
void launch_trial_parts(const void* F0, const void* Fp, const void* alpha,
                        const void* u, const void* lam, const void* w, int n,
                        int n_parts, void* partials, void* out, cudaStream_t st) {
  const int n_slab = n / n_parts;
  const int nb = blocks(n_slab, kRedThreads);
  ls_trial_energy_parts_kernel<T, M><<<dim3(nb, n_parts), kRedThreads, 0, st>>>(
      (const T*)F0, (const T*)Fp, (const T*)alpha, (const T*)u, (const T*)lam,
      (const T*)w, n, n_slab, (T*)partials);
  sum_slab_partials_kernel<T><<<n_parts, kRedThreads, 0, st>>>(
      (const T*)partials, nb, (T*)out);
}

template <typename T, int M>
void launch_grad_from_F(const void* F, const int* conn_s, const void* g9,
                        const void* u, const void* lam, const void* w, int n,
                        void* acc, cudaStream_t st) {
  elem_gradient_from_F_kernel<T, M><<<blocks(n, kElemThreads), kElemThreads, 0,
                                      st>>>(
      (const T*)F, conn_s, (const T*)g9, (const T*)u, (const T*)lam,
      (const T*)w, n, (T*)acc);
}

template <typename T, int M>
void launch_grad(const void* x, const int* conn, const int* conn_s, const void* g9,
                 const void* u, const void* lam, const void* w, int n, void* acc,
                 cudaStream_t st) {
  elem_gradient_kernel<T, M><<<blocks(n, kElemThreads), kElemThreads, 0, st>>>(
      (const T*)x, conn, conn_s, (const T*)g9, (const T*)u, (const T*)lam,
      (const T*)w, n, (T*)acc);
}

template <typename T, int M>
void launch_hess(const void* x, const int* conn, const void* g9, const void* u,
                 const void* lam, const void* w, double dt_sq, int n, void* out,
                 cudaStream_t st) {
  elem_hessian_kernel<T, M><<<blocks(n, kElemThreads), kElemThreads, 0, st>>>(
      (const T*)x, conn, (const T*)g9, (const T*)u, (const T*)lam, (const T*)w,
      T(dt_sq), n, (T*)out);
}

}  // namespace dotk

// dtype: 0 float32, 1 float64; mat: 0 FCR, 1 SNH, 2 SNHWL. Each returns the
// cudaGetLastError() of its launches (0 = cudaSuccess); bad codes give 1.
#define DOTK_DISPATCH(FN, ...)                                              \
  if (dtype == 0) {                                                         \
    if (mat == 0) FN<float, dotk::FCR>(__VA_ARGS__);                        \
    else if (mat == 1) FN<float, dotk::SNH>(__VA_ARGS__);                   \
    else if (mat == 2) FN<float, dotk::SNHWL>(__VA_ARGS__);                 \
    else return 1;                                                          \
  } else if (dtype == 1) {                                                  \
    if (mat == 0) FN<double, dotk::FCR>(__VA_ARGS__);                       \
    else if (mat == 1) FN<double, dotk::SNH>(__VA_ARGS__);                  \
    else if (mat == 2) FN<double, dotk::SNHWL>(__VA_ARGS__);                \
    else return 1;                                                          \
  } else {                                                                  \
    return 1;                                                               \
  }                                                                         \
  return (int)cudaGetLastError();

extern "C" {

int dot_ls_trial_energy(int dtype, int mat, const void* F0, const void* Fp,
                        const void* alpha, const void* u, const void* lam,
                        const void* w, int n, void* partials, void* out,
                        void* sigma, void* stream) {
  DOTK_DISPATCH(dotk::launch_trial, F0, Fp, alpha, u, lam, w, n, partials, out,
                sigma, (cudaStream_t)stream)
}

int dot_trial_partials(int n) { return dotk::blocks(n, dotk::kRedThreads); }

int dot_elem_gradient(int dtype, int mat, const void* x, const void* conn,
                      const void* conn_s, const void* g9, const void* u,
                      const void* lam, const void* w, int n, void* acc,
                      void* stream) {
  DOTK_DISPATCH(dotk::launch_grad, x, (const int*)conn, (const int*)conn_s, g9, u,
                lam, w, n, acc, (cudaStream_t)stream)
}

// F0, Fp: (9, n); alpha, out: (n_parts,); partials: n_parts *
// dot_trial_partials(n / n_parts) values; n is a multiple of n_parts.
int dot_ls_trial_energy_parts(int dtype, int mat, const void* F0,
                              const void* Fp, const void* alpha, const void* u,
                              const void* lam, const void* w, int n,
                              int n_parts, void* partials, void* out,
                              void* stream) {
  if (n_parts < 1 || n % n_parts != 0) return 1;
  DOTK_DISPATCH(dotk::launch_trial_parts, F0, Fp, alpha, u, lam, w, n, n_parts,
                partials, out, (cudaStream_t)stream)
}

// F: (9, n) deformation gradients; conn_s: (4, n) scatter rows; acc as K2.
int dot_elem_gradient_from_F(int dtype, int mat, const void* F,
                             const void* conn_s, const void* g9, const void* u,
                             const void* lam, const void* w, int n, void* acc,
                             void* stream) {
  DOTK_DISPATCH(dotk::launch_grad_from_F, F, (const int*)conn_s, g9, u, lam, w,
                n, acc, (cudaStream_t)stream)
}

int dot_elem_hessian(int dtype, int mat, const void* x, const void* conn,
                     const void* g9, const void* u, const void* lam,
                     const void* w, double dt_sq, int n, void* out,
                     void* stream) {
  DOTK_DISPATCH(dotk::launch_hess, x, (const int*)conn, g9, u, lam, w, dt_sq, n,
                out, (cudaStream_t)stream)
}

}  // extern "C"
