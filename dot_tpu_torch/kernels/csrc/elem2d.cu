// K21-K24: the kernels of the 2D (triangle-mesh) projected-Newton path, with
// a plain C interface (loaded through ctypes by ops.py), and one check entry
// per device function of elem2d.cuh (K24's assembly runs dd2d.cu's one-pass
// kernel; its scaling is here).
//
// Layouts: F, restTriInv: (4, N) component rows (m00, m01, m10, m11); corner
// ids: (3, N) int32; x: (nV, 3) with z = 0; the element Hessian (36, N)
// row-major over the (corner, xy) dofs, row r*6 + c holds H[r][c]; the dense
// matrix (2 nV, 2 nV) row-major over dofs 2 v + i.
//
// defgrad2d -- dot_tpu/kernels/soa2d.py:233 defgrad2_soa as
//   System2D.defgrad calls it (dim2.py:447-450) on positions and on search
//   directions. 3 corner gathers and 4 statics per element in, 4 values out:
//   launch-bound at every 2D size.
// K21 ls_trial_energy2d -- replaces the line-search trial of
//   Newton2DStepper (dim2.py:911-916: F0 + a Fp -> svd2_flip_soa ->
//   sum area Psi) and elastic_energy_sigma (dim2.py:532-534). Bound: bytes,
//   11 values per element (2 x 4 + u, lam, area), 0.9 MB at 20K triangles:
//   the launch sets the time. Design: K1's: one thread per element, the step
//   length read from device memory, each block reduces in shared memory and
//   a one-block second pass sums the block partials in a fixed order, so the
//   line search's e <= e0 decision repeats from run to run (no atomics).
// K22 elem_gradient2d -- replaces element_gradient2_soa (soa2d.py:244) and
//   System2D.gradient (dim2.py:463-476): P from F, U, sigma, V; the
//   per-corner forces through D; the sum to the vertices by _gdest; dt^2;
//   + mass (x - x~); z = 0; zero at fixed vertices. Bound: bytes (3 gathers
//   of x, 7 statics, 6 forces out and in again, ~100 B per element).
//   Design: two launches. The first writes the six force components per
//   element as coalesced rows of a (6, N) scratch. The second has one thread
//   per vertex walk its (element, corner) incidences, sorted by vertex on
//   the host (K13 / K18's CSR runs), in a fixed order, and finish the row:
//   no atomics, since ||g||^2 decides the Newton loop's stop.
// K23 elem_hessian2d -- replaces element_hessian2_soa (soa2d.py:252-312)
//   with project_spd and the dt^2 scale of System2D.factorize
//   (dim2.py:482-485). Bound: bytes, 36 values out per element (2.9 MB in
//   f32 at 20K triangles). Design: K3's: one thread per element, each
//   symmetric pair stored straight to its two rows (coalesced per warp).
// K24 dense_assemble2d / dense_scale2d -- replaces the assembly of
//   System2D.factorize (dim2.py:486-496): scatter-add by _hdest into the
//   (2 nV)^2 matrix, + mass on the diagonal, the free mask on rows and
//   columns, a unit diagonal at fixed dofs, d = sqrt(diag); then
//   H / d_i / d_j. dot_tpu makes four full-size temporaries there. Bound:
//   bytes: the matrix written once (1.655 GB in f32 at 10,171 vertices:
//   0.49 ms at 3.35 TB/s). Design: the assembly is K26's one write pass
//   (dd2d.cu assemble_kernel, dot_subdomain_assemble2d) with the whole mesh
//   as one part (dd2d.dense_tables): every byte written once, no zero
//   fill. Its diagonal term is mass f + (1 - f) after the mask, dot_tpu's
//   (s + mass) f f + (1 - f) before it: the same bits where f is 0 or 1.
//   The scaling (here) is a second entry over the same slots, in place:
//   every other entry is 0 and stays 0, so the matrix is not read or
//   written a second time. Its slots are 64-bit (n2^2 passes 2^31 above
//   23,170 vertices).
//
// Two more entry points serve 2D ADMM-DD (their plain versions are in
// kernels/admm2d.py):
// dot_ls_trial_energy2d_parts -- K21 with one step length and one sum per
//   subdomain slab; replaces trial_e / e0 of dot_tpu/dim2.py:1366-1374 with
//   _local_psi_sum (:1173-1176). Same bytes and operations as K21. Design:
//   K1's per-slab entry: grid (blocks per slab, slabs), alpha read at the
//   block's slab, each slab's block sums summed by one block in a fixed
//   order: each subdomain's accept / halve decision reads its own sum.
// dot_elem_gradient2d_from_F -- K22 from the CARRIED local deformation
//   gradients (updated linearly along each accepted step, never
//   re-gathered); replaces the element part of _local_gradient
//   (dim2.py:1182-1189). Its first launch is K22's force pass reading F
//   instead of gathering x; its second sums each local row's (triangle,
//   corner) incidences, sorted by row on the host, in order (no atomics:
//   the local Newton step reads the gradient). Rows past n_rows (the
//   padding triangles' dump row) are never summed.
//
// Built with -fmad=false (see elem2d.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "elem2d.cuh"

namespace dotk2 {

constexpr int kRedThreads = 256;   // K21 block size (power of two)
constexpr int kElemThreads = 128;  // per-element / per-vertex / per-slot

inline int blocks(int64_t n, int t) { return static_cast<int>((n + t - 1) / t); }

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

template <typename T>
__device__ __forceinline__ void gather_defgrad2(const T* __restrict__ x,
                                                const int* __restrict__ conn,
                                                const T* __restrict__ g4, int n,
                                                int e, T f[4], T g[4]) {
  T xc[3][2];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t v = conn[c * n + e];
    xc[c][0] = x[v * 3];
    xc[c][1] = x[v * 3 + 1];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) g[k] = g4[k * n + e];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      f[2 * i + j] = (xc[1][i] - xc[0][i]) * g[j] + (xc[2][i] - xc[0][i]) * g[2 + j];
}

// D[c][j]: D_0 = -(row 0 + row 1) of restTriInv, D_{k+1} = row k
template <typename T>
__device__ __forceinline__ void corner_basis2(const T g[4], T D[3][2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    D[0][j] = -(g[j] + g[2 + j]);
    D[1][j] = g[j];
    D[2][j] = g[2 + j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kElemThreads)
defgrad2d_kernel(const T* __restrict__ x, const int* __restrict__ conn,
                 const T* __restrict__ g4, int n, T* __restrict__ F) {
  const int e = blockIdx.x * kElemThreads + threadIdx.x;
  if (e >= n) return;
  T f[4], g[4];
  gather_defgrad2(x, conn, g4, n, e, f, g);
#pragma unroll
  for (int k = 0; k < 4; ++k) F[k * n + e] = f[k];
}

template <typename T, int M>
__global__ void __launch_bounds__(kRedThreads)
ls_trial_energy2d_kernel(const T* __restrict__ F0, const T* __restrict__ Fp,
                         const T* __restrict__ alpha, const T* __restrict__ u,
                         const T* __restrict__ lam, const T* __restrict__ w,
                         int n, T* __restrict__ partials, T* __restrict__ sigma) {
  const int e = blockIdx.x * kRedThreads + threadIdx.x;
  T v = T(0);
  if (e < n) {
    T f[4], U[4], s[2], V[4];
    if (Fp != nullptr) {
      const T a = *alpha;
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = F0[k * n + e] + a * Fp[k * n + e];
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = F0[k * n + e];
    }
    svd2_flip(f, U, s, V);
    v = Mat2<T, M>::psi(s, u[e], lam[e]) * w[e];
    if (sigma != nullptr) {
      sigma[e] = s[0];
      sigma[n + e] = s[1];
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

// K1-style per-slab trial: block (b, p) covers triangles p * n_slab + b *
// 256 ... of slab p, reads alpha[p] and writes partials[p * gridDim.x + b]
template <typename T, int M>
__global__ void __launch_bounds__(kRedThreads)
ls_trial_energy2d_parts_kernel(const T* __restrict__ F0, const T* __restrict__ Fp,
                               const T* __restrict__ alpha,
                               const T* __restrict__ u, const T* __restrict__ lam,
                               const T* __restrict__ w, int n, int n_slab,
                               T* __restrict__ partials) {
  const int i = blockIdx.x * kRedThreads + threadIdx.x;
  const int e = blockIdx.y * n_slab + i;
  T v = T(0);
  if (i < n_slab) {
    T f[4], U[4], s[2], V[4];
    if (Fp != nullptr) {
      const T a = alpha[blockIdx.y];
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = F0[k * n + e] + a * Fp[k * n + e];
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = F0[k * n + e];
    }
    svd2_flip(f, U, s, V);
    v = Mat2<T, M>::psi(s, u[e], lam[e]) * w[e];
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

// K22, first launch: ge (6, n), row c*2 + d = sum_j D[c][j] (w P)[d][j], at
// F gathered from x, or read from F (the from-F entry: x null)
template <typename T, int M>
__global__ void __launch_bounds__(kElemThreads)
elem_forces2d_kernel(const T* __restrict__ x, const int* __restrict__ conn,
                     const T* __restrict__ F, const T* __restrict__ g4,
                     const T* __restrict__ u, const T* __restrict__ lam,
                     const T* __restrict__ w, int n, T* __restrict__ ge) {
  const int e = blockIdx.x * kElemThreads + threadIdx.x;
  if (e >= n) return;
  T f[4], g[4], U[4], s[2], V[4], P[4], D[3][2];
  if (x != nullptr) {
    gather_defgrad2(x, conn, g4, n, e, f, g);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = F[k * n + e];
      g[k] = g4[k * n + e];
    }
  }
  svd2_flip(f, U, s, V);
  Mat2<T, M>::first_piola(f, U, s, V, u[e], lam[e], P);
  const T we = w[e];
#pragma unroll
  for (int k = 0; k < 4; ++k) P[k] = P[k] * we;
  corner_basis2(g, D);
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int d = 0; d < 2; ++d)
      ge[(c * 2 + d) * n + e] = D[c][0] * P[2 * d] + D[c][1] * P[2 * d + 1];
}

// K22, second launch: one thread per vertex sums its incidences in order
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
vertex_gradient2d_kernel(const T* __restrict__ ge, int n,
                         const int64_t* __restrict__ inc_perm,
                         const int64_t* __restrict__ inc_off,
                         const T* __restrict__ x, const T* __restrict__ x_tilta,
                         const T* __restrict__ freev, const T* __restrict__ mass,
                         T dt_sq, int64_t n_vert, T* __restrict__ out) {
  const int64_t v = blockIdx.x * static_cast<int64_t>(kElemThreads) + threadIdx.x;
  if (v >= n_vert) return;
  T a0 = T(0), a1 = T(0);
  const int64_t end = inc_off[v + 1];
  for (int64_t k = inc_off[v]; k < end; ++k) {
    const int64_t inc = inc_perm[k];      // element * 3 + corner
    const int64_t e = inc / 3;
    const int c = static_cast<int>(inc - e * 3);
    a0 += ge[static_cast<int64_t>(c * 2) * n + e];
    a1 += ge[static_cast<int64_t>(c * 2 + 1) * n + e];
  }
  const bool fr = freev[v] != T(0);
  const T m = mass[v];
  const T g0 = a0 * dt_sq + m * (x[v * 3] - x_tilta[v * 3]);
  const T g1 = a1 * dt_sq + m * (x[v * 3 + 1] - x_tilta[v * 3 + 1]);
  out[v * 3] = fr ? g0 : T(0);
  out[v * 3 + 1] = fr ? g1 : T(0);
  out[v * 3 + 2] = T(0);
}

// K22 from F, second launch: one thread per local row sums its incidences
// in order (no epilogue)
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
row_sums2d_kernel(const T* __restrict__ ge, int n,
                  const int64_t* __restrict__ inc_perm,
                  const int64_t* __restrict__ inc_off, int64_t n_rows,
                  T* __restrict__ out) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(kElemThreads) + threadIdx.x;
  if (r >= n_rows) return;
  T a0 = T(0), a1 = T(0);
  const int64_t end = inc_off[r + 1];
  for (int64_t k = inc_off[r]; k < end; ++k) {
    const int64_t inc = inc_perm[k];      // triangle * 3 + corner
    const int64_t e = inc / 3;
    const int c = static_cast<int>(inc - e * 3);
    a0 += ge[static_cast<int64_t>(c * 2) * n + e];
    a1 += ge[static_cast<int64_t>(c * 2 + 1) * n + e];
  }
  out[r * 2] = a0;
  out[r * 2 + 1] = a1;
}

template <typename T, int M>
__global__ void __launch_bounds__(kElemThreads)
elem_hessian2d_kernel(const T* __restrict__ x, const int* __restrict__ conn,
                      const T* __restrict__ g4, const T* __restrict__ u,
                      const T* __restrict__ lam, const T* __restrict__ w, T dt_sq,
                      int n, T* __restrict__ out) {
  const int e = blockIdx.x * kElemThreads + threadIdx.x;
  if (e >= n) return;
  T f[4], g[4], U[4], s[2], V[4], D[3][2];
  gather_defgrad2(x, conn, g4, n, e, f, g);
  svd2_flip(f, U, s, V);
  corner_basis2(g, D);
  const T ue = u[e], le = lam[e];

  T h3[3], alpha[2], Q[4], dps[2];
  Mat2<T, M>::d2psi(s, ue, le, h3);
  eigh2(h3[0], h3[1], h3[2], alpha, Q);
  Mat2<T, M>::dpsi(s, ue, le, dps);
  const T bl = Mat2<T, M>::b_left(s, ue, le);
  const T ssum = s[0] + s[1];
  const T denom = ssum < T(1.0e-6) ? T(1.0e-6) : ssum;
  const T br = (dps[0] + dps[1]) / (T(2) * denom);
  const T coef[4] = {cl0(alpha[0]), cl0(alpha[1]), cl0(bl), cl0(br)};

  T DV[3][2];  // DV[c][b] = sum_j D[c][j] V[j][b]
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int b = 0; b < 2; ++b) DV[c][b] = D[c][0] * V[b] + D[c][1] * V[2 + b];

  T vec[4][6];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = c * 2 + i;
#pragma unroll
      for (int a = 0; a < 2; ++a)
        vec[a][r] = Q[a] * U[2 * i] * DV[c][0] + Q[2 + a] * U[2 * i + 1] * DV[c][1];
      const T wx = U[2 * i] * DV[c][1];
      const T wy = U[2 * i + 1] * DV[c][0];
      vec[2][r] = wx + wy;
      vec[3][r] = wx - wy;
    }

  const T we = w[e];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int c = r; c < 6; ++c) {
      T acc = coef[0] * vec[0][r] * vec[0][c];
#pragma unroll
      for (int t = 1; t < 4; ++t) acc = acc + coef[t] * vec[t][r] * vec[t][c];
      acc = acc * we * dt_sq;
      out[(r * 6 + c) * n + e] = acc;
      if (c != r) out[(c * 6 + r) * n + e] = acc;
    }
}

// K24's scaling: one thread per assembled slot, in place
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
dense_scale2d_kernel(T* __restrict__ H, const T* __restrict__ d,
                     const int64_t* __restrict__ udest, int64_t n_slot,
                     int64_t n2) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kElemThreads) + threadIdx.x;
  if (t >= n_slot) return;
  const int64_t slot = udest[t];
  const int64_t row = slot / n2, col = slot - row * n2;
  H[slot] = H[slot] * (T(1) / d[row]) * (T(1) / d[col]);
}

// ---- check entries of the device functions --------------------------------
template <typename T>
__global__ void __launch_bounds__(kElemThreads)
svd2_check_kernel(const T* __restrict__ F, int n, T* __restrict__ Uo,
                  T* __restrict__ so, T* __restrict__ Vo) {
  const int e = blockIdx.x * kElemThreads + threadIdx.x;
  if (e >= n) return;
  T f[4], U[4], s[2], V[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = F[k * n + e];
  svd2_flip(f, U, s, V);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Uo[k * n + e] = U[k];
    Vo[k * n + e] = V[k];
  }
  so[e] = s[0];
  so[n + e] = s[1];
}

template <typename T>
__global__ void __launch_bounds__(kElemThreads)
eigh2_check_kernel(const T* __restrict__ h3, int n, T* __restrict__ lam,
                   T* __restrict__ Qo, T* __restrict__ pd) {
  const int e = blockIdx.x * kElemThreads + threadIdx.x;
  if (e >= n) return;
  const T h[3] = {h3[e], h3[n + e], h3[2 * n + e]};
  if (pd != nullptr) {
    T o[3];
    make_pd2(h, o);
    pd[e] = o[0];
    pd[n + e] = o[1];
    pd[2 * n + e] = o[2];
    return;
  }
  T l[2], Q[4];
  eigh2(h[0], h[1], h[2], l, Q);
  lam[e] = l[0];
  lam[n + e] = l[1];
#pragma unroll
  for (int k = 0; k < 4; ++k) Qo[k * n + e] = Q[k];
}

// out (11, n): Psi, dPsi (2), d2Psi (3), BLeftCoef, P (4) at svd2_flip(F)
template <typename T, int M>
__global__ void __launch_bounds__(kElemThreads)
material2d_check_kernel(const T* __restrict__ F, const T* __restrict__ u,
                        const T* __restrict__ lam, int n, T* __restrict__ out) {
  const int e = blockIdx.x * kElemThreads + threadIdx.x;
  if (e >= n) return;
  T f[4], U[4], s[2], V[4], r[11];
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = F[k * n + e];
  svd2_flip(f, U, s, V);
  const T ue = u[e], le = lam[e];
  r[0] = Mat2<T, M>::psi(s, ue, le);
  Mat2<T, M>::dpsi(s, ue, le, r + 1);
  Mat2<T, M>::d2psi(s, ue, le, r + 3);
  r[6] = Mat2<T, M>::b_left(s, ue, le);
  Mat2<T, M>::first_piola(f, U, s, V, ue, le, r + 7);
#pragma unroll
  for (int k = 0; k < 11; ++k) out[k * n + e] = r[k];
}

// ---- launchers -------------------------------------------------------------
template <typename T, int M>
void launch_trial(const void* F0, const void* Fp, const void* alpha, const void* u,
                  const void* lam, const void* w, int n, void* partials, void* out,
                  void* sigma, cudaStream_t st) {
  const int nb = blocks(n, kRedThreads);
  ls_trial_energy2d_kernel<T, M><<<nb, kRedThreads, 0, st>>>(
      (const T*)F0, (const T*)Fp, (const T*)alpha, (const T*)u, (const T*)lam,
      (const T*)w, n, (T*)partials, (T*)sigma);
  sum_partials_kernel<T><<<1, kRedThreads, 0, st>>>((const T*)partials, nb, (T*)out);
}

template <typename T, int M>
void launch_grad(const void* x, const void* x_tilta, const void* freev,
                 const void* mass, const int* conn, const void* g4, const void* u,
                 const void* lam, const void* w, double dt_sq, int n,
                 const int64_t* inc_perm, const int64_t* inc_off, int64_t n_vert,
                 void* ge, void* out, cudaStream_t st) {
  elem_forces2d_kernel<T, M><<<blocks(n, kElemThreads), kElemThreads, 0, st>>>(
      (const T*)x, conn, nullptr, (const T*)g4, (const T*)u, (const T*)lam,
      (const T*)w, n, (T*)ge);
  vertex_gradient2d_kernel<T><<<blocks(n_vert, kElemThreads), kElemThreads, 0, st>>>(
      (const T*)ge, n, inc_perm, inc_off, (const T*)x, (const T*)x_tilta,
      (const T*)freev, (const T*)mass, T(dt_sq), n_vert, (T*)out);
}

template <typename T, int M>
void launch_trial_parts(const void* F0, const void* Fp, const void* alpha,
                        const void* u, const void* lam, const void* w, int n,
                        int n_parts, void* partials, void* out, cudaStream_t st) {
  const int n_slab = n / n_parts;
  const int nb = blocks(n_slab, kRedThreads);
  ls_trial_energy2d_parts_kernel<T, M><<<dim3(nb, n_parts), kRedThreads, 0, st>>>(
      (const T*)F0, (const T*)Fp, (const T*)alpha, (const T*)u, (const T*)lam,
      (const T*)w, n, n_slab, (T*)partials);
  sum_slab_partials_kernel<T><<<n_parts, kRedThreads, 0, st>>>(
      (const T*)partials, nb, (T*)out);
}

template <typename T, int M>
void launch_grad_from_F(const void* F, const void* g4, const void* u,
                        const void* lam, const void* w, int n,
                        const int64_t* inc_perm, const int64_t* inc_off,
                        int64_t n_rows, void* ge, void* out, cudaStream_t st) {
  elem_forces2d_kernel<T, M><<<blocks(n, kElemThreads), kElemThreads, 0, st>>>(
      nullptr, nullptr, (const T*)F, (const T*)g4, (const T*)u, (const T*)lam,
      (const T*)w, n, (T*)ge);
  if (n_rows > 0)
    row_sums2d_kernel<T><<<blocks(n_rows, kElemThreads), kElemThreads, 0, st>>>(
        (const T*)ge, n, inc_perm, inc_off, n_rows, (T*)out);
}

template <typename T, int M>
void launch_hess(const void* x, const int* conn, const void* g4, const void* u,
                 const void* lam, const void* w, double dt_sq, int n, void* out,
                 cudaStream_t st) {
  elem_hessian2d_kernel<T, M><<<blocks(n, kElemThreads), kElemThreads, 0, st>>>(
      (const T*)x, conn, (const T*)g4, (const T*)u, (const T*)lam, (const T*)w,
      T(dt_sq), n, (T*)out);
}

template <typename T, int M>
void launch_material(const void* F, const void* u, const void* lam, int n,
                     void* out, cudaStream_t st) {
  material2d_check_kernel<T, M><<<blocks(n, kElemThreads), kElemThreads, 0, st>>>(
      (const T*)F, (const T*)u, (const T*)lam, n, (T*)out);
}

}  // namespace dotk2

// dtype: 0 float32, 1 float64; mat: 0 FCR, 1 SNH, 2 SNHWL. Each returns the
// cudaGetLastError() of its launches (0 = cudaSuccess); bad codes give 1.
#define DOTK2_DISPATCH(FN, ...)                                             \
  if (dtype == 0) {                                                         \
    if (mat == 0) FN<float, dotk2::FCR>(__VA_ARGS__);                       \
    else if (mat == 1) FN<float, dotk2::SNH>(__VA_ARGS__);                  \
    else if (mat == 2) FN<float, dotk2::SNHWL>(__VA_ARGS__);                \
    else return 1;                                                          \
  } else if (dtype == 1) {                                                  \
    if (mat == 0) FN<double, dotk2::FCR>(__VA_ARGS__);                      \
    else if (mat == 1) FN<double, dotk2::SNH>(__VA_ARGS__);                 \
    else if (mat == 2) FN<double, dotk2::SNHWL>(__VA_ARGS__);               \
    else return 1;                                                          \
  } else {                                                                  \
    return 1;                                                               \
  }                                                                         \
  return (int)cudaGetLastError();

extern "C" {

// x (nV, 3); conn (3, n) int32; g4 (4, n); F (4, n).
int dot_defgrad2d(int dtype, const void* x, const void* conn, const void* g4,
                  int n, void* F, void* stream) {
  auto st = (cudaStream_t)stream;
  const int nb = dotk2::blocks(n, dotk2::kElemThreads);
  if (n == 0) return 0;
  if (dtype == 0)
    dotk2::defgrad2d_kernel<float><<<nb, dotk2::kElemThreads, 0, st>>>(
        (const float*)x, (const int*)conn, (const float*)g4, n, (float*)F);
  else if (dtype == 1)
    dotk2::defgrad2d_kernel<double><<<nb, dotk2::kElemThreads, 0, st>>>(
        (const double*)x, (const int*)conn, (const double*)g4, n, (double*)F);
  else
    return 1;
  return (int)cudaGetLastError();
}

// F0, Fp (4, n) (Fp and alpha may be null); partials: dot_trial2d_partials(n)
// values; out: 0-d; sigma: (2, n) or null.
int dot_ls_trial_energy2d(int dtype, int mat, const void* F0, const void* Fp,
                          const void* alpha, const void* u, const void* lam,
                          const void* w, int n, void* partials, void* out,
                          void* sigma, void* stream) {
  DOTK2_DISPATCH(dotk2::launch_trial, F0, Fp, alpha, u, lam, w, n, partials, out,
                 sigma, (cudaStream_t)stream)
}

int dot_trial2d_partials(int n) { return dotk2::blocks(n, dotk2::kRedThreads); }

// x, x_tilta, out (n_vert, 3); freev, mass (n_vert,); inc_perm (3 n,) the
// incidences element * 3 + corner sorted by vertex, inc_off (n_vert + 1,);
// ge: (6, n) scratch.
int dot_elem_gradient2d(int dtype, int mat, const void* x, const void* x_tilta,
                        const void* freev, const void* mass, const void* conn,
                        const void* g4, const void* u, const void* lam,
                        const void* w, double dt_sq, int n, const void* inc_perm,
                        const void* inc_off, long long n_vert, void* ge,
                        void* out, void* stream) {
  if (n == 0 || n_vert == 0) return 1;
  DOTK2_DISPATCH(dotk2::launch_grad, x, x_tilta, freev, mass, (const int*)conn,
                 g4, u, lam, w, dt_sq, n, (const int64_t*)inc_perm,
                 (const int64_t*)inc_off, n_vert, ge, out, (cudaStream_t)stream)
}

// F0, Fp: (4, n); alpha, out: (n_parts,); partials: n_parts *
// dot_trial2d_partials(n / n_parts) values; n is a multiple of n_parts.
int dot_ls_trial_energy2d_parts(int dtype, int mat, const void* F0,
                                const void* Fp, const void* alpha,
                                const void* u, const void* lam, const void* w,
                                int n, int n_parts, void* partials, void* out,
                                void* stream) {
  if (n_parts < 1 || n == 0 || n % n_parts != 0) return 1;
  DOTK2_DISPATCH(dotk2::launch_trial_parts, F0, Fp, alpha, u, lam, w, n,
                 n_parts, partials, out, (cudaStream_t)stream)
}

// F, g4: (4, n); u, lam, w: (n,); inc_perm (3 n,) incidences e*3 + c sorted
// by row, inc_off (n_rows + 1,); ge: (6, n) scratch; out (n_rows, 2).
int dot_elem_gradient2d_from_F(int dtype, int mat, const void* F,
                               const void* g4, const void* u, const void* lam,
                               const void* w, int n, const void* inc_perm,
                               const void* inc_off, long long n_rows, void* ge,
                               void* out, void* stream) {
  if (n == 0) return 1;
  DOTK2_DISPATCH(dotk2::launch_grad_from_F, F, g4, u, lam, w, n,
                 (const int64_t*)inc_perm, (const int64_t*)inc_off, n_rows, ge,
                 out, (cudaStream_t)stream)
}

// out (36, n): SPD-projected element Hessians times dt_sq.
int dot_elem_hessian2d(int dtype, int mat, const void* x, const void* conn,
                       const void* g4, const void* u, const void* lam,
                       const void* w, double dt_sq, int n, void* out,
                       void* stream) {
  if (n == 0) return 1;
  DOTK2_DISPATCH(dotk2::launch_hess, x, (const int*)conn, g4, u, lam, w, dt_sq, n,
                 out, (cudaStream_t)stream)
}

// H[slot] = H[slot] / d[row] / d[col] over the assembled slots, in place.
int dot_dense_scale2d(int dtype, void* H, const void* d, const void* udest,
                      long long n_slot, long long n2, void* stream) {
  auto st = (cudaStream_t)stream;
  if (n_slot == 0) return 0;
  const int nb = dotk2::blocks(n_slot, dotk2::kElemThreads);
  if (dtype == 0)
    dotk2::dense_scale2d_kernel<float><<<nb, dotk2::kElemThreads, 0, st>>>(
        (float*)H, (const float*)d, (const int64_t*)udest, n_slot, n2);
  else if (dtype == 1)
    dotk2::dense_scale2d_kernel<double><<<nb, dotk2::kElemThreads, 0, st>>>(
        (double*)H, (const double*)d, (const int64_t*)udest, n_slot, n2);
  else
    return 1;
  return (int)cudaGetLastError();
}

// F (4, n) -> U (4, n), s (2, n), V (4, n).
int dot_svd2_flip(int dtype, const void* F, int n, void* U, void* s, void* V,
                  void* stream) {
  auto st = (cudaStream_t)stream;
  if (n == 0) return 0;
  const int nb = dotk2::blocks(n, dotk2::kElemThreads);
  if (dtype == 0)
    dotk2::svd2_check_kernel<float><<<nb, dotk2::kElemThreads, 0, st>>>(
        (const float*)F, n, (float*)U, (float*)s, (float*)V);
  else if (dtype == 1)
    dotk2::svd2_check_kernel<double><<<nb, dotk2::kElemThreads, 0, st>>>(
        (const double*)F, n, (double*)U, (double*)s, (double*)V);
  else
    return 1;
  return (int)cudaGetLastError();
}

// h3 (3, n) packed sym2. With pd null: lam (2, n) and Q (4, n) of eigh2;
// with pd (3, n): make_pd2 (lam and Q untouched).
int dot_eigh2(int dtype, const void* h3, int n, void* lam, void* Q, void* pd,
              void* stream) {
  auto st = (cudaStream_t)stream;
  if (n == 0) return 0;
  const int nb = dotk2::blocks(n, dotk2::kElemThreads);
  if (dtype == 0)
    dotk2::eigh2_check_kernel<float><<<nb, dotk2::kElemThreads, 0, st>>>(
        (const float*)h3, n, (float*)lam, (float*)Q, (float*)pd);
  else if (dtype == 1)
    dotk2::eigh2_check_kernel<double><<<nb, dotk2::kElemThreads, 0, st>>>(
        (const double*)h3, n, (double*)lam, (double*)Q, (double*)pd);
  else
    return 1;
  return (int)cudaGetLastError();
}

// F (4, n), u, lam (n,) -> out (11, n).
int dot_material2d(int dtype, int mat, const void* F, const void* u,
                   const void* lam, int n, void* out, void* stream) {
  if (n == 0) return 1;
  DOTK2_DISPATCH(dotk2::launch_material, F, u, lam, n, out, (cudaStream_t)stream)
}

}  // extern "C"
