// K25-K28: the kernels of the 2D decomposed path (DOT, GSDD, LBFGS-PD / H /
// HI / JH at dim 2), with a plain C interface (loaded through ctypes by
// ops.py). The plain PyTorch versions are in kernels/dd2d.py.
//
// Layouts: x, p: (nV, 3) with z = 0; corner ids (3, N) int32; restTriInv
// (4, N); the element Hessians (36, N) row-major over the (corner, xy) dofs
// (K23's order: row r*6 + c holds H[r][c]); the subdomain matrices
// (P, n, n) row-major, slot p*n*n + r*n + c; d (P, n).
//
// K25 quadratic_form2d -- replaces System2D.quadratic_form with its corner
//   gather and defgrad_from_corners (dot_tpu/dim2.py:520-530, 557-565),
//   the DOT alpha-init's p^T H p + sum m |p|^2 and F(p). Bound: bytes, the
//   36 Hessian values per triangle (2.9 MB in f32 at 20K triangles): a few
//   microseconds, so the launch sets the time. Design: K21's. One thread
//   per triangle gathers p's six in-plane corner values, writes F(p) and
//   sums (H[r][c] p_r) p_c; the same thread adds the mass term of the vertex
//   with its index; each block reduces in shared memory and a one-block pass
//   sums the partials in a fixed order (no atomics: the sum sets the line
//   search's first step).
// K26 subdomain_assemble2d / subdomain_scale2d -- replaces
//   System2D.assemble_subdomains (dim2.py:588-602) and the equilibration
//   of factorize_fast (:604-616). Bound: bytes, the (P, n2p, n2p) matrices
//   written once (0.45 GB in f32 at P 4, n2p ~5,300; 1.66 GB at P 1). Design:
//   K24's on a batch. One zero fill (16 B stores); one thread per assembled
//   slot (the plan's destinations made unique on the host, with every
//   diagonal slot, so padding rows get their unit diagonal) sums its run of
//   element entries in plan order, applies the free mask of row and column,
//   adds mass_img f + (1 - f) on the diagonal and writes d = sqrt(diag). The
//   second entry scales the same slots in place: 0 stays 0, so the rest of
//   the matrix is neither read nor written. It writes the symmetrized value
//   ((h / d_r) / d_c + (h / d_c) / d_r) / 2: the matrix jnp.linalg.cholesky
//   factors in dot_tpu (it symmetrizes its input), from h alone, because a
//   slot and its mirror sum the same values in the same order (every local
//   corner of a completed element is shared, so each completion tuple has
//   its mirror) and hold the same h.
// K27 h0_gather2d / h0_average2d / local_gather_one2d / local_scatter_one2d
//   -- K8's and K16's twins at two dofs per vertex with z = 0: the gather of
//   h0_apply (dim2.py:645-651) and its duplicate averaging (:652-658), and
//   one subdomain's gather and scatter of the GSDD sweep (:631-643). Bound:
//   bytes and launch latency (well under 1 MB a pass). Design: the gather
//   has one thread per local scalar; the averaging one thread per vertex
//   walking its run of the host-sorted gather permutation in order (the
//   dump segment nV of the padding slots is never read); the scatter zeroes
//   the direction and writes the valid local vertices only, so a padded
//   slot (l2g 0) leaves vertex 0 alone, as dot_tpu's dump row nV does.
// K28 pd_assemble2d / hessian_diag2d -- replaces System2D._build_pd_factor's
//   assembly of M + dt^2 D^T W D (dim2.py:704-726; the scaling is K26's
//   second entry on the same slots) and hessian_diag (:567-580). Bound:
//   bytes, the (nV)^2 scalar matrix written once (414 MB in f32 at 10,171
//   vertices). Design: K26's slot kernel with one dof per vertex, after one
//   thread per triangle has written the nine pair values w_e (D_a . D_b) to
//   a (9, N) scratch. hessian_diag2d is K13's twin: one thread per vertex
//   sums the (c, c) diagonal entries over its vertex-sorted incidences in
//   order, + mass, with a z column of 1.
//
// Two more entry points of K26's slot kernel serve 2D ADMM-DD (plain versions
// in kernels/admm2d.py):
// dot_w_assemble2d -- replaces _weights' scatters (dim2.py:1130-1146) and
//   _w_masked (:1150-1152): the interface weights W (P, n2p, n2p) summed
//   over the completion tuples' slots with the free mask on rows and columns
//   (masking the sums gives dot_tpu's mask-after-scatter values) and no
//   diagonal term; and the consensus matrix C (ns2, ns2) over the same
//   values: K26's slot pass with the shared vertices' mass difference on
//   the diagonal, their free mask, a unit diagonal at fixed and dump rows,
//   and dc = sqrt(diag C). Bound: bytes, W's zero fill (0.44 GB in f32 at
//   P 4, n2p 5,248).
// dot_local_h_assemble2d -- replaces _local_h_factor's assembly
//   (dim2.py:1219-1232): K26's slot pass over the own triangles' blocks
//   (the local Hessians K23 computes at the local positions), the free mask,
//   + the masked W read at the same slot, + (mass_local + mass_dif f) f +
//   (1 - f) on the diagonal, and d. Its slot list is the union of the own
//   and W slots, so K26's scaling entry on the same tables reaches every
//   nonzero of the matrix; W is symmetric bit for bit (a slot and its
//   mirror sum the same tuples in the same order), so the sum is too.
//
// Built with -fmad=false: products and sums round one by one, as the plain
// versions' elementwise ops do.

#include <cuda_runtime.h>

#include <cstdint>

namespace dotdd {

constexpr int kRedThreads = 256;   // K25 block size (power of two)
constexpr int kThreads = 128;
constexpr int kFillBlocks = 132 * 8;

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
__global__ void __launch_bounds__(kRedThreads)
sum_partials_kernel(const T* __restrict__ partials, int m, T* __restrict__ out) {
  T v = T(0);
  for (int i = threadIdx.x; i < m; i += kRedThreads) v += partials[i];
  block_sum_store(v, out);
}

// ---- K25 ------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
quadratic_form2d_kernel(const T* __restrict__ p, const int* __restrict__ conn,
                        const T* __restrict__ g4, const T* __restrict__ H,
                        const T* __restrict__ mass, int n, int64_t n_vert,
                        T* __restrict__ Fp, T* __restrict__ partials) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kRedThreads) + threadIdx.x;
  T v = T(0);
  if (t < n) {
    const int e = static_cast<int>(t);
    T pe[6], g[4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int64_t vc = conn[c * n + e];
      pe[c * 2] = p[vc * 3];
      pe[c * 2 + 1] = p[vc * 3 + 1];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] = g4[k * n + e];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        Fp[(2 * i + j) * n + e] =
            (pe[2 + i] - pe[i]) * g[j] + (pe[4 + i] - pe[i]) * g[2 + j];
    T q = T(0);
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c)
        q = q + H[static_cast<int64_t>(r * 6 + c) * n + e] * pe[r] * pe[c];
    v = q;
  }
  if (t < n_vert) {
    const T m = mass[t];
    T qm = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) qm = qm + m * p[t * 3 + c] * p[t * 3 + c];
    v = v + qm;
  }
  block_sum_store(v, partials + blockIdx.x);
}

// ---- K26 / K28: zero fill, slot sums, symmetric scaling --------------------
__global__ void __launch_bounds__(kRedThreads)
zero_fill_kernel(unsigned char* __restrict__ p, int64_t bytes) {
  const int64_t n16 = bytes / 16;
  uint4* q = reinterpret_cast<uint4*>(p);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const int64_t gid = blockIdx.x * static_cast<int64_t>(kRedThreads) + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kRedThreads;
  for (int64_t i = gid; i < n16; i += step) q[i] = z;
  if (gid < bytes - n16 * 16) p[n16 * 16 + gid] = 0;
}

// one thread per slot p*n*n + r*n + c; DOF dofs per vertex (free and mass
// are per local vertex: (P, n_loc)); wadd (null or (P, n, n)): added at the
// slot after the mask; mass null: no diagonal term and no d
template <typename T, int DOF>
__global__ void __launch_bounds__(kThreads)
slots_kernel(const T* __restrict__ vals, const int64_t* __restrict__ items,
             const int64_t* __restrict__ seg_off,
             const int64_t* __restrict__ udest, int64_t n_slot,
             const T* __restrict__ freev, const T* __restrict__ mass,
             const T* __restrict__ wadd, int64_t n_loc, int64_t n,
             T* __restrict__ H, T* __restrict__ d) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_slot) return;
  T s = T(0);
  const int64_t end = seg_off[t + 1];
  for (int64_t k = seg_off[t]; k < end; ++k) s += vals[items[k]];
  const int64_t slot = udest[t];
  const int64_t nn = n * n;
  const int64_t p = slot / nn;
  const int64_t rem = slot - p * nn;
  const int64_t r = rem / n, c = rem - r * n;
  const int64_t base = p * n_loc;
  const T fr = freev[base + r / DOF], fc = freev[base + c / DOF];
  s = s * fr * fc;
  if (wadd != nullptr) s = s + wadd[slot];
  if (r == c && mass != nullptr) {
    s = s + (mass[base + r / DOF] * fr + (T(1) - fr));
    d[p * n + r] = sqrt(s);
  }
  H[slot] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_scale_kernel(T* __restrict__ H, const T* __restrict__ d,
                 const int64_t* __restrict__ udest, int64_t n_slot, int64_t n) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_slot) return;
  const int64_t slot = udest[t];
  const int64_t nn = n * n;
  const int64_t p = slot / nn;
  const int64_t rem = slot - p * nn;
  const int64_t r = rem / n, c = rem - r * n;
  const T ir = T(1) / d[p * n + r], ic = T(1) / d[p * n + c];
  const T h = H[slot];
  H[slot] = (h * ir * ic + h * ic * ir) / T(2);
}

// K28: vals (9, n), row a*3 + b = w (D_a . D_b); D_0 = -(row 0 + row 1) of
// restTriInv, D_{k+1} = row k
template <typename T>
__global__ void __launch_bounds__(kThreads)
pd_pair_vals_kernel(const T* __restrict__ g4, const T* __restrict__ w, int n,
                    T* __restrict__ vals) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  T g[4], D[3][2];
#pragma unroll
  for (int k = 0; k < 4; ++k) g[k] = g4[k * n + e];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    D[0][j] = -(g[j] + g[2 + j]);
    D[1][j] = g[j];
    D[2][j] = g[2 + j];
  }
  const T we = w[e];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      vals[(a * 3 + b) * n + e] = we * (D[a][0] * D[b][0] + D[a][1] * D[b][1]);
}

// ---- K27 ------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather2d_kernel(const T* __restrict__ rhs, const int64_t* __restrict__ l2g,
                const unsigned char* __restrict__ valid,
                const T* __restrict__ d, int64_t n_loc, T* __restrict__ r) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_loc * 2) return;
  const int64_t i = t >> 1;
  r[t] = rhs[l2g[i] * 3 + (t & 1)] * T(valid[i]) / d[t];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
average2d_kernel(const T* __restrict__ z, const T* __restrict__ d,
                 const int64_t* __restrict__ perm,
                 const int64_t* __restrict__ seg_off, const T* __restrict__ dup,
                 int64_t n_vert, T* __restrict__ out) {
  const int64_t v = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (v >= n_vert) return;
  T s0 = T(0), s1 = T(0);
  const int64_t end = seg_off[v + 1];
  for (int64_t k = seg_off[v]; k < end; ++k) {
    const int64_t j = perm[k] * 2;
    s0 += z[j] / d[j];
    s1 += z[j + 1] / d[j + 1];
  }
  const T du = dup[v];
  out[v * 3] = s0 / du;
  out[v * 3 + 1] = s1 / du;
  out[v * 3 + 2] = T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter2d_kernel(const T* __restrict__ z, const T* __restrict__ d,
                 const int64_t* __restrict__ l2g,
                 const unsigned char* __restrict__ valid, int64_t n_loc,
                 T* __restrict__ out) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_loc * 2) return;
  const int64_t i = t >> 1;
  if (!valid[i]) return;
  out[l2g[i] * 3 + (t & 1)] = z[t] / d[t];
}

// K28's second entry: one thread per vertex over its (element, corner)
// incidences e*3 + c, sorted by vertex
template <typename T>
__global__ void __launch_bounds__(kThreads)
hessian_diag2d_kernel(const T* __restrict__ H, int64_t n,
                      const int64_t* __restrict__ inc_perm,
                      const int64_t* __restrict__ inc_off,
                      const T* __restrict__ mass, int64_t n_vert,
                      T* __restrict__ out) {
  const int64_t v = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (v >= n_vert) return;
  T a0 = T(0), a1 = T(0);
  const int64_t end = inc_off[v + 1];
  for (int64_t k = inc_off[v]; k < end; ++k) {
    const int64_t inc = inc_perm[k];
    const int64_t e = inc / 3;
    const int c = static_cast<int>(inc - e * 3);
    a0 += H[static_cast<int64_t>(c * 14) * n + e];        // (2c, 2c)
    a1 += H[static_cast<int64_t>(c * 14 + 7) * n + e];    // (2c+1, 2c+1)
  }
  const T m = mass[v];
  out[v * 3] = a0 + m;
  out[v * 3 + 1] = a1 + m;
  out[v * 3 + 2] = T(1);
}

// ---- launchers ------------------------------------------------------------
template <typename T>
int assemble(const void* vals, const void* items, const void* seg_off,
             const void* udest, long long n_slot, const void* freev,
             const void* mass, const void* wadd, long long n_loc, long long n,
             long long n_parts, int dof, void* H, void* d, cudaStream_t st) {
  if (n <= 0 || n_parts <= 0 || (dof != 1 && dof != 2)) return 1;
  const int64_t bytes = n_parts * n * n * static_cast<int64_t>(sizeof(T));
  zero_fill_kernel<<<kFillBlocks, kRedThreads, 0, st>>>(
      static_cast<unsigned char*>(H), bytes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_slot == 0) return 0;
  const int nb = blocks(n_slot, kThreads);
  auto it = static_cast<const int64_t*>(items);
  auto so = static_cast<const int64_t*>(seg_off);
  auto ud = static_cast<const int64_t*>(udest);
  if (dof == 2)
    slots_kernel<T, 2><<<nb, kThreads, 0, st>>>(
        (const T*)vals, it, so, ud, n_slot, (const T*)freev, (const T*)mass,
        (const T*)wadd, n_loc, n, (T*)H, (T*)d);
  else
    slots_kernel<T, 1><<<nb, kThreads, 0, st>>>(
        (const T*)vals, it, so, ud, n_slot, (const T*)freev, (const T*)mass,
        (const T*)wadd, n_loc, n, (T*)H, (T*)d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pd_assemble(const void* g4, const void* w, int n_elem, void* vals,
                const void* items, const void* seg_off, const void* udest,
                long long n_slot, const void* freev, const void* mass,
                long long n_vert, void* H, void* d, cudaStream_t st) {
  if (n_elem <= 0) return 1;
  pd_pair_vals_kernel<T><<<blocks(n_elem, kThreads), kThreads, 0, st>>>(
      (const T*)g4, (const T*)w, n_elem, (T*)vals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return assemble<T>(vals, items, seg_off, udest, n_slot, freev, mass, nullptr,
                     n_vert, n_vert, 1, 1, H, d, st);
}

// W then C (2 dofs a vertex): W without a diagonal term, C as K26
template <typename T>
int w_assemble(const void* vals, const void* w_items, const void* w_seg_off,
               const void* w_udest, long long w_n_slot, const void* freev,
               long long n_loc, long long n, long long n_parts, void* W,
               const void* c_items, const void* c_seg_off, const void* c_udest,
               long long c_n_slot, const void* sfree, const void* md_sh,
               long long c_n, void* C, void* dc, cudaStream_t st) {
  const int e = assemble<T>(vals, w_items, w_seg_off, w_udest, w_n_slot, freev,
                            nullptr, nullptr, n_loc, n, n_parts, 2, W, nullptr,
                            st);
  if (e != 0) return e;
  return assemble<T>(vals, c_items, c_seg_off, c_udest, c_n_slot, sfree, md_sh,
                     nullptr, c_n / 2, c_n, 1, 2, C, dc, st);
}

}  // namespace dotdd

// dtype: 0 float32, 1 float64. Each entry returns the cudaGetLastError() of
// its launches (0 = cudaSuccess); a bad code or shape gives 1.
extern "C" {

int dot_qf2d_partials(int n, long long n_vert) {
  return dotdd::blocks(n > n_vert ? n : n_vert, dotdd::kRedThreads);
}

// p (n_vert, 3); conn (3, n) int32; g4 (4, n); H (36, n); mass (n_vert,);
// Fp (4, n) written; partials: dot_qf2d_partials values; out 0-d.
int dot_quadratic_form2d(int dtype, const void* p, const void* conn,
                         const void* g4, const void* H, const void* mass, int n,
                         long long n_vert, void* Fp, void* partials, void* out,
                         void* stream) {
  if (n <= 0) return 1;
  auto st = (cudaStream_t)stream;
  const int nb = dot_qf2d_partials(n, n_vert);
  auto cn = (const int*)conn;
  const int nt = dotdd::kRedThreads;
  if (dtype == 0) {
    dotdd::quadratic_form2d_kernel<float><<<nb, nt, 0, st>>>(
        (const float*)p, cn, (const float*)g4, (const float*)H,
        (const float*)mass, n, n_vert, (float*)Fp, (float*)partials);
    dotdd::sum_partials_kernel<float><<<1, nt, 0, st>>>(
        (const float*)partials, nb, (float*)out);
  } else if (dtype == 1) {
    dotdd::quadratic_form2d_kernel<double><<<nb, nt, 0, st>>>(
        (const double*)p, cn, (const double*)g4, (const double*)H,
        (const double*)mass, n, n_vert, (double*)Fp, (double*)partials);
    dotdd::sum_partials_kernel<double><<<1, nt, 0, st>>>(
        (const double*)partials, nb, (double*)out);
  } else {
    return 1;
  }
  return (int)cudaGetLastError();
}

// vals: the flat values items index; items (n_item,) sorted by slot,
// seg_off (n_slot + 1,), udest (n_slot,) slots p*n*n + r*n + c (every
// diagonal slot among them); freev, mass (n_parts, n_loc); H (n_parts, n, n)
// and d (n_parts, n) are written; dof: 1 or 2 (n = dof * n_loc).
int dot_subdomain_assemble2d(int dtype, const void* vals, const void* items,
                             const void* seg_off, const void* udest,
                             long long n_slot, const void* freev,
                             const void* mass, long long n_loc, long long n,
                             long long n_parts, int dof, void* H, void* d,
                             void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return dotdd::assemble<float>(vals, items, seg_off, udest, n_slot, freev,
                                  mass, nullptr, n_loc, n, n_parts, dof, H, d,
                                  st);
  if (dtype == 1)
    return dotdd::assemble<double>(vals, items, seg_off, udest, n_slot, freev,
                                   mass, nullptr, n_loc, n, n_parts, dof, H, d,
                                   st);
  return 1;
}

// vals (36, nE) row-major element Hessians; W's slot tables (P, n, n) with
// freev (P, n_loc); C's (one part, c_n = 2 (ns + 1)) with sfree, md_sh
// (ns + 1,). W (P, n, n), C (c_n, c_n) and dc (c_n,) are written.
int dot_w_assemble2d(int dtype, const void* vals, const void* w_items,
                     const void* w_seg_off, const void* w_udest,
                     long long w_n_slot, const void* freev, long long n_loc,
                     long long n, long long n_parts, void* W,
                     const void* c_items, const void* c_seg_off,
                     const void* c_udest, long long c_n_slot, const void* sfree,
                     const void* md_sh, long long c_n, void* C, void* dc,
                     void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return dotdd::w_assemble<float>(vals, w_items, w_seg_off, w_udest,
                                    w_n_slot, freev, n_loc, n, n_parts, W,
                                    c_items, c_seg_off, c_udest, c_n_slot,
                                    sfree, md_sh, c_n, C, dc, st);
  if (dtype == 1)
    return dotdd::w_assemble<double>(vals, w_items, w_seg_off, w_udest,
                                     w_n_slot, freev, n_loc, n, n_parts, W,
                                     c_items, c_seg_off, c_udest, c_n_slot,
                                     sfree, md_sh, c_n, C, dc, st);
  return 1;
}

// vals (36, P epad) row-major own Hessians; the own slot tables (their
// slots cover W's); freev, mass (P, n_loc); Wm (P, n, n); H (P, n, n) and
// d (P, n) are written.
int dot_local_h_assemble2d(int dtype, const void* vals, const void* items,
                           const void* seg_off, const void* udest,
                           long long n_slot, const void* freev,
                           const void* mass, const void* Wm, long long n_loc,
                           long long n, long long n_parts, void* H, void* d,
                           void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return dotdd::assemble<float>(vals, items, seg_off, udest, n_slot, freev,
                                  mass, Wm, n_loc, n, n_parts, 2, H, d, st);
  if (dtype == 1)
    return dotdd::assemble<double>(vals, items, seg_off, udest, n_slot, freev,
                                   mass, Wm, n_loc, n, n_parts, 2, H, d, st);
  return 1;
}

// In place over the slots: H = ((H / d_r) / d_c + (H / d_c) / d_r) / 2.
int dot_subdomain_scale2d(int dtype, void* H, const void* d, const void* udest,
                          long long n_slot, long long n, void* stream) {
  if (n_slot == 0) return 0;
  auto st = (cudaStream_t)stream;
  const int nb = dotdd::blocks(n_slot, dotdd::kThreads);
  auto ud = (const int64_t*)udest;
  const int nt = dotdd::kThreads;
  if (dtype == 0)
    dotdd::sym_scale_kernel<float><<<nb, nt, 0, st>>>(
        (float*)H, (const float*)d, ud, n_slot, n);
  else if (dtype == 1)
    dotdd::sym_scale_kernel<double><<<nb, nt, 0, st>>>(
        (double*)H, (const double*)d, ud, n_slot, n);
  else
    return 1;
  return (int)cudaGetLastError();
}

// g4 (4, n_elem); w (n_elem,); vals (9, n_elem) scratch; the slot tables
// of the (n_vert)^2 matrix (items index vals); freev, mass (n_vert,);
// H (n_vert, n_vert) and d (n_vert,) are written.
int dot_pd_assemble2d(int dtype, const void* g4, const void* w, int n_elem,
                      void* vals, const void* items, const void* seg_off,
                      const void* udest, long long n_slot, const void* freev,
                      const void* mass, long long n_vert, void* H, void* d,
                      void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return dotdd::pd_assemble<float>(g4, w, n_elem, vals, items, seg_off,
                                     udest, n_slot, freev, mass, n_vert, H, d,
                                     st);
  if (dtype == 1)
    return dotdd::pd_assemble<double>(g4, w, n_elem, vals, items, seg_off,
                                      udest, n_slot, freev, mass, n_vert, H, d,
                                      st);
  return 1;
}

// rhs (nV, 3); l2g, valid: rows of n_loc local vertices, `part` selects
// the row (0 with n_loc = P N: all subdomains at once); d and r hold
// 2 n_loc values per row.
int dot_h0_gather2d(int dtype, const void* rhs, const void* l2g,
                    const void* valid, const void* d, long long part,
                    long long n_loc, void* r, void* stream) {
  if (n_loc == 0) return 0;
  auto st = (cudaStream_t)stream;
  auto idx = (const int64_t*)l2g + part * n_loc;
  auto val = (const unsigned char*)valid + part * n_loc;
  const int nb = dotdd::blocks(n_loc * 2, dotdd::kThreads);
  const int nt = dotdd::kThreads;
  if (dtype == 0)
    dotdd::gather2d_kernel<float><<<nb, nt, 0, st>>>(
        (const float*)rhs, idx, val, (const float*)d + part * n_loc * 2, n_loc,
        (float*)r);
  else if (dtype == 1)
    dotdd::gather2d_kernel<double><<<nb, nt, 0, st>>>(
        (const double*)rhs, idx, val, (const double*)d + part * n_loc * 2,
        n_loc, (double*)r);
  else
    return 1;
  return (int)cudaGetLastError();
}

// z, d (P, 2 N); perm (P N,) local slots sorted by vertex; seg_off
// (n_vert + 2,); dup (n_vert,); out (n_vert, 3).
int dot_h0_average2d(int dtype, const void* z, const void* d, const void* perm,
                     const void* seg_off, const void* dup, long long n_vert,
                     void* out, void* stream) {
  if (n_vert == 0) return 0;
  auto st = (cudaStream_t)stream;
  auto pm = (const int64_t*)perm;
  auto so = (const int64_t*)seg_off;
  const int nb = dotdd::blocks(n_vert, dotdd::kThreads);
  const int nt = dotdd::kThreads;
  if (dtype == 0)
    dotdd::average2d_kernel<float><<<nb, nt, 0, st>>>(
        (const float*)z, (const float*)d, pm, so, (const float*)dup, n_vert,
        (float*)out);
  else if (dtype == 1)
    dotdd::average2d_kernel<double><<<nb, nt, 0, st>>>(
        (const double*)z, (const double*)d, pm, so, (const double*)dup, n_vert,
        (double*)out);
  else
    return 1;
  return (int)cudaGetLastError();
}

// z (2 n_loc,); l2g, valid (P, n_loc); d (P, 2 n_loc); out (n_vert, 3),
// zeroed here.
int dot_local_scatter_one2d(int dtype, const void* z, const void* d,
                            const void* l2g, const void* valid, long long part,
                            long long n_loc, long long n_vert, void* out,
                            void* stream) {
  if (dtype != 0 && dtype != 1) return 1;
  auto st = (cudaStream_t)stream;
  const size_t sz = dtype == 0 ? sizeof(float) : sizeof(double);
  cudaError_t e = cudaMemsetAsync(out, 0, n_vert * 3 * sz, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_loc == 0) return 0;
  auto idx = (const int64_t*)l2g + part * n_loc;
  auto val = (const unsigned char*)valid + part * n_loc;
  const int nb = dotdd::blocks(n_loc * 2, dotdd::kThreads);
  const int nt = dotdd::kThreads;
  if (dtype == 0)
    dotdd::scatter2d_kernel<float><<<nb, nt, 0, st>>>(
        (const float*)z, (const float*)d + part * n_loc * 2, idx, val, n_loc,
        (float*)out);
  else
    dotdd::scatter2d_kernel<double><<<nb, nt, 0, st>>>(
        (const double*)z, (const double*)d + part * n_loc * 2, idx, val, n_loc,
        (double*)out);
  return (int)cudaGetLastError();
}

// H (36, n); inc_perm (3 n,) incidences e*3 + c sorted by vertex, inc_off
// (n_vert + 1,); mass (n_vert,); out (n_vert, 3).
int dot_hessian_diag2d(int dtype, const void* H, long long n,
                       const void* inc_perm, const void* inc_off,
                       const void* mass, long long n_vert, void* out,
                       void* stream) {
  if (n_vert == 0) return 0;
  auto st = (cudaStream_t)stream;
  auto ip = (const int64_t*)inc_perm;
  auto io = (const int64_t*)inc_off;
  const int nb = dotdd::blocks(n_vert, dotdd::kThreads);
  const int nt = dotdd::kThreads;
  if (dtype == 0)
    dotdd::hessian_diag2d_kernel<float><<<nb, nt, 0, st>>>(
        (const float*)H, n, ip, io, (const float*)mass, n_vert, (float*)out);
  else if (dtype == 1)
    dotdd::hessian_diag2d_kernel<double><<<nb, nt, 0, st>>>(
        (const double*)H, n, ip, io, (const double*)mass, n_vert,
        (double*)out);
  else
    return 1;
  return (int)cudaGetLastError();
}

}  // extern "C"
