// K14 pd_assemble: the whole-mesh scalar matrix M + dt^2 D^T W D of
// LBFGS-PD in its RCM-banded block-tridiagonal storage.
//
// Replaces dot_tpu/steppers/core.py:1656-1667 (_pd_pair_vals: 16 values
// w_e sum_i D_a,i D_b,i per element, masked free x free) and the
// scatter-adds of 1669-1686 (_build_pd_factor: pair values into the flat
// [diag | sub] band, mass or 1 on the diagonal, 1 on padding rows). Its
// solve, pd_solve, is one launch of K7's solve entry (block_matvec.cu,
// the program kind "pd").
//
// Bound on the H100: memory, and it does not matter: pd_assemble runs once
// per change of the Dirichlet set. Its items (16 per element, less the
// upper block neighbours and pads) are read once, 8 B each, with the 9
// restTriInv entries, the weight and 4 free flags of their element; at
// bar17 ~1.2M items, ~20 MB. What matters is that a factorization reads the
// sums: they are reduced in a fixed order.
//
// Design: the host sorts the items by destination (stable, so each run
// keeps the plain version's pair-major element order) and hands over CSR
// runs. One thread per destination recomputes its items' values from g9
// (corner 0 of D is minus the column sum), w and the free mask, rounding
// step by step as the plain version does (-fmad=false), and writes the
// sum. A second launch adds mass * free + (1 - free) on the vertex
// diagonals and writes the padding rows' ones. No atomics.

#include <cuda_runtime.h>

#include <cstdint>

namespace dotk14 {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T corner(const T* __restrict__ g9, int64_t n_ep,
                                    int64_t e, int c, int j) {
  if (c > 0) return g9[static_cast<int64_t>((c - 1) * 3 + j) * n_ep + e];
  return -((g9[static_cast<int64_t>(j) * n_ep + e]
            + g9[static_cast<int64_t>(3 + j) * n_ep + e])
           + g9[static_cast<int64_t>(6 + j) * n_ep + e]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pd_reduce_kernel(const T* __restrict__ g9, const int* __restrict__ conn,
                 const T* __restrict__ w, const T* __restrict__ freev,
                 int64_t n_ep, const int64_t* __restrict__ items,
                 const int64_t* __restrict__ seg_off,
                 const int64_t* __restrict__ udest, int64_t n_dest,
                 T* __restrict__ flat) {
  const int64_t u = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (u >= n_dest) return;
  T s = T(0);
  const int64_t end = seg_off[u + 1];
  for (int64_t k = seg_off[u]; k < end; ++k) {
    const int64_t item = items[k];          // pair * n_ep + element
    const int pair = static_cast<int>(item / n_ep);
    const int64_t e = item - static_cast<int64_t>(pair) * n_ep;
    const int a = pair >> 2, b = pair & 3;
    T dd = corner(g9, n_ep, e, a, 0) * corner(g9, n_ep, e, b, 0);
    dd += corner(g9, n_ep, e, a, 1) * corner(g9, n_ep, e, b, 1);
    dd += corner(g9, n_ep, e, a, 2) * corner(g9, n_ep, e, b, 2);
    const T fa = freev[conn[static_cast<int64_t>(a) * n_ep + e]];
    const T fb = freev[conn[static_cast<int64_t>(b) * n_ep + e]];
    s += w[e] * dd * fa * fb;
  }
  flat[udest[u]] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pd_diag_kernel(const T* __restrict__ mass, const T* __restrict__ freev,
               const int64_t* __restrict__ diag_dest, int64_t n_vert,
               const int64_t* __restrict__ pad_dest, int64_t n_pad,
               T* __restrict__ flat) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t < n_vert) {
    const T f = freev[t];
    flat[diag_dest[t]] += mass[t] * f + (T(1) - f);
  } else if (t < n_vert + n_pad) {
    flat[pad_dest[t - n_vert]] = T(1);
  }
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
int assemble(const void* g9, const void* conn, const void* w,
             const void* freev, const void* mass, long long n_ep,
             const void* items, const void* seg_off, const void* udest,
             long long n_dest, const void* diag_dest, long long n_vert,
             const void* pad_dest, long long n_pad, void* flat,
             cudaStream_t s) {
  auto fr = static_cast<const T*>(freev);
  auto out = static_cast<T*>(flat);
  if (n_dest > 0) {
    pd_reduce_kernel<T><<<blocks_for(n_dest), kThreads, 0, s>>>(
        static_cast<const T*>(g9), static_cast<const int*>(conn),
        static_cast<const T*>(w), fr, n_ep,
        static_cast<const int64_t*>(items),
        static_cast<const int64_t*>(seg_off),
        static_cast<const int64_t*>(udest), n_dest, out);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_vert + n_pad > 0)
    pd_diag_kernel<T><<<blocks_for(n_vert + n_pad), kThreads, 0, s>>>(
        static_cast<const T*>(mass), fr,
        static_cast<const int64_t*>(diag_dest), n_vert,
        static_cast<const int64_t*>(pad_dest), n_pad, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk14

// g9 (9, n_ep); conn (4, n_ep) int32 gather ids; w (n_ep,); freev, mass
// (n_vert,); items sorted by destination with CSR offsets seg_off
// (n_dest + 1,) and destinations udest (n_dest,); flat: the zeroed band.
extern "C" int dot_pd_assemble(int dtype, const void* g9, const void* conn,
                               const void* w, const void* freev,
                               const void* mass, long long n_ep,
                               const void* items, const void* seg_off,
                               const void* udest, long long n_dest,
                               const void* diag_dest, long long n_vert,
                               const void* pad_dest, long long n_pad,
                               void* flat, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dotk14::assemble<float>(g9, conn, w, freev, mass, n_ep, items,
                                   seg_off, udest, n_dest, diag_dest, n_vert,
                                   pad_dest, n_pad, flat, s);
  return dotk14::assemble<double>(g9, conn, w, freev, mass, n_ep, items,
                                  seg_off, udest, n_dest, diag_dest, n_vert,
                                  pad_dest, n_pad, flat, s);
}
