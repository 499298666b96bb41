// K13 hessian_diag: the (nV, 3) diagonal of M + dt^2 H from the block-major
// (144, nEp) element Hessians.
//
// Replaces dot_tpu/steppers/core.py:1587-1601 (System.hessian_diag: three
// gathers of rows (c*4+c)*9 + 4i by scat_perm and three sorted segment
// sums), which warmStart 5 divides the gradient by (core.py:1576-1582).
//
// Bound on the H100: memory. 12 of the 144 rows of elem_h are read once
// (12 nEp entries) plus the incidence list; at bar17 (86,016 tets) that is
// ~4 MB in f32, ~1.3 us at 3.35 TB/s, so a launch costs more than its
// bytes.
//
// Design: one thread per (vertex, coordinate). It walks the vertex's run of
// (element, corner) incidences, sorted by vertex on the host (CSR offsets),
// adds the diagonal entries in that fixed order and adds the mass last, as
// the plain version's sequential index_add_ and `+ mass` do. No atomics:
// the result divides a gradient. Padding elements scatter to the dump
// vertex nV, whose run is never read.

#include <cuda_runtime.h>

#include <cstdint>

namespace dotk13 {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
hessian_diag_kernel(const T* __restrict__ elem_h, int64_t n_ep,
                    const int64_t* __restrict__ perm,
                    const int64_t* __restrict__ seg_off,
                    const T* __restrict__ mass, int64_t n_vert,
                    T* __restrict__ out) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_vert * 3) return;
  const int64_t v = t / 3;
  const int i = static_cast<int>(t - v * 3);
  T s = T(0);
  const int64_t end = seg_off[v + 1];
  for (int64_t k = seg_off[v]; k < end; ++k) {
    const int64_t item = perm[k];          // element * 4 + corner
    const int64_t e = item >> 2;
    const int c = static_cast<int>(item & 3);
    s += elem_h[static_cast<int64_t>((c * 4 + c) * 9 + 4 * i) * n_ep + e];
  }
  out[t] = s + mass[v];
}

}  // namespace dotk13

// elem_h (144, n_ep); perm: incidences e*4+c sorted by vertex; seg_off
// (n_vert + 2,) their CSR offsets; mass (n_vert,); out (n_vert, 3).
extern "C" int dot_hessian_diag(int dtype, const void* elem_h, long long n_ep,
                                const void* perm, const void* seg_off,
                                const void* mass, long long n_vert, void* out,
                                void* stream) {
  if (n_vert == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<const int64_t*>(perm);
  auto so = static_cast<const int64_t*>(seg_off);
  const unsigned nb = static_cast<unsigned>(
      (n_vert * 3 + dotk13::kThreads - 1) / dotk13::kThreads);
  if (dtype == 0)
    dotk13::hessian_diag_kernel<float><<<nb, dotk13::kThreads, 0, s>>>(
        static_cast<const float*>(elem_h), n_ep, pm, so,
        static_cast<const float*>(mass), n_vert, static_cast<float*>(out));
  else
    dotk13::hessian_diag_kernel<double><<<nb, dotk13::kThreads, 0, s>>>(
        static_cast<const double*>(elem_h), n_ep, pm, so,
        static_cast<const double*>(mass), n_vert, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
