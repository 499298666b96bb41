// K5 band_assemble: the block-tridiagonal H0 of every subdomain, from the
// (144, nEp) block-major element Hessians, in one pass.
//
// Replaces dot_tpu/steppers/core.py:676-706 (_assembly_compact: gather of
// 9-wide block rows + sorted segment_sum) and 733-774 (_band_compact: free
// mask, lumped mass / identity diagonal; _assemble_btd: scatter into the
// flat [diag | sub] band, upper-neighbour entries dropped).
//
// Bound on the H100: memory. At bar17 (86,016 tets, P 6) it reads ~1.4M
// 9-wide rows of elem_h (50 MB) and writes ~0.4M unique 3x3 blocks into a
// 354 MB band that is zeroed beforehand (the memset is the largest cost).
// The elem_h reads are 4 B each, nEp apart (block-major layout), so each
// costs a 32 B sector: ~0.4 GB of sector traffic, ~0.1 ms.
//
// Design: one thread per (unique block, component). It walks the block's
// run of the dest-sorted tuple list (CSR offsets computed once on the
// host) in order, so the sum is deterministic and rounds as the plain
// sequential index_add_ does; no atomics. The free mask, the diagonal and
// the scatter are applied in registers: no compact buffer is written.
// Threads below n_pad also set the unit diagonals of padding rows (disjoint
// from every block slot).

#include <cuda_runtime.h>

#include <cstdint>

namespace dotk5 {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_assemble_kernel(const T* __restrict__ eh, int64_t n_ep,
                     const int64_t* __restrict__ src_block,
                     const int64_t* __restrict__ seg_off,
                     const int64_t* __restrict__ ub_row,
                     const int64_t* __restrict__ ub_col,
                     const T* __restrict__ freef, const T* __restrict__ mass,
                     const int64_t* __restrict__ dest, int64_t n_ub,
                     const int64_t* __restrict__ pad_diag, int64_t n_pad,
                     int64_t total, T* __restrict__ band) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t < n_ub * 9) {
    const int64_t u = t / 9;
    const int q = static_cast<int>(t - u * 9);
    T s = T(0);
    const int64_t end = seg_off[u + 1];
    for (int64_t k = seg_off[u]; k < end; ++k) {
      const int64_t sb = src_block[k];          // elem * 16 + a * 4 + b
      const int64_t e = sb >> 4;
      const int ab = static_cast<int>(sb & 15);
      s += eh[static_cast<int64_t>(ab * 9 + q) * n_ep + e];
    }
    const int64_t r = ub_row[u];
    const int64_t c = ub_col[u];
    const T fr = freef[r];
    T v = s * (fr * freef[c]);
    if (r == c && (q == 0 || q == 4 || q == 8)) {
      v = v + (mass[r] * fr + (T(1) - fr));
    }
    const int64_t dd = dest[t];
    if (dd < total) band[dd] = v;
  }
  if (t < n_pad) band[pad_diag[t]] = T(1);
}

template <typename T>
int launch(const void* eh, int64_t n_ep, const int64_t* src_block,
           const int64_t* seg_off, const int64_t* ub_row,
           const int64_t* ub_col, const void* freef, const void* mass,
           const int64_t* dest, int64_t n_ub, const int64_t* pad_diag,
           int64_t n_pad, int64_t total, void* band, cudaStream_t stream) {
  const int64_t n = n_ub * 9 > n_pad ? n_ub * 9 : n_pad;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  band_assemble_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const T*>(eh), n_ep, src_block, seg_off, ub_row, ub_col,
      static_cast<const T*>(freef), static_cast<const T*>(mass), dest, n_ub,
      pad_diag, n_pad, total, static_cast<T*>(band));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk5

extern "C" int dot_band_assemble(int dtype, const void* eh, long long n_ep,
                                 const void* src_block, const void* seg_off,
                                 const void* ub_row, const void* ub_col,
                                 const void* freef, const void* mass,
                                 const void* dest, long long n_ub,
                                 const void* pad_diag, long long n_pad,
                                 long long total, void* band, void* stream) {
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dotk5::launch<float>(eh, n_ep, i64(src_block), i64(seg_off),
                                i64(ub_row), i64(ub_col), freef, mass,
                                i64(dest), n_ub, i64(pad_diag), n_pad, total,
                                band, s);
  return dotk5::launch<double>(eh, n_ep, i64(src_block), i64(seg_off),
                               i64(ub_row), i64(ub_col), freef, mass,
                               i64(dest), n_ub, i64(pad_diag), n_pad, total,
                               band, s);
}
