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
//
// Second entry point, dot_band_compact: the same values written to the
// (nUB, 9) compact instead of the band (core.py:733-748 _band_compact), for
// the chunked rebuild, whose band K12 (band_equil.cu) writes.
//
// K19 own_band_assemble (ADMM-DD's augmented local Hessian) is this source
// too. It replaces dot_tpu/steppers/core.py:811-839 (assemble_own_btd_flat:
// the same two-stage scheme over the OWN-element tuples, with the subdomain
// lumped mass) and the two adds of dot_tpu/steppers/admm_dd.py:348-361
// (+ the masked compact W at w_band_dest in drop mode, + the masked
// mass-diff diagonal at md_band_diag). Its first launch is
// band_assemble_kernel on the own-element tables; its second and third are
// dot_band_add_w below: one thread per W entry adds w free[row] free[col]
// to its band slot (the slots are unique; a slot >= total marks an entry of
// an upper-neighbour block, whose transpose lives in `sub`, and is
// skipped), then one thread per local dof adds md3 free to its diagonal
// slot. Two kernels, in that order, because a diagonal W entry and the
// mass-diff term share a slot: each slot is then summed as the plain
// version sums it ((own + W) + md), with no atomics -- a Cholesky reads
// the result. Bound: memory, as K5 (the zeroed 354 MB band at bar17
// dominates); the W pass moves ~0.4M entries x 36 B.

#include <cuda_runtime.h>

#include <cstdint>

namespace dotk5 {

constexpr int kThreads = 256;

// The finished value of entry t = u * 9 + q of the compact.
template <typename T>
__device__ __forceinline__ T block_value(
    int64_t t, const T* __restrict__ eh, int64_t n_ep,
    const int64_t* __restrict__ src_block,
    const int64_t* __restrict__ seg_off, const int64_t* __restrict__ ub_row,
    const int64_t* __restrict__ ub_col, const T* __restrict__ freef,
    const T* __restrict__ mass) {
  const int64_t u = t / 9;
  const int q = static_cast<int>(t - u * 9);
  T s = T(0);
  const int64_t end = seg_off[u + 1];
  for (int64_t k = seg_off[u]; k < end; ++k) {
    const int64_t sb = src_block[k];            // elem * 16 + a * 4 + b
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
  return v;
}

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
    const T v = block_value(t, eh, n_ep, src_block, seg_off, ub_row, ub_col,
                            freef, mass);
    const int64_t dd = dest[t];
    if (dd < total) band[dd] = v;
  }
  if (t < n_pad) band[pad_diag[t]] = T(1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_compact_kernel(const T* __restrict__ eh, int64_t n_ep,
                    const int64_t* __restrict__ src_block,
                    const int64_t* __restrict__ seg_off,
                    const int64_t* __restrict__ ub_row,
                    const int64_t* __restrict__ ub_col,
                    const T* __restrict__ freef, const T* __restrict__ mass,
                    int64_t n_ub, T* __restrict__ compact) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t < n_ub * 9)
    compact[t] = block_value(t, eh, n_ep, src_block, seg_off, ub_row, ub_col,
                             freef, mass);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_add_w_kernel(const T* __restrict__ w_vals, const T* __restrict__ free3f,
                  const int64_t* __restrict__ row,
                  const int64_t* __restrict__ col,
                  const int64_t* __restrict__ band_dest, int64_t n_w,
                  int64_t total, T* __restrict__ band) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_w) return;
  const int64_t dd = band_dest[t];
  if (dd < total) band[dd] += w_vals[t] * free3f[row[t]] * free3f[col[t]];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_add_md_kernel(const T* __restrict__ md3, const T* __restrict__ free3f,
                   const int64_t* __restrict__ md_band_diag, int64_t n_rows,
                   T* __restrict__ band) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t < n_rows) band[md_band_diag[t]] += md3[t] * free3f[t];
}

template <typename T>
int launch_add_w(const void* w_vals, const void* free3f, const int64_t* row,
                 const int64_t* col, const int64_t* band_dest, int64_t n_w,
                 const void* md3, const int64_t* md_band_diag, int64_t n_rows,
                 int64_t total, void* band, cudaStream_t stream) {
  if (n_w > 0)
    band_add_w_kernel<T><<<static_cast<unsigned>((n_w + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(
        static_cast<const T*>(w_vals), static_cast<const T*>(free3f), row, col,
        band_dest, n_w, total, static_cast<T*>(band));
  if (n_rows > 0)
    band_add_md_kernel<T><<<
        static_cast<unsigned>((n_rows + kThreads - 1) / kThreads), kThreads, 0,
        stream>>>(static_cast<const T*>(md3), static_cast<const T*>(free3f),
                  md_band_diag, n_rows, static_cast<T*>(band));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk5

// K19's W pass on an assembled band: w_vals, row, col, band_dest: (n_w,);
// free3f, md3, md_band_diag: (n_rows,); band: (total,).
extern "C" int dot_band_add_w(int dtype, const void* w_vals, const void* free3f,
                              const void* row, const void* col,
                              const void* band_dest, long long n_w,
                              const void* md3, const void* md_band_diag,
                              long long n_rows, long long total, void* band,
                              void* stream) {
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dotk5::launch_add_w<float>(w_vals, free3f, i64(row), i64(col),
                                      i64(band_dest), n_w, md3,
                                      i64(md_band_diag), n_rows, total, band, s);
  return dotk5::launch_add_w<double>(w_vals, free3f, i64(row), i64(col),
                                     i64(band_dest), n_w, md3,
                                     i64(md_band_diag), n_rows, total, band, s);
}

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

extern "C" int dot_band_compact(int dtype, const void* eh, long long n_ep,
                                const void* src_block, const void* seg_off,
                                const void* ub_row, const void* ub_col,
                                const void* freef, const void* mass,
                                long long n_ub, void* compact, void* stream) {
  if (n_ub == 0) return 0;
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned nb =
      static_cast<unsigned>((n_ub * 9 + dotk5::kThreads - 1) / dotk5::kThreads);
  if (dtype == 0)
    dotk5::band_compact_kernel<float><<<nb, dotk5::kThreads, 0, s>>>(
        static_cast<const float*>(eh), n_ep, i64(src_block), i64(seg_off),
        i64(ub_row), i64(ub_col), static_cast<const float*>(freef),
        static_cast<const float*>(mass), n_ub, static_cast<float*>(compact));
  else
    dotk5::band_compact_kernel<double><<<nb, dotk5::kThreads, 0, s>>>(
        static_cast<const double*>(eh), n_ep, i64(src_block), i64(seg_off),
        i64(ub_row), i64(ub_col), static_cast<const double*>(freef),
        static_cast<const double*>(mass), n_ub, static_cast<double*>(compact));
  return static_cast<int>(cudaGetLastError());
}
