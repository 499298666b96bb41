// K12 band_equil_scatter: the chunked H0 rebuild's band, from the finished
// compact unique-block values (K5's compact entry point).
//
// Replaces dot_tpu/steppers/core.py:1476-1499 (_rebuild_banded_chunked,
// with the lower-only selection band_low_sel / band_low_dest of
// _build_scan_assembly, core.py:667-674):
//   d      = sqrt of the compact diagonal blocks' diagonals, 1 at padding
//            slots (fixed vertices carry a unit diagonal already)
//   band   = (compact[sel] * dinv[row] dinv[col]) rounded to the band's
//            dtype (bf16 in f32 runs), scattered to the lower blocks' slots
//            of a zeroed band; padding diagonals 1.
// The upper half of the diagonal blocks stays zero: the scan reads only the
// lower triangle (dot_tpu's contract).
//
// Bound on the H100: memory. At bar135 (P 133, nb 8, bs 768) the band is
// 1.18e9 bf16 entries, 2.35 GB written once (the zeroing memset, in the
// wrapper, and the scatter's ~2.9M blocks of 9 values): >= 0.7 ms at
// 3.35 TB/s; the compact (~100 MB f32) and the index tables are read once.
//
// Design: two launches on one stream. d_kernel: one thread per local dof
// reads its diagonal block's entry through a host-built slot table (no
// search). scatter_kernel: one thread per (lower block, entry); dinv is
// recomputed per use as 1 / d, which rounds as the plain version's
// dinv = 1 / d (IEEE division and square root, no FMA contraction: built
// with -fmad=false), so the bf16 band agrees with the plain version bit
// for bit on the same compact. Scattered slots are disjoint: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dotk12 {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
d_kernel(const T* __restrict__ compact, const int64_t* __restrict__ slot,
         int64_t n_slot, T* __restrict__ d) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_slot * 3) return;
  const int64_t s = t / 3;
  const int c = static_cast<int>(t - s * 3);
  const int64_t u = slot[s];
  d[t] = u >= 0 ? sqrt(compact[u * 9 + 4 * c]) : T(1);
}

template <typename OutT, typename T>
__device__ __forceinline__ OutT to_out(T v) {
  return static_cast<OutT>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16, double>(
    double v) {
  return __double2bfloat16(v);
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const T* __restrict__ compact, const T* __restrict__ d,
               const int64_t* __restrict__ ub_row,
               const int64_t* __restrict__ ub_col,
               const int64_t* __restrict__ sel,
               const int64_t* __restrict__ dest, int64_t n_low,
               const int64_t* __restrict__ pad_diag, int64_t n_pad,
               int64_t total, OutT* __restrict__ band) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t < n_low * 9) {
    const int64_t l = t / 9;
    const int q = static_cast<int>(t - l * 9);
    const int i = q / 3, j = q - (q / 3) * 3;
    const int64_t u = sel[l];
    const T sr = T(1) / d[ub_row[u] * 3 + i];
    const T sc = T(1) / d[ub_col[u] * 3 + j];
    const T v = compact[u * 9 + q] * (sr * sc);
    const int64_t dd = dest[t];
    if (dd < total) band[dd] = to_out<OutT, T>(v);
  }
  if (t < n_pad) band[pad_diag[t]] = to_out<OutT, T>(T(1));
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T, typename OutT>
int launch(const void* compact, const int64_t* slot, int64_t n_slot,
           const int64_t* ub_row, const int64_t* ub_col, const int64_t* sel,
           const int64_t* dest, int64_t n_low, const int64_t* pad_diag,
           int64_t n_pad, int64_t total, void* band, void* d,
           cudaStream_t s) {
  auto cp = static_cast<const T*>(compact);
  auto dd = static_cast<T*>(d);
  if (n_slot > 0) {
    d_kernel<T><<<blocks_for(n_slot * 3), kThreads, 0, s>>>(cp, slot, n_slot,
                                                            dd);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t n = n_low * 9 > n_pad ? n_low * 9 : n_pad;
  if (n == 0) return 0;
  scatter_kernel<T, OutT><<<blocks_for(n), kThreads, 0, s>>>(
      cp, dd, ub_row, ub_col, sel, dest, n_low, pad_diag, n_pad, total,
      static_cast<OutT*>(band));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk12

// dtype: 0 f32, 1 f64 (compact and d); out_dtype: 0 f32, 1 f64, 2 bf16.
extern "C" int dot_band_equil_scatter(int dtype, int out_dtype,
                                      const void* compact, const void* slot,
                                      long long n_slot, const void* ub_row,
                                      const void* ub_col, const void* sel,
                                      const void* dest, long long n_low,
                                      const void* pad_diag, long long n_pad,
                                      long long total, void* band, void* d,
                                      void* stream) {
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
#define DOT_K12(T, O)                                                        \
  return dotk12::launch<T, O>(compact, i64(slot), n_slot, i64(ub_row),       \
                              i64(ub_col), i64(sel), i64(dest), n_low,       \
                              i64(pad_diag), n_pad, total, band, d, s)
  if (dtype == 0) {
    if (out_dtype == 0) DOT_K12(float, float);
    if (out_dtype == 1) DOT_K12(float, double);
    DOT_K12(float, __nv_bfloat16);
  }
  if (out_dtype == 0) DOT_K12(double, float);
  if (out_dtype == 1) DOT_K12(double, double);
  DOT_K12(double, __nv_bfloat16);
#undef DOT_K12
}
