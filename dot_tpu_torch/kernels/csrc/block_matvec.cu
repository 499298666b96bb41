// K7 block_matvec: out = op(A) v, or out = c - op(A) v, over a batch of
// square blocks, op in {A, A^T}. A is stored in bf16, f32 or f64 and taken
// to the solve type T (f32 or f64) in registers; v, c and out are T and
// the sums are taken in T.
//
// Replaces the block mat-vecs of dot_tpu/steppers/core.py:1061-1135
// (_cr_solve: Li r_odd, G_lo^T z, G_hi^T z, G_lo x, G_hi x, Li^T t) and
// 1219-1261 (_btd_solve: Linv_k (r_k - S_{k-1} y), Linv_k^T (y - S_k^T z)).
// The H0 apply is a host sequence of these launches.
//
// Bound on the H100: memory. Each element of A is read once and used for
// one multiply-add: at bar17 one H0 apply reads the bf16 factor twice,
// ~0.48 GB, ~0.15 ms at 3.35 TB/s. With 6-36 blocks of 768 x 768 per
// launch there is enough parallelism to stream at full width.
//
// Design: both directions read A coalesced along its rows.
//  - op = A: one warp per output row; the lanes stride the row and a fixed
//    xor-shuffle tree sums the lanes (deterministic).
//  - op = A^T: one block per 32 output columns; lane = column, each of the
//    8 warps walks every 8th row, so a warp reads 32 consecutive entries of
//    a row; the 8 partial sums are added in shared memory in a fixed order.
// `out` may be `c` (each entry is read and written by the same thread);
// it must not overlap v. The blocks of A lie `a_stride` entries apart
// (n * n when contiguous), so one subdomain's blocks of a scan-major
// (m, P, n, n) factor leaf are read in place (the GSDD sweep).
//
// K15 block_matvec_k (dot_block_matvec_k): the same products against K
// right-hand sides at once, v, c and out (B, n, K) row-major. Replaces the
// k-column einsums of _btd_solve (core.py:1224-1261) that pd_solve
// (core.py:1704-1719) runs with the three coordinates as columns. One
// launch reads each entry of A once and feeds K accumulators; per column
// the products are summed in K7's order (same lane strides, same shuffle
// tree, same shared-memory order), so column j equals K7 on column j.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dotk7 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;

template <typename T>
__device__ __forceinline__ T up(__nv_bfloat16 x) {
  return T(__bfloat162float(x));
}
template <typename T>
__device__ __forceinline__ T up(float x) {
  return T(x);
}
template <typename T>
__device__ __forceinline__ T up(double x) {
  return T(x);
}

template <typename TA, typename T>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const TA* __restrict__ A, const T* __restrict__ v,
              const T* c, T* out, int n, int64_t a_stride) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const TA* a = A + static_cast<int64_t>(b) * a_stride;
  const T* vb = v + static_cast<int64_t>(b) * n;
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int row = (blockIdx.x * kWarps + warp) * kRowsPerWarp + q;
    if (row >= n) break;
    const TA* ar = a + static_cast<int64_t>(row) * n;
    T acc = T(0);
    for (int j = lane; j < n; j += 32) acc += up<T>(ar[j]) * vb[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const int64_t k = static_cast<int64_t>(b) * n + row;
      out[k] = c != nullptr ? c[k] - acc : acc;
    }
  }
}

template <typename TA, typename T>
__global__ void __launch_bounds__(kThreads)
matvec_t_kernel(const TA* __restrict__ A, const T* __restrict__ v,
                const T* c, T* out, int n, int64_t a_stride) {
  __shared__ T part[kWarps][33];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  const TA* a = A + static_cast<int64_t>(b) * a_stride;
  const T* vb = v + static_cast<int64_t>(b) * n;
  T acc = T(0);
  if (col < n) {
    for (int i = warp; i < n; i += kWarps)
      acc += up<T>(a[static_cast<int64_t>(i) * n + col]) * vb[i];
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < n) {
    T s = part[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][lane];
    const int64_t k = static_cast<int64_t>(b) * n + col;
    out[k] = c != nullptr ? c[k] - s : s;
  }
}

// K15: K right-hand sides, v / c / out (B, n, K) row-major.
template <typename TA, typename T, int K>
__global__ void __launch_bounds__(kThreads)
matvec_k_kernel(const TA* __restrict__ A, const T* __restrict__ v,
                const T* c, T* out, int n) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const TA* a = A + static_cast<int64_t>(b) * n * n;
  const T* vb = v + static_cast<int64_t>(b) * n * K;
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int row = (blockIdx.x * kWarps + warp) * kRowsPerWarp + q;
    if (row >= n) break;
    const TA* ar = a + static_cast<int64_t>(row) * n;
    T acc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = T(0);
    for (int i = lane; i < n; i += 32) {
      const T x = up<T>(ar[i]);
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] += x * vb[i * K + j];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    }
    if (lane == 0) {
      const int64_t k = (static_cast<int64_t>(b) * n + row) * K;
#pragma unroll
      for (int j = 0; j < K; ++j)
        out[k + j] = c != nullptr ? c[k + j] - acc[j] : acc[j];
    }
  }
}

template <typename TA, typename T, int K>
__global__ void __launch_bounds__(kThreads)
matvec_kt_kernel(const TA* __restrict__ A, const T* __restrict__ v,
                 const T* c, T* out, int n) {
  __shared__ T part[K][kWarps][33];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  const TA* a = A + static_cast<int64_t>(b) * n * n;
  const T* vb = v + static_cast<int64_t>(b) * n * K;
  T acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = T(0);
  if (col < n) {
    for (int i = warp; i < n; i += kWarps) {
      const T x = up<T>(a[static_cast<int64_t>(i) * n + col]);
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] += x * vb[i * K + j];
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) part[j][warp][lane] = acc[j];
  __syncthreads();
  if (warp == 0 && col < n) {
    const int64_t k = (static_cast<int64_t>(b) * n + col) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      T s = part[j][0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += part[j][w][lane];
      out[k + j] = c != nullptr ? c[k + j] - s : s;
    }
  }
}

template <typename TA, typename T>
int launch(const void* A, const void* v, const void* c, void* out,
           long long batch, int n, int trans, long long a_stride,
           cudaStream_t s) {
  if (batch == 0 || n == 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto a = static_cast<const TA*>(A);
  auto vv = static_cast<const T*>(v);
  auto cc = static_cast<const T*>(c);
  auto o = static_cast<T*>(out);
  if (trans) {
    dim3 grid((n + 31) / 32, static_cast<unsigned>(batch));
    matvec_t_kernel<TA, T><<<grid, kThreads, 0, s>>>(a, vv, cc, o, n,
                                                     a_stride);
  } else {
    const int rows = kWarps * kRowsPerWarp;
    dim3 grid((n + rows - 1) / rows, static_cast<unsigned>(batch));
    matvec_kernel<TA, T><<<grid, kThreads, 0, s>>>(a, vv, cc, o, n,
                                                   a_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename T>
int launch_k(const void* A, const void* v, const void* c, void* out,
             long long batch, int n, int k, int trans, cudaStream_t s) {
  if (batch == 0 || n == 0) return 0;
  if (batch > 65535 || k != 3) return static_cast<int>(cudaErrorInvalidValue);
  auto a = static_cast<const TA*>(A);
  auto vv = static_cast<const T*>(v);
  auto cc = static_cast<const T*>(c);
  auto o = static_cast<T*>(out);
  if (trans) {
    dim3 grid((n + 31) / 32, static_cast<unsigned>(batch));
    matvec_kt_kernel<TA, T, 3><<<grid, kThreads, 0, s>>>(a, vv, cc, o, n);
  } else {
    const int rows = kWarps * kRowsPerWarp;
    dim3 grid((n + rows - 1) / rows, static_cast<unsigned>(batch));
    matvec_k_kernel<TA, T, 3><<<grid, kThreads, 0, s>>>(a, vv, cc, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk7

// a_dtype: 0 f32, 1 f64, 2 bf16; dtype (v, c, out): 0 f32, 1 f64;
// a_stride: entries between the blocks of A.
extern "C" int dot_block_matvec(int a_dtype, int dtype, const void* A,
                                const void* v, const void* c, void* out,
                                long long batch, int n, int trans,
                                long long a_stride, void* stream) {
  using dotk7::launch;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (a_dtype == 0) return launch<float, float>(A, v, c, out, batch, n, trans, a_stride, s);
    if (a_dtype == 1) return launch<double, float>(A, v, c, out, batch, n, trans, a_stride, s);
    return launch<__nv_bfloat16, float>(A, v, c, out, batch, n, trans, a_stride, s);
  }
  if (a_dtype == 0) return launch<float, double>(A, v, c, out, batch, n, trans, a_stride, s);
  if (a_dtype == 1) return launch<double, double>(A, v, c, out, batch, n, trans, a_stride, s);
  return launch<__nv_bfloat16, double>(A, v, c, out, batch, n, trans, a_stride, s);
}

// K15: v, c, out (batch, n, k); k == 3.
extern "C" int dot_block_matvec_k(int a_dtype, int dtype, const void* A,
                                  const void* v, const void* c, void* out,
                                  long long batch, int n, int k, int trans,
                                  void* stream) {
  using dotk7::launch_k;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (a_dtype == 0) return launch_k<float, float>(A, v, c, out, batch, n, k, trans, s);
    if (a_dtype == 1) return launch_k<double, float>(A, v, c, out, batch, n, k, trans, s);
    return launch_k<__nv_bfloat16, float>(A, v, c, out, batch, n, k, trans, s);
  }
  if (a_dtype == 0) return launch_k<float, double>(A, v, c, out, batch, n, k, trans, s);
  if (a_dtype == 1) return launch_k<double, double>(A, v, c, out, batch, n, k, trans, s);
  return launch_k<__nv_bfloat16, double>(A, v, c, out, batch, n, k, trans, s);
}
