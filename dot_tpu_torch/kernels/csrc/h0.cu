// K8 h0_gather / h0_average: the vertex-side halves of the H0 apply.
//
// Replaces the gather and the duplicate-averaging segment sum of
// dot_tpu/steppers/core.py:1263-1280 (System.h0_apply):
//   gather   r = rhs[l2g] * valid / d                       (P, 3N)
//   average  p = segment_sum((z / d)[gath_perm], gath_segids) / dup   (nV, 3)
//
// Bound on the H100: memory and launch latency. At bar17 (P 6, n3 9,984,
// 16,473 vertices) each pass moves well under 1 MB, so a launch (~3 us)
// costs more than its bytes; the plain version is 4-6 launches each way.
//
// Design: one thread per output scalar. The gather reads three consecutive
// rhs values per local vertex. The average walks each vertex's run of the
// sorted segment ids (CSR offsets computed once on the host) in order, so
// the sum is deterministic and rounds as the plain sequential index_add_
// does (z / d is taken per entry before the sum, as the plain version
// does); the dump segment nV (padding slots) is never read. No atomics.

//
// K16 local_gather_one / local_scatter_one: the same two halves for ONE
// subdomain, the GSDD sweep's (dot_tpu/steppers/core.py:1282-1294 and the
// / d of gsdd.py:52-55):
//   gather   r = rhs[l2g_i] * valid_i / d_i                 (3N,)
//   scatter  p = 0 (nV, 3); p[l2g_i[k]] = z[k] / d_i[k] at valid slots
// The gather is K8's kernel on row i of the tables. The scatter zeroes the
// direction (a memset on the stream) and writes one thread per local
// scalar; a vertex appears at most once in a subdomain, so no two threads
// share a destination, and a padded slot (l2g 0) writes nothing, so vertex
// 0 keeps its value.

#include <cuda_runtime.h>

#include <cstdint>

namespace dotk8 {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
h0_gather_kernel(const T* __restrict__ rhs, const int64_t* __restrict__ l2g,
                 const unsigned char* __restrict__ valid,
                 const T* __restrict__ d, int64_t n_loc, T* __restrict__ r) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_loc * 3) return;
  const int64_t i = t / 3;
  const int c = static_cast<int>(t - i * 3);
  r[t] = rhs[l2g[i] * 3 + c] * T(valid[i]) / d[t];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
h0_average_kernel(const T* __restrict__ z, const T* __restrict__ d,
                  const int64_t* __restrict__ perm,
                  const int64_t* __restrict__ seg_off,
                  const T* __restrict__ dup, int64_t n_vert,
                  T* __restrict__ out) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_vert * 3) return;
  const int64_t v = t / 3;
  const int c = static_cast<int>(t - v * 3);
  T s = T(0);
  const int64_t end = seg_off[v + 1];
  for (int64_t k = seg_off[v]; k < end; ++k) {
    const int64_t j = perm[k] * 3 + c;
    s += z[j] / d[j];
  }
  out[t] = s / dup[v];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
local_scatter_kernel(const T* __restrict__ z, const T* __restrict__ d,
                     const int64_t* __restrict__ l2g,
                     const unsigned char* __restrict__ valid, int64_t n_loc,
                     T* __restrict__ out) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_loc * 3) return;
  const int64_t i = t / 3;
  if (!valid[i]) return;
  const int c = static_cast<int>(t - i * 3);
  out[l2g[i] * 3 + c] = z[t] / d[t];
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace dotk8

extern "C" int dot_h0_gather(int dtype, const void* rhs, const void* l2g,
                             const void* valid, const void* d,
                             long long n_loc, void* r, void* stream) {
  if (n_loc == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto idx = static_cast<const int64_t*>(l2g);
  auto val = static_cast<const unsigned char*>(valid);
  const unsigned nb = dotk8::blocks_for(n_loc * 3);
  if (dtype == 0)
    dotk8::h0_gather_kernel<float><<<nb, dotk8::kThreads, 0, s>>>(
        static_cast<const float*>(rhs), idx, val,
        static_cast<const float*>(d), n_loc, static_cast<float*>(r));
  else
    dotk8::h0_gather_kernel<double><<<nb, dotk8::kThreads, 0, s>>>(
        static_cast<const double*>(rhs), idx, val,
        static_cast<const double*>(d), n_loc, static_cast<double*>(r));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dot_h0_average(int dtype, const void* z, const void* d,
                              const void* perm, const void* seg_off,
                              const void* dup, long long n_vert, void* out,
                              void* stream) {
  if (n_vert == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<const int64_t*>(perm);
  auto so = static_cast<const int64_t*>(seg_off);
  const unsigned nb = dotk8::blocks_for(n_vert * 3);
  if (dtype == 0)
    dotk8::h0_average_kernel<float><<<nb, dotk8::kThreads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(d), pm, so,
        static_cast<const float*>(dup), n_vert, static_cast<float*>(out));
  else
    dotk8::h0_average_kernel<double><<<nb, dotk8::kThreads, 0, s>>>(
        static_cast<const double*>(z), static_cast<const double*>(d), pm, so,
        static_cast<const double*>(dup), n_vert, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// rhs (nV, 3); l2g, valid (P, n_loc); d (P, 3 n_loc); r (3 n_loc,).
extern "C" int dot_local_gather_one(int dtype, const void* rhs,
                                    const void* l2g, const void* valid,
                                    const void* d, long long part,
                                    long long n_loc, void* r, void* stream) {
  if (n_loc == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto idx = static_cast<const int64_t*>(l2g) + part * n_loc;
  auto val = static_cast<const unsigned char*>(valid) + part * n_loc;
  const unsigned nb = dotk8::blocks_for(n_loc * 3);
  if (dtype == 0)
    dotk8::h0_gather_kernel<float><<<nb, dotk8::kThreads, 0, s>>>(
        static_cast<const float*>(rhs), idx, val,
        static_cast<const float*>(d) + part * n_loc * 3, n_loc,
        static_cast<float*>(r));
  else
    dotk8::h0_gather_kernel<double><<<nb, dotk8::kThreads, 0, s>>>(
        static_cast<const double*>(rhs), idx, val,
        static_cast<const double*>(d) + part * n_loc * 3, n_loc,
        static_cast<double*>(r));
  return static_cast<int>(cudaGetLastError());
}

// z (3 n_loc,); out (n_vert, 3), zeroed here.
extern "C" int dot_local_scatter_one(int dtype, const void* z, const void* d,
                                     const void* l2g, const void* valid,
                                     long long part, long long n_loc,
                                     long long n_vert, void* out,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const size_t sz = dtype == 0 ? sizeof(float) : sizeof(double);
  cudaError_t e = cudaMemsetAsync(out, 0, n_vert * 3 * sz, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_loc == 0) return 0;
  auto idx = static_cast<const int64_t*>(l2g) + part * n_loc;
  auto val = static_cast<const unsigned char*>(valid) + part * n_loc;
  const unsigned nb = dotk8::blocks_for(n_loc * 3);
  if (dtype == 0)
    dotk8::local_scatter_kernel<float><<<nb, dotk8::kThreads, 0, s>>>(
        static_cast<const float*>(z),
        static_cast<const float*>(d) + part * n_loc * 3, idx, val, n_loc,
        static_cast<float*>(out));
  else
    dotk8::local_scatter_kernel<double><<<nb, dotk8::kThreads, 0, s>>>(
        static_cast<const double*>(z),
        static_cast<const double*>(d) + part * n_loc * 3, idx, val, n_loc,
        static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
