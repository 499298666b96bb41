// K9: the L-BFGS two-loop's vector passes as two launches around the H0
// apply.
//
// Replaces the three contractions, the O(m^2) scalar recurrences and the
// two combinations of dot_tpu/steppers/quasi_newton.py:116-165
// (_two_loop):
//   dot_lbfgs_first   dots s_i . g and G = s_i . t_j over n, loop 1's
//                     recurrence (newest -> oldest) -> k, then
//                     q = -g - k^T T
//   dot_lbfgs_second  dots t_i . r, loop 2's recurrence (oldest ->
//                     newest) -> c, then out = r + c^T S
// (plain versions: kernels/lbfgs.py, lbfgs_first_ref / lbfgs_second_ref).
//
// Bound on the H100: memory, and below that the launches. With m = 5
// pairs of n-vectors (n = 49,419 at bar17, 405,504 at bar135) the first
// entry reads S, T, g once for the dots and T, g again for q (the second
// pass finds them in L2 at bar17), the second T, r and S, r: about 24
// n-vectors plus 2 written, 0.42 MB at bar17 and 42 MB at bar135 in f32.
//
// Design: one persistent launch per entry, cooperative, with every block
// co-resident (at most 4 a SM, at most one per 256 elements), and two
// grid-wide barriers: (1) each block accumulates all m (+ m^2) products
// of its grid-stride slice in registers and reduces them over its threads
// (warp shuffles, then the 8 warps in order) into one row of partials;
// (2) block 0 sums the rows in a fixed order (lane l takes rows l, l+32,
// ..., then a shuffle tree), and one thread runs the recurrence and
// writes k and G (first) or c (second, into scratch); (3) every block
// combines its slice with the m coefficients. No atomics: the scalars
// that drive the iteration come out the same from run to run. The
// partials and c are scratch that the wrapper owns (one cached buffer).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace dotk9 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename Tp>
__device__ __forceinline__ Tp warp_sum(Tp v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// the NV accumulators of every thread -> part_row[0..NV) (fixed order)
template <typename Tp, int NV>
__device__ __forceinline__ void block_partials(const Tp (&acc)[NV], Tp* red,
                                               Tp* part_row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const Tp s = warp_sum(acc[v]);
    if (lane == 0) red[warp * NV + v] = s;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < NV; v += kThreads) {
    Tp s = red[v];
    for (int w = 1; w < kWarps; ++w) s += red[w * NV + v];
    part_row[v] = s;
  }
}

// block 0: tot[v] = the column sums of part (nb rows of NV), fixed order:
// warp w sums the values w, w + 8, ...; lane l the rows l, l + 32, ...,
// all of its values in one pass (independent loads), then a shuffle tree
template <typename Tp, int NV>
__device__ __forceinline__ void totals(const Tp* part, int nb, Tp* tot) {
  constexpr int PER = (NV + kWarps - 1) / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Tp s[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) s[q] = Tp(0);
#pragma unroll 2
  for (int b = lane; b < nb; b += 32) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int v = warp + q * kWarps;
      if (v < NV) s[q] += __ldcg(part + b * NV + v);
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const Tp t = warp_sum(s[q]);
    const int v = warp + q * kWarps;
    if (lane == 0 && v < NV) tot[v] = t;
  }
  __syncthreads();
}

template <typename Tp>
__device__ __forceinline__ Tp inv_rho(const Tp* rho, const Tp* valid, int i) {
  const Tp val = valid[i];
  return (val > Tp(0) ? Tp(1) / rho[i] : Tp(0)) * val;
}

template <typename Tp, int M>
__global__ void __launch_bounds__(kThreads)
lbfgs_first_kernel(const Tp* __restrict__ S, const Tp* __restrict__ T,
                   const Tp* __restrict__ g, const Tp* __restrict__ rho,
                   const Tp* __restrict__ valid, long long n, Tp* q, Tp* k,
                   Tp* G, Tp* part) {
  constexpr int NV = M + M * M;
  __shared__ Tp red[kWarps * NV];
  __shared__ Tp tot[NV];
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kThreads
                     + threadIdx.x;
  // (1) s_i . g and s_i . t_j over this block's slice
  Tp acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = Tp(0);
#pragma unroll 4
  for (int64_t e = e0; e < n; e += stride) {
    const Tp gv = g[e];
    Tp sv[M], tv[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      sv[i] = S[i * n + e];
      tv[i] = T[i * n + e];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      acc[i] += sv[i] * gv;
#pragma unroll
      for (int j = 0; j < M; ++j) acc[M + i * M + j] += sv[i] * tv[j];
    }
  }
  block_partials<Tp, NV>(acc, red, part + static_cast<int64_t>(blockIdx.x) * NV);
  grid.sync();
  // (2) block 0: the sums, loop 1 (k_i from s_i . q0 = -(s_i . g))
  if (blockIdx.x == 0) {
    totals<Tp, NV>(part, gridDim.x, tot);
    if (threadIdx.x == 0) {
      Tp kv[M];
#pragma unroll
      for (int i = M - 1; i >= 0; --i) {
        Tp s = -tot[i];
#pragma unroll
        for (int j = i + 1; j < M; ++j) s = s - kv[j] * tot[M + i * M + j];
        kv[i] = s * inv_rho(rho, valid, i);
      }
#pragma unroll
      for (int i = 0; i < M; ++i) k[i] = kv[i];
    }
    for (int v = threadIdx.x; v < M * M; v += kThreads) G[v] = tot[M + v];
  }
  grid.sync();
  // (3) q = -g - k^T T
  Tp kc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) kc[i] = __ldcg(k + i);
#pragma unroll 4
  for (int64_t e = e0; e < n; e += stride) {
    Tp cv = kc[0] * T[e];
#pragma unroll
    for (int i = 1; i < M; ++i) cv += kc[i] * T[i * n + e];
    q[e] = -g[e] - cv;
  }
}

template <typename Tp, int M>
__global__ void __launch_bounds__(kThreads)
lbfgs_second_kernel(const Tp* __restrict__ T, const Tp* __restrict__ S,
                    const Tp* __restrict__ r, const Tp* __restrict__ k,
                    const Tp* __restrict__ G, const Tp* __restrict__ rho,
                    const Tp* __restrict__ valid, long long n, Tp* out,
                    Tp* part, Tp* c) {
  __shared__ Tp red[kWarps * M];
  __shared__ Tp tot[M];
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kThreads
                     + threadIdx.x;
  // (1) t_i . r over this block's slice
  Tp acc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] = Tp(0);
#pragma unroll 4
  for (int64_t e = e0; e < n; e += stride) {
    const Tp rv = r[e];
#pragma unroll
    for (int i = 0; i < M; ++i) acc[i] += T[i * n + e] * rv;
  }
  block_partials<Tp, M>(acc, red, part + static_cast<int64_t>(blockIdx.x) * M);
  grid.sync();
  // (2) block 0: the sums, loop 2
  if (blockIdx.x == 0) {
    totals<Tp, M>(part, gridDim.x, tot);
    if (threadIdx.x == 0) {
      Tp cv[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        Tp t = tot[i];
#pragma unroll
        for (int j = 0; j < i; ++j) t = t + cv[j] * G[j * M + i];
        cv[i] = k[i] - t * inv_rho(rho, valid, i);
        c[i] = cv[i];
      }
    }
  }
  grid.sync();
  // (3) out = r + c^T S
  Tp cc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) cc[i] = __ldcg(c + i);
#pragma unroll 4
  for (int64_t e = e0; e < n; e += stride) {
    Tp sv = cc[0] * S[e];
#pragma unroll
    for (int i = 1; i < M; ++i) sv += cc[i] * S[i * n + e];
    out[e] = r[e] + sv;
  }
}

// co-resident blocks of `kern` (at most 4 a SM), at most one per kThreads
// elements; 0 with *err set when the device cannot launch it
template <typename K>
long long grid_of(K kern, long long n, int* err) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, 0);
  if (e != cudaSuccess) {
    *err = static_cast<int>(e);
    return 0;
  }
  if (!coop || per_sm < 1) {
    *err = coop ? -3 : -2;
    return 0;
  }
  const long long most = static_cast<long long>(per_sm < 4 ? per_sm : 4) * sms;
  const long long need = (n + kThreads - 1) / kThreads;
  *err = 0;
  return need < 1 ? 1 : (need < most ? need : most);
}

template <typename Tp, int M>
int first(long long n, const void* S, const void* T, const void* g,
          const void* rho, const void* valid, void* q, void* k, void* G,
          void* scratch, long long scratch_len, cudaStream_t s) {
  auto kern = lbfgs_first_kernel<Tp, M>;
  static long long cached_n = -1, cached_grid = 0;
  int err = 0;
  if (cached_n != n) {
    cached_grid = grid_of(kern, n, &err);
    if (err) return err;
    cached_n = n;
  }
  long long grid = cached_grid;
  if (grid * (M + M * M) > scratch_len) return -1;
  auto Sp = static_cast<const Tp*>(S);
  auto Tpp = static_cast<const Tp*>(T);
  auto gp = static_cast<const Tp*>(g);
  auto rp = static_cast<const Tp*>(rho);
  auto vp = static_cast<const Tp*>(valid);
  auto qp = static_cast<Tp*>(q);
  auto kp = static_cast<Tp*>(k);
  auto Gp = static_cast<Tp*>(G);
  auto pp = static_cast<Tp*>(scratch);
  void* args[] = {&Sp, &Tpp, &gp, &rp, &vp, &n, &qp, &kp, &Gp, &pp};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(static_cast<unsigned>(grid)),
      dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tp, int M>
int second(long long n, const void* T, const void* S, const void* r,
           const void* k, const void* G, const void* rho, const void* valid,
           void* out, void* scratch, long long scratch_len, cudaStream_t s) {
  auto kern = lbfgs_second_kernel<Tp, M>;
  static long long cached_n = -1, cached_grid = 0;
  int err = 0;
  if (cached_n != n) {
    cached_grid = grid_of(kern, n, &err);
    if (err) return err;
    cached_n = n;
  }
  long long grid = cached_grid;
  if (grid * M + M > scratch_len) return -1;
  auto Tpp = static_cast<const Tp*>(T);
  auto Sp = static_cast<const Tp*>(S);
  auto rp_ = static_cast<const Tp*>(r);
  auto kp = static_cast<const Tp*>(k);
  auto Gp = static_cast<const Tp*>(G);
  auto rh = static_cast<const Tp*>(rho);
  auto vp = static_cast<const Tp*>(valid);
  auto op = static_cast<Tp*>(out);
  auto pp = static_cast<Tp*>(scratch);
  Tp* cp = pp + grid * M;
  void* args[] = {&Tpp, &Sp, &rp_, &kp, &Gp, &rh, &vp, &n, &op, &pp, &cp};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(static_cast<unsigned>(grid)),
      dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

#define DOTK9_CASES(F, Tp, ...)                  \
  switch (m) {                                   \
    case 1: return F<Tp, 1>(__VA_ARGS__);        \
    case 2: return F<Tp, 2>(__VA_ARGS__);        \
    case 3: return F<Tp, 3>(__VA_ARGS__);        \
    case 4: return F<Tp, 4>(__VA_ARGS__);        \
    case 5: return F<Tp, 5>(__VA_ARGS__);        \
    case 6: return F<Tp, 6>(__VA_ARGS__);        \
    case 7: return F<Tp, 7>(__VA_ARGS__);        \
    case 8: return F<Tp, 8>(__VA_ARGS__);        \
    default: return -5;                          \
  }

}  // namespace dotk9

// dtype: 0 f32, 1 f64; m in 1..8. scratch: at least 4 x SMs x (m + m^2)
// + m elements of the dtype. Returns 0, a CUDA error code, -1 when the
// scratch is too small, -2 without cooperative launch, -3 when no block
// fits, -5 for m outside 1..8.
extern "C" int dot_lbfgs_first(int dtype, int m, long long n, const void* S,
                               const void* T, const void* g, const void* rho,
                               const void* valid, void* q, void* k, void* G,
                               void* scratch, long long scratch_len,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using namespace dotk9;
  if (dtype == 0) {
    DOTK9_CASES(first, float, n, S, T, g, rho, valid, q, k, G, scratch,
                scratch_len, s)
  }
  DOTK9_CASES(first, double, n, S, T, g, rho, valid, q, k, G, scratch,
              scratch_len, s)
}

extern "C" int dot_lbfgs_second(int dtype, int m, long long n, const void* T,
                                const void* S, const void* r, const void* k,
                                const void* G, const void* rho,
                                const void* valid, void* out, void* scratch,
                                long long scratch_len, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using namespace dotk9;
  if (dtype == 0) {
    DOTK9_CASES(second, float, n, T, S, r, k, G, rho, valid, out, scratch,
                scratch_len, s)
  }
  DOTK9_CASES(second, double, n, T, S, r, k, G, rho, valid, out, scratch,
              scratch_len, s)
}
