// K10 coarse_assemble and K11 coarse_restrict / coarse_prolong: the
// two-level H0's coarse space over 6 rigid modes per subdomain.
//
// K10 replaces the Galerkin build of dot_tpu/steppers/core.py:1319-1429
// (_coarse_factor up to its symmetrization): Kc = Z^T (dt^2 K + M) Z, with
// at a vertex v of part p the rows Z_v = free_v [I | S(xc_v)],
// S(x)[j][k] = (e_k x x)_j. Per corner pair (a, b) of an element the 6 x 6
// block B_a^T H_ab B_b goes to Kc[own_a, own_b]; the lumped mass adds
// m_v [I, S; S^T, S^T S] to Kc[own_v, own_v].
// K11 replaces the restriction and prolongation of core.py:1296-1317
// (_coarse_apply): rc = [sum free r, sum xc x (free r)]_p / dc, and
// (yt + yr x xc) free with (yt, yr) = y / dc of the owner, added to the fine
// H0 apply. The 6P-dim solve between them is two K7 launches on Lc^{-1}.
//
// Bound on the H100: memory. K10 reads the element Hessians once (bar135:
// 144 x 953,344 f32, 549 MB, >= 0.16 ms at 3.35 TB/s) for ~2.6 kFLOP per
// uniform element (4.9 GFLOP, 0.07 ms on the f32 units). K11 reads a few
// vertex fields (bar135: 135,168 vertices, ~5 MB): launch-bound.
//
// Design. K10 walks a host-built item list sorted by destination block
// and cut into chunks that never straddle two destinations (coarse.py):
// one 128-thread block per chunk, each thread sums its items' 6 x 6 blocks
// in registers; a fixed xor-shuffle tree and a fixed 4-warp sum reduce the
// block, and a second launch sums each destination's chunk partials in
// chunk order. Uniform elements (the bulk) lie in their part's contiguous
// element slab, so their Hessian rows are read coalesced. K11 restrict:
// one block per part walks the owner-sorted vertex list; prolong: one
// thread per vertex component. No atomics: the sums come out the same
// from run to run. Built with -fmad=false, so the elementwise parts round
// as the plain PyTorch versions do.

#include <cuda_runtime.h>

#include <cstdint>

namespace dotk10 {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUniform = 32;
constexpr int kVertex = 33;

// rows of Z at a corner: B = f [I | S(x)]
template <typename T>
__device__ __forceinline__ void bmat(T f, T x0, T x1, T x2, T B[3][6]) {
  const T z = T(0);
  B[0][0] = f; B[0][1] = z; B[0][2] = z;
  B[0][3] = z; B[0][4] = f * x2; B[0][5] = f * -x1;
  B[1][0] = z; B[1][1] = f; B[1][2] = z;
  B[1][3] = f * -x2; B[1][4] = z; B[1][5] = f * x0;
  B[2][0] = z; B[2][1] = z; B[2][2] = f;
  B[2][3] = f * x1; B[2][4] = f * -x0; B[2][5] = z;
}

template <typename T>
__device__ __forceinline__ void corner(const int* __restrict__ conn,
                                       int64_t n_ep, int c, int64_t e,
                                       const T* __restrict__ xc,
                                       const T* __restrict__ freev,
                                       T B[3][6]) {
  const int64_t v = conn[c * n_ep + e];
  bmat(freev[v], xc[v * 3], xc[v * 3 + 1], xc[v * 3 + 2], B);
}

// acc += B_a^T H_ab B_b (or its transpose; a template parameter, so that
// acc's indices stay compile-time constants and acc stays in registers)
template <bool kTrans, typename T>
__device__ __forceinline__ void add_pair(const T* __restrict__ eh,
                                         int64_t n_ep, int64_t e, int ab,
                                         const T Ba[3][6], const T Bb[3][6],
                                         T acc[36]) {
  T H[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      H[i][j] = eh[static_cast<int64_t>(ab * 9 + i * 3 + j) * n_ep + e];
  T tmp[3][6];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int n = 0; n < 6; ++n)
      tmp[i][n] = H[i][0] * Bb[0][n] + H[i][1] * Bb[1][n] + H[i][2] * Bb[2][n];
#pragma unroll
  for (int m = 0; m < 6; ++m)
#pragma unroll
    for (int n = 0; n < 6; ++n) {
      const T v = Ba[0][m] * tmp[0][n] + Ba[1][m] * tmp[1][n] +
                  Ba[2][m] * tmp[2][n];
      acc[kTrans ? n * 6 + m : m * 6 + n] += v;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(const T* __restrict__ eh, int64_t n_ep,
                const int* __restrict__ conn, const T* __restrict__ xc,
                const T* __restrict__ freev, const T* __restrict__ mass,
                const int64_t* __restrict__ items,
                const int64_t* __restrict__ chunk_off,
                T* __restrict__ part) {
  __shared__ T red[kWarps][36];
  T acc[36];
#pragma unroll
  for (int q = 0; q < 36; ++q) acc[q] = T(0);
  const int64_t lo = chunk_off[blockIdx.x], hi = chunk_off[blockIdx.x + 1];
  for (int64_t k = lo + threadIdx.x; k < hi; k += kThreads) {
    const int64_t code = items[k];
    const int64_t idx = code >> 6;
    const int kind = static_cast<int>(code & 63);
    if (kind == kUniform) {
      for (int a = 0; a < 4; ++a) {
        T Ba[3][6];
        corner(conn, n_ep, a, idx, xc, freev, Ba);
        for (int b = 0; b < 4; ++b) {
          T Bb[3][6];
          corner(conn, n_ep, b, idx, xc, freev, Bb);
          add_pair<false>(eh, n_ep, idx, a * 4 + b, Ba, Bb, acc);
        }
      }
    } else if (kind == kVertex) {
      const T fm = freev[idx] * mass[idx];
      const T x0 = xc[idx * 3], x1 = xc[idx * 3 + 1], x2 = xc[idx * 3 + 2];
      const T z = T(0);
      const T S[3][3] = {{z, x2, -x1}, {-x2, z, x0}, {x1, -x0, z}};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          acc[i * 6 + j] += fm * (i == j ? T(1) : T(0));
          acc[i * 6 + 3 + j] += fm * S[i][j];
          acc[(3 + i) * 6 + j] += fm * S[j][i];
          acc[(3 + i) * 6 + 3 + j] +=
              fm * (S[0][i] * S[0][j] + S[1][i] * S[1][j] + S[2][i] * S[2][j]);
        }
      }
    } else {
      const int ab = kind >> 1;
      T Ba[3][6], Bb[3][6];
      corner(conn, n_ep, ab >> 2, idx, xc, freev, Ba);
      corner(conn, n_ep, ab & 3, idx, xc, freev, Bb);
      if (kind & 1)
        add_pair<true>(eh, n_ep, idx, ab, Ba, Bb, acc);
      else
        add_pair<false>(eh, n_ep, idx, ab, Ba, Bb, acc);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 36; ++q) {
    T v = acc[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < 36) {
    T s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][threadIdx.x];
    part[static_cast<int64_t>(blockIdx.x) * 36 + threadIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
reduce_kernel(const T* __restrict__ part, const int64_t* __restrict__ pair_off,
              const int64_t* __restrict__ pair_dest, int64_t n_pair,
              T* __restrict__ kc) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(256) + threadIdx.x;
  if (t >= n_pair * 36) return;
  const int64_t p = t / 36;
  const int q = static_cast<int>(t - p * 36);
  T s = T(0);
  for (int64_t c = pair_off[p]; c < pair_off[p + 1]; ++c) s += part[c * 36 + q];
  kc[pair_dest[p] * 36 + q] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
restrict_kernel(const T* __restrict__ rhs, const T* __restrict__ freev,
                const T* __restrict__ xc, const int64_t* __restrict__ vperm,
                const int64_t* __restrict__ voff, const T* __restrict__ dc,
                T* __restrict__ rc) {
  __shared__ T red[kWarps][6];
  T acc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  const int p = blockIdx.x;
  for (int64_t k = voff[p] + threadIdx.x; k < voff[p + 1]; k += kThreads) {
    const int64_t v = vperm[k];
    const T f = freev[v];
    const T r0 = rhs[v * 3] * f, r1 = rhs[v * 3 + 1] * f,
            r2 = rhs[v * 3 + 2] * f;
    const T x0 = xc[v * 3], x1 = xc[v * 3 + 1], x2 = xc[v * 3 + 2];
    acc[0] += r0;
    acc[1] += r1;
    acc[2] += r2;
    acc[3] += x1 * r2 - x2 * r1;
    acc[4] += x2 * r0 - x0 * r2;
    acc[5] += x0 * r1 - x1 * r0;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    T v = acc[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    T s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][threadIdx.x];
    rc[p * 6 + threadIdx.x] = s / dc[p * 6 + threadIdx.x];
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
prolong_kernel(const T* __restrict__ y, const T* __restrict__ dc,
               const T* __restrict__ freev, const T* __restrict__ xc,
               const int64_t* __restrict__ own, const T* __restrict__ base,
               int64_t n_vert, T* __restrict__ out) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(256) + threadIdx.x;
  if (t >= n_vert * 3) return;
  const int64_t v = t / 3;
  const int c = static_cast<int>(t - v * 3);
  const int64_t p6 = own[v] * 6;
  const int c1 = c == 2 ? 0 : c + 1, c2 = c == 0 ? 2 : c - 1;
  const T yt = y[p6 + c] / dc[p6 + c];
  const T ra = y[p6 + 3 + c1] / dc[p6 + 3 + c1];
  const T rb = y[p6 + 3 + c2] / dc[p6 + 3 + c2];
  // (yr x xc)_c = yr_{c+1} xc_{c+2} - yr_{c+2} xc_{c+1}
  const T cr = ra * xc[v * 3 + c2] - rb * xc[v * 3 + c1];
  const T val = (yt + cr) * freev[v];
  out[t] = base != nullptr ? base[t] + val : val;
}

inline unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace dotk10

extern "C" int dot_coarse_assemble(int dtype, const void* eh, long long n_ep,
                                   const void* conn, const void* xc,
                                   const void* freev, const void* mass,
                                   const void* items, const void* chunk_off,
                                   long long n_chunk, const void* pair_off,
                                   const void* pair_dest, long long n_pair,
                                   void* part, void* kc, void* stream) {
  using namespace dotk10;
  if (n_chunk == 0) return 0;
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  auto cn = static_cast<const int*>(conn);
  const unsigned nc = static_cast<unsigned>(n_chunk);
  const unsigned np = blocks_for(n_pair * 36, 256);
  if (dtype == 0) {
    assemble_kernel<float><<<nc, kThreads, 0, s>>>(
        static_cast<const float*>(eh), n_ep, cn,
        static_cast<const float*>(xc), static_cast<const float*>(freev),
        static_cast<const float*>(mass), i64(items), i64(chunk_off),
        static_cast<float*>(part));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    reduce_kernel<float><<<np, 256, 0, s>>>(
        static_cast<const float*>(part), i64(pair_off), i64(pair_dest),
        n_pair, static_cast<float*>(kc));
  } else {
    assemble_kernel<double><<<nc, kThreads, 0, s>>>(
        static_cast<const double*>(eh), n_ep, cn,
        static_cast<const double*>(xc), static_cast<const double*>(freev),
        static_cast<const double*>(mass), i64(items), i64(chunk_off),
        static_cast<double*>(part));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    reduce_kernel<double><<<np, 256, 0, s>>>(
        static_cast<const double*>(part), i64(pair_off), i64(pair_dest),
        n_pair, static_cast<double*>(kc));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dot_coarse_restrict(int dtype, const void* rhs,
                                   const void* freev, const void* xc,
                                   const void* vperm, const void* voff,
                                   const void* dc, long long n_parts,
                                   void* rc, void* stream) {
  using namespace dotk10;
  if (n_parts == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto vp = static_cast<const int64_t*>(vperm);
  auto vo = static_cast<const int64_t*>(voff);
  const unsigned nb = static_cast<unsigned>(n_parts);
  if (dtype == 0)
    restrict_kernel<float><<<nb, kThreads, 0, s>>>(
        static_cast<const float*>(rhs), static_cast<const float*>(freev),
        static_cast<const float*>(xc), vp, vo,
        static_cast<const float*>(dc), static_cast<float*>(rc));
  else
    restrict_kernel<double><<<nb, kThreads, 0, s>>>(
        static_cast<const double*>(rhs), static_cast<const double*>(freev),
        static_cast<const double*>(xc), vp, vo,
        static_cast<const double*>(dc), static_cast<double*>(rc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dot_coarse_prolong(int dtype, const void* y, const void* dc,
                                  const void* freev, const void* xc,
                                  const void* own, const void* base,
                                  long long n_vert, void* out, void* stream) {
  using namespace dotk10;
  if (n_vert == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto ow = static_cast<const int64_t*>(own);
  const unsigned nb = blocks_for(n_vert * 3, 256);
  if (dtype == 0)
    prolong_kernel<float><<<nb, 256, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(dc),
        static_cast<const float*>(freev), static_cast<const float*>(xc), ow,
        static_cast<const float*>(base), n_vert, static_cast<float*>(out));
  else
    prolong_kernel<double><<<nb, 256, 0, s>>>(
        static_cast<const double*>(y), static_cast<const double*>(dc),
        static_cast<const double*>(freev), static_cast<const double*>(xc), ow,
        static_cast<const double*>(base), n_vert, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
