// K6 chol_inv: for a batch of SPD (n x n) blocks, the lower Cholesky
// factor L and its inverse L^{-1}, in f32 or f64.
//
// Replaces the diagonal-block factorizations of dot_tpu/steppers/core.py:
// 904-914 (the scan's chol_inv: lax.linalg.cholesky(symmetrize_input=
// False) + triangular_solve against I), 1016-1019 and 1034-1038 (cyclic
// reduction's level and root blocks: jnp.linalg.cholesky, which factors
// (A + A^T) / 2, + triangular_solve) and 1161 (factorize_fast's diagonal
// tiles). `sym` = 1 factors (A + A^T) / 2; `sym` = 0 reads the lower
// triangle only.
//
// Failure semantics: a pivot that is not > 0 (or NaN), or a non-finite
// entry of L, sets info[b] = 1 and fills both outputs of block b with NaN
// (as cholesky_ex's info != 0 mapped to NaN; the robustness tiers of the
// H0 rebuild key on NaN).
//
// Bound on the H100: the flops, ~n^3/3 multiply-adds for L and as many for
// L^{-1} (2 x 151 M at n = 768), done by ONE thread block per matrix out of
// the 132 SMs. bar17's batches are 36 and 18 blocks (cyclic-reduction
// levels) and 6 (the root): 6 to 36 SMs busy; that, not the bytes, sets
// the time. Spreading one matrix over several blocks (or a cluster) is the
// next design step.
//
// Design: one block of 256 threads per matrix.
//  1. Cholesky, left-looking over panels of W columns (32 in f32, 16 in
//     f64). The panel (n - k0) x W lives in dynamic shared memory (a 768 x
//     33 f32 panel is 101 KB); the update by the k0 finished columns is a
//     tiled GEMM that stages 32-deep slices of L through shared memory, 8
//     outputs per thread; the panel is then factored in place, column by
//     column (the in-panel update is the triangular solve of the rows
//     below), and written to L with the upper triangle zeroed.
//  2. L^{-1} by blocked forward substitution over row blocks of W rows:
//     the diagonal tile is inverted in shared memory, and each W x W tile
//     left of it is -Td (L[I, j0:i0] X[j0:i0, J]), the same tiled GEMM.
// L and L^{-1} stay in device memory between the steps (L2-resident for
// the rows in use). No atomics: the result is deterministic.

#include <cuda_runtime.h>

#include <cstdint>

namespace dotk6 {

constexpr int kThreads = 256;
constexpr int KC = 32;   // depth of one staged slice of the GEMMs

template <typename T>
__device__ __forceinline__ T nan_of();
template <>
__device__ __forceinline__ float nan_of<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double nan_of<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <int W>
struct Dims {
  static constexpr int PL = W + 1;                    // panel leading dim
  static constexpr int TM = (kThreads / W) * 8;       // rows of a GEMM tile
  static constexpr int OPT = W * W / kThreads;        // phase-2 outputs/thread
};

template <int W>
__host__ __device__ inline int64_t smem_elems(int n) {
  using D = Dims<W>;
  const int64_t p1 = static_cast<int64_t>(n) * D::PL + D::TM * (KC + 1)
                     + W * (KC + 1);
  const int64_t p2 = 3 * W * (W + 1) + W * (KC + 1) + KC * (W + 1);
  return p1 > p2 ? p1 : p2;
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
chol_inv_kernel(const T* __restrict__ A, int n, int sym, T* __restrict__ Lg,
                T* __restrict__ Xg, int* __restrict__ info) {
  using D = Dims<W>;
  constexpr int PL = D::PL, TM = D::TM, OPT = D::OPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int bad;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int64_t off = static_cast<int64_t>(blockIdx.x) * n * n;
  const T* a = A + off;
  T* L = Lg + off;
  T* X = Xg + off;
  if (tid == 0) bad = 0;

  // ---------------- 1. Cholesky, left-looking by panels ----------------
  T* pn = sm;                                  // (n - k0) x W, ld PL
  T* ta = pn + static_cast<int64_t>(n) * PL;   // TM x KC, ld KC+1
  T* tb = ta + TM * (KC + 1);                  // W x KC, ld KC+1
  const int col = tid % W, rg = tid / W;
  for (int k0 = 0; k0 < n; k0 += W) {
    const int w = min(W, n - k0), rows = n - k0;
    __syncthreads();
    for (int idx = tid; idx < rows * W; idx += kThreads) {
      const int i = idx / W, c = idx % W;
      T v = T(0);
      if (c < w && i >= c) {
        const int64_t gi = k0 + i, gc = k0 + c;
        v = sym ? (a[gi * n + gc] + a[gc * n + gi]) / T(2) : a[gi * n + gc];
      }
      pn[i * PL + c] = v;
    }
    __syncthreads();
    if (k0 > 0) {
      for (int r0 = 0; r0 < rows; r0 += TM) {
        T acc[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = T(0);
        for (int p0 = 0; p0 < k0; p0 += KC) {
          for (int idx = tid; idx < TM * KC; idx += kThreads) {
            const int r = idx / KC, kk = idx % KC;
            const int gr = k0 + r0 + r, p = p0 + kk;
            ta[r * (KC + 1) + kk] =
                (gr < n && p < k0) ? L[static_cast<int64_t>(gr) * n + p] : T(0);
          }
          for (int idx = tid; idx < W * KC; idx += kThreads) {
            const int c = idx / KC, kk = idx % KC;
            const int p = p0 + kk;
            tb[c * (KC + 1) + kk] =
                (c < w && p < k0) ? L[static_cast<int64_t>(k0 + c) * n + p]
                                  : T(0);
          }
          __syncthreads();
#pragma unroll 8
          for (int kk = 0; kk < KC; ++kk) {
            const T bv = tb[col * (KC + 1) + kk];
#pragma unroll
            for (int q = 0; q < 8; ++q)
              acc[q] += ta[(rg * 8 + q) * (KC + 1) + kk] * bv;
          }
          __syncthreads();
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i = r0 + rg * 8 + q;
          if (i < rows) pn[i * PL + col] -= acc[q];
        }
      }
      __syncthreads();
    }
    // factor the panel in place, column by column
    for (int c = 0; c < w; ++c) {
      const T piv = pn[c * PL + c];
      if (tid == 0 && !(piv > T(0))) bad = 1;
      const T l = sqrt(piv);
      __syncthreads();
      for (int i = c + tid; i < rows; i += kThreads)
        pn[i * PL + c] = (i == c) ? l : pn[i * PL + c] / l;
      __syncthreads();
      const int c2 = tid % W;
      if (c2 > c && c2 < w) {
        const T lc2 = pn[c2 * PL + c];
        for (int i = tid / W; i < rows; i += kThreads / W)
          if (i >= c2) pn[i * PL + c2] -= pn[i * PL + c] * lc2;
      }
      __syncthreads();
    }
    // write the panel's columns of L (zeros above the diagonal)
    for (int idx = tid; idx < n * w; idx += kThreads) {
      const int i = idx / w, c = idx % w;
      T v = T(0);
      if (i >= k0 + c) {
        v = pn[(i - k0) * PL + c];
        if (!isfinite(v)) bad = 1;
      }
      L[static_cast<int64_t>(i) * n + k0 + c] = v;
    }
  }
  __syncthreads();
  if (bad) {
    const T nanv = nan_of<T>();
    for (int64_t idx = tid; idx < static_cast<int64_t>(n) * n; idx += kThreads) {
      L[idx] = nanv;
      X[idx] = nanv;
    }
    if (tid == 0) info[blockIdx.x] = 1;
    return;
  }
  if (tid == 0) info[blockIdx.x] = 0;

  // ---------------- 2. X = L^{-1}, by row blocks ----------------
  T* Ld = sm;                      // W x W, ld W+1: diagonal tile of L
  T* Td = Ld + W * (W + 1);        // its inverse
  T* Ac = Td + W * (W + 1);        // -(L X) tile
  T* sa = Ac + W * (W + 1);        // W x KC, ld KC+1: L[I, p0:p0+KC]
  T* sb = sa + W * (KC + 1);       // KC x W, ld W+1: X[p0:p0+KC, J]
  const int pc = tid % W, pr = (tid / W) * OPT;
  for (int i0 = 0; i0 < n; i0 += W) {
    const int h = min(W, n - i0);
    __syncthreads();
    for (int idx = tid; idx < W * W; idx += kThreads) {
      const int r = idx / W, c = idx % W;
      Ld[r * (W + 1) + c] =
          (r < h && c < h) ? L[static_cast<int64_t>(i0 + r) * n + i0 + c]
                           : T(r == c ? 1 : 0);
    }
    __syncthreads();
    if (tid < W) {   // column tid of the tile's inverse
      const int c = tid;
      for (int r = 0; r < W; ++r) {
        T s = T(0);
        if (r >= c) {
          s = (r == c) ? T(1) : T(0);
          for (int p = c; p < r; ++p) s -= Ld[r * (W + 1) + p] * Td[p * (W + 1) + c];
          s = s / Ld[r * (W + 1) + r];
        }
        Td[r * (W + 1) + c] = s;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < h * h; idx += kThreads) {
      const int r = idx / h, c = idx % h;
      X[static_cast<int64_t>(i0 + r) * n + i0 + c] = Td[r * (W + 1) + c];
    }
    const int right = n - i0 - h;
    for (int64_t idx = tid; idx < static_cast<int64_t>(h) * right; idx += kThreads) {
      const int r = static_cast<int>(idx / right), c = static_cast<int>(idx % right);
      X[static_cast<int64_t>(i0 + r) * n + i0 + h + c] = T(0);
    }
    for (int j0 = 0; j0 < i0; j0 += W) {
      T acc[OPT];
#pragma unroll
      for (int q = 0; q < OPT; ++q) acc[q] = T(0);
      for (int p0 = j0; p0 < i0; p0 += KC) {
        __syncthreads();
        for (int idx = tid; idx < W * KC; idx += kThreads) {
          const int r = idx / KC, kk = idx % KC;
          const int p = p0 + kk;
          sa[r * (KC + 1) + kk] =
              (r < h && p < i0) ? L[static_cast<int64_t>(i0 + r) * n + p] : T(0);
        }
        for (int idx = tid; idx < KC * W; idx += kThreads) {
          const int kk = idx / W, c = idx % W;
          const int p = p0 + kk;
          sb[kk * (W + 1) + c] =
              (p < i0) ? X[static_cast<int64_t>(p) * n + j0 + c] : T(0);
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
          const T bv = sb[kk * (W + 1) + pc];
#pragma unroll
          for (int q = 0; q < OPT; ++q)
            acc[q] += sa[(pr + q) * (KC + 1) + kk] * bv;
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < OPT; ++q) Ac[(pr + q) * (W + 1) + pc] = -acc[q];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < OPT; ++q) {
        const int r = pr + q;
        if (r < h) {
          T s = T(0);
          for (int qq = 0; qq <= r; ++qq)
            s += Td[r * (W + 1) + qq] * Ac[qq * (W + 1) + pc];
          X[static_cast<int64_t>(i0 + r) * n + j0 + pc] = s;
        }
      }
    }
  }
}

constexpr int64_t kMaxSmem = 232448 - 64;

template <typename T, int W>
int launch(const void* A, int n, long long batch, int sym, void* L, void* X,
           int* info, cudaStream_t s) {
  if (batch == 0 || n == 0) return 0;
  const int64_t bytes = smem_elems<W>(n) * static_cast<int64_t>(sizeof(T));
  if (bytes > kMaxSmem) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      chol_inv_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  chol_inv_kernel<T, W><<<static_cast<unsigned>(batch), kThreads,
                          static_cast<size_t>(bytes), s>>>(
      static_cast<const T*>(A), n, sym, static_cast<T*>(L),
      static_cast<T*>(X), info);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk6

// dtype: 0 f32, 1 f64. Returns 0, a CUDA error code, or -1 when n is too
// large for the panel in shared memory.
extern "C" int dot_chol_inv(int dtype, const void* A, int n, long long batch,
                            int sym, void* L, void* X, void* info,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto inf = static_cast<int*>(info);
  if (dtype == 0) return dotk6::launch<float, 32>(A, n, batch, sym, L, X, inf, s);
  return dotk6::launch<double, 16>(A, n, batch, sym, L, X, inf, s);
}

extern "C" long long dot_chol_inv_max_n(int dtype) {
  long long n = 1;
  while (true) {
    const long long bytes = dtype == 0
        ? dotk6::smem_elems<32>(static_cast<int>(n + 1)) * 4
        : dotk6::smem_elems<16>(static_cast<int>(n + 1)) * 8;
    if (bytes > dotk6::kMaxSmem) return n;
    ++n;
  }
}
