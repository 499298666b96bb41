// K34 whole_chol: the lower Cholesky factor L of ONE dense SPD matrix A
// (n x n, f32), read from its lower triangle, and the flag "the matrix
// failed", in one launch. A pivot that is <= 0 or not finite makes the
// whole factor NaN and sets the flag.
//
// Replaces the library Cholesky of 2D projected Newton's whole-mesh factor
// (System2D.factorize: cuSOLVER's potrf, whose SGEMM / SYRK trailing
// updates wait on a serial diagonal-block factor, getrf_wo_pivot, and the
// passes around it: the copy into L, triu_tril, the NaN add).
// dot_tpu/dim2.py:496 calls the library there too (jnp.linalg.cholesky),
// so no TPU kernel is ported: a library call is replaced by a kernel
// written for this card.
//
// Bound on the H100 at the spikes Newton shape (n 20,342, f32): the
// operations. n^3 / 3 = 2.81e12 operations at the CUDA cores' f32 rate of
// 66.9 TFLOP/s take 41.94 ms; the bytes (A's lower triangle read, L
// written) are ~2.5 GB, 0.74 ms. Numerics: f32 FFMA on the CUDA cores; no
// TF32, no bf16.
//
// Design: a left-looking blocked Cholesky over 128 x 128 tiles, on the
// transposed factor U = L^T stored row major (L column major: the layout
// the library left, which System2D.solve reads). A task is a PAIR of
// vertically adjacent tiles of one column of L, (I0, J) and (I0 + 1, J)
// with I0 = J, J + 2, ... (one tile at the bottom of an odd column): U's
// 128 rows rJ.. over the 256 columns rI0..
// - its sums W = A - sum_{K < J} U_KJ^T U_K[I0, I0+1] run on a 128 x 256
//   block tile, each thread a 16 x 8 register block (f32 FFMA; 6 16-byte
//   shared loads for 128 FFMA a row of the sum, where K33's 8 x 8 blocks
//   load 4 for 64), its fragments double-buffered in registers; 256 rows
//   of the sum are taken in registers before W (in shared memory) takes
//   them (error against an f64 factor half the library's, where 64 rows
//   read 0.68 of it and a whole column's sum in registers 2.9 times);
// - the operands come from T, a tile-major copy of U's finished tiles
//   (kernel-owned scratch, each tile 64 KB, 16-byte aligned whatever n:
//   n 20,342's rows are only 8-byte aligned): a stage, 16 rows of the J
//   panel's tile and of the pair's two tiles, is three contiguous 8 KB
//   pieces that a producer warp of its own fetches with TMA bulk copies
//   into a 4-stage ring (as much as shared memory holds beside W); each
//   slot's "full" mbarrier completes with the copies' bytes, its "empty"
//   mbarrier with one arrival a worker warp once the warp's sums are done
//   with it, so no block barrier stands in the sums, and no worker warp
//   waits on a tile's word or a slot's last readers: at n 20,342 the sums
//   ran at 373 GFLOP/s a block, 74 % of an SM's FFMA rate, where 8-byte
//   cp.async by every thread behind a barrier a stage, or the producer
//   inside a worker warp, held them at 59-60 %;
// - the task of a column's diagonal pair factors the diagonal tile in
//   shared memory (panels of 16, a warp factors each panel's diagonal
//   block in registers) and solves the tile below it against it at once,
//   so the next column's diagonal task waits on one task, not two; a
//   pivot that is <= 0 or not finite marks the matrix failed;
// - any other pair waits for its column's diagonal tile, reads it from T
//   and solves U_JJ^T X = W (one thread a column, panels of 32), then
//   writes zeros into the mirrored tiles (L's upper triangle).
// Hiding the diagonal chain: tasks are dealt from one counter in a fixed
// order, a table the wrapper builds once per n (dd2d.whole_chol_order:
// keys 6 J + I0), and a task only waits on tasks dealt before it, so a
// persistent cooperative grid (one block an SM, every block resident)
// cannot deadlock and the deep sums of later columns run on every other
// SM while a column's diagonal factor and solve advance; pairs in flight
// share their column's panel in L2. A tile is published by a word holding
// the call's epoch (its writers fence the async proxy and the device,
// then one thread stores the word with release; the fetching thread loads
// it with acquire and fences the async proxy before its bulk copies); the
// counter carries the epoch in its upper half: nothing is reset or memset
// between calls. After the tiles, a task per tile row fills a failed
// matrix with NaN, and a last task writes the flag. Each tile's sums run
// in one fixed order whatever block computes it: the factor repeats bit
// for bit from run to run.
// At n 20,342 (H100 SXM, 700 W) a call took 63.4-64.1 ms, 65 % of the f32
// peak (the library and its passes 82.8 ms): the sums 58.6 ms, the
// last columns' wind-down ~2 ms of idle blocks (a few deep pairs left),
// the factors, solves and writes ~2.4 ms. n 10,171: 11.8 ms (the library
// 13.8).

#include <cuda_runtime.h>

#include <cstdint>

namespace dotk34 {

constexpr int kThreads = 256;           // the block's workers: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = kThreads + 32;   // and the ring's producer warp
constexpr int kB = 128;                 // tile
constexpr int kTileF = kB * kB;         // floats a tile of T
constexpr int kW2 = 2 * kB;             // a task's columns of U
constexpr int kBk = 16;                 // rows of U a ring stage holds
constexpr int kStages = 4;
constexpr int kDepth = 256;             // rows summed in registers
constexpr int kFw = 16;                 // panel of the diagonal factor
constexpr int kPw = 32;                 // panel of the off-diagonal solve
constexpr int kSpt = kB / kBk;          // stages a tile of U
constexpr int kLdW = kW2 + 4;           // W's padded row
constexpr int kLdD = kB + 4;            // the diagonal tile's padded row
constexpr int kChunkF = kBk * kB;       // a stage's piece of one tile
constexpr unsigned kChunkB = 4u * kChunkF;
constexpr int kStageF = 3 * kChunkF;    // J panel, pair's first, second
constexpr int kRingF = kStages * kStageF;
constexpr int kDF = kB * kLdD;
constexpr int kFirstF = kRingF > kDF ? kRingF : kDF;
constexpr int kWF = kB * kLdW;
constexpr size_t kSmemBytes = sizeof(float) * (kFirstF + kWF + kB);
constexpr unsigned kFull = 0xffffffffu;
static_assert(kDepth % kBk == 0, "depth");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// the calling thread waits (acquire) until the word holds the epoch; a
// wait that outlasts 2^34 cycles (~9 s) traps: a launch error, never a
// hung card
__device__ __forceinline__ void wait_word(const unsigned* p, unsigned epoch) {
  if (ld_acquire(p) == epoch) return;
  const long long t0 = clock64();
  while (ld_acquire(p) != epoch) {
    __nanosleep(64);
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// orders this thread's generic-proxy accesses of global memory with its
// async-proxy (TMA) ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also expects `bytes` of bulk copies on the barrier
__device__ __forceinline__ void mbar_expect(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// waits until the barrier's phase of this parity has completed; traps
// after 2^34 cycles as wait_word does
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done;
  long long t0 = 0;
  for (int tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 0) t0 = clock64();
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// `bytes` from global memory into shared memory by the TMA unit, their
// arrival counted on the barrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src,
                                          unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the next task of this call: the counter holds (epoch << 32) | tasks
// dealt; the first block to find an older epoch restarts it
__device__ __forceinline__ long long next_task(unsigned long long* ctr,
                                               unsigned epoch) {
  unsigned long long cur = atomicAdd(ctr, 0ull);
  for (;;) {
    const bool ours = static_cast<unsigned>(cur >> 32) == epoch;
    const unsigned long long want =
        ours ? cur + 1 : (static_cast<unsigned long long>(epoch) << 32) | 1ull;
    const unsigned long long got = atomicCAS(ctr, cur, want);
    if (got == cur)
      return ours ? static_cast<long long>(cur & 0xffffffffull) : 0ll;
    cur = got;
  }
}

__device__ __forceinline__ void ld4(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__device__ __forceinline__ void st4(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
}

// the kFw x kFw diagonal block of panel p0 of the tile A (upper form, row
// length kLd, in place) in warp 0: lane l < kFw holds column p0 + l; rinv
// gets the reciprocal pivots. Returns whether a pivot was <= 0 or not
// finite (on every lane).
template <int kLd>
__device__ __forceinline__ bool factor_block(float* A, float* rinv, int p0) {
  const int lane = threadIdx.x & 31;
  const int col = p0 + min(lane, kFw - 1);
  float c[kFw];
#pragma unroll
  for (int k = 0; k < kFw; ++k) c[k] = A[(p0 + k) * kLd + col];
  bool bad = false;
#pragma unroll
  for (int k = 0; k < kFw; ++k) {
    const float d = __shfl_sync(kFull, c[k], k);
    bad = bad || !(d > 0.f) || !isfinite(d);
    const float u = sqrtf(d);
    const float ri = 1.f / u;
    if (lane == k) {
      c[k] = u;
    } else if (lane > k) {
      c[k] *= ri;
    }
#pragma unroll
    for (int m = k + 1; m < kFw; ++m) {
      const float um = __shfl_sync(kFull, c[k], m);
      if (lane >= m) c[m] = fmaf(-um, c[k], c[m]);
    }
    if (lane == 0) rinv[p0 + k] = ri;
  }
#pragma unroll
  for (int k = 0; k < kFw; ++k)
    if (k <= lane && lane < kFw) A[(p0 + k) * kLd + col] = c[k];
  return bad;
}

// rows p0..p0+kW-1 of X over the columns [c0, kCols): X <- D_pp^{-T} X,
// D_pp the factored diagonal block of panel p0 of D (upper), one thread a
// column; D's rows are read 4 entries at a time
template <int kW, int kLdD_, int kLdX, int kCols>
__device__ __forceinline__ void solve_panel(const float* D, const float* rinv,
                                            float* X, int p0, int c0) {
  const int col = c0 + static_cast<int>(threadIdx.x);
  if (col >= kCols) return;
  float x[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) x[k] = X[(p0 + k) * kLdX + col];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    x[k] *= rinv[p0 + k];
    const float* drow = D + (p0 + k) * kLdD_ + p0;
#pragma unroll
    for (int g = (k + 1) / 4; g < kW / 4; ++g) {
      float d[4];
      ld4(d, drow + 4 * g);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * g + e > k) x[4 * g + e] = fmaf(-d[e], x[k], x[4 * g + e]);
    }
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) X[(p0 + k) * kLdX + col] = x[k];
}

// the rows below the kW rows of panel p0 over the columns [c0, kCols):
// X[m][c] -= sum_k D[p0 + k][m] X[p0 + k][c]; `upper`: only where m <= c
// matters (a lane leaves the row groups wholly below its columns). A warp
// takes 4 rows at a time over 128 columns, a lane 4 consecutive columns;
// over 256 columns the warps split into two halves.
template <int kW, int kLdD_, int kLdX, int kCols>
__device__ __forceinline__ void update_below(const float* D, float* X, int p0,
                                             int c0, bool upper) {
  constexpr int kHalves = kCols / kB;
  constexpr int kStep = kWarps / kHalves;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= kWarps) return;
  const int m0 = p0 + kW;
  const int col = (warp % kHalves) * kB + 4 * lane;
  if (col < c0) return;
  for (int g = warp / kHalves; g < (kB - m0) / 4; g += kStep) {
    const int m = m0 + 4 * g;
    if (upper && m > col + 3) break;
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kW; ++k) {
      float d[4], xv[4];
      ld4(d, D + (p0 + k) * kLdD_ + m);
      ld4(xv, X + (p0 + k) * kLdX + col);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(d[r], xv[j], s[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float o[4];
      ld4(o, X + (m + r) * kLdX + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] -= s[r][j];
      st4(X + (m + r) * kLdX + col, o);
    }
  }
}

// the 128 x 128 tile A (upper form, row length kLd) factored in place:
// A = U^T U. Returns whether some pivot was <= 0 or not finite (the same
// on every thread).
template <int kLd>
__device__ __forceinline__ bool factor_tile(float* A, float* rinv) {
  __shared__ int s_bad;
  if (threadIdx.x == 0) s_bad = 0;
  for (int p0 = 0; p0 < kB; p0 += kFw) {
    if (threadIdx.x < 32) {
      const bool bad = factor_block<kLd>(A, rinv, p0);
      if (bad && threadIdx.x == 0) s_bad = 1;
    }
    __syncthreads();
    if (p0 + kFw < kB) {
      solve_panel<kFw, kLd, kLd, kB>(A, rinv, A, p0, p0 + kFw);
      __syncthreads();
      update_below<kFw, kLd, kLd, kB>(A, A, p0, p0 + kFw, true);
      __syncthreads();
    }
  }
  return s_bad != 0;
}

// X <- D^{-T} X over kCols columns, D factored (upper) with its
// reciprocal pivots in rinv
template <int kLdD_, int kLdX, int kCols>
__device__ __forceinline__ void solve_tile(const float* D, const float* rinv,
                                           float* X) {
  for (int p0 = 0; p0 < kB; p0 += kPw) {
    solve_panel<kPw, kLdD_, kLdX, kCols>(D, rinv, X, p0, 0);
    __syncthreads();
    if (p0 + kPw < kB) {
      update_below<kPw, kLdD_, kLdX, kCols>(D, X, p0, 0, false);
      __syncthreads();
    }
  }
}

struct Args {
  const float* A;       // (n, n) row major, lower triangle read
  float* U;             // (n, n) row major: U = L^T
  float* T;             // nt (nt + 1) / 2 tiles of kTileF: U's upper tiles
  const int* order;     // the pair tasks in dealing order: J << 16 | I0
  int n, nt, n_order;
  unsigned epoch;
  unsigned* words;      // nt (nt + 1) / 2 tile words, then the failure word
  unsigned long long* ctr;
  unsigned char* bad;
};

// U's tile (K, C), K <= C (L's tile (C, K)): its word and its place in T
__device__ __forceinline__ long long tile_id(int K, int C) {
  return static_cast<long long>(C) * (C + 1) / 2 + K;
}
__device__ __forceinline__ unsigned* word(const Args& a, int K, int C) {
  return a.words + tile_id(K, C);
}
__device__ __forceinline__ float* tile(const Args& a, int K, int C) {
  return a.T + tile_id(K, C) * kTileF;
}

// one pair task: U's rows rJ.. over the columns of tiles I0 and I0 + 1
// (w of them: 1 at the bottom of an odd column)
__device__ __forceinline__ void pair_task(const Args& a, int J, int I0,
                                          unsigned char* smem) {
  __shared__ __align__(8) unsigned long long s_full[kStages];
  __shared__ __align__(8) unsigned long long s_empty[kStages];
  __shared__ int s_skip;
  float* ring = reinterpret_cast<float*>(smem);
  float* D = ring;
  float* W = ring + kFirstF;
  float* rinv = W + kWF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n, w = min(2, a.nt - I0);
  const int rJ = J * kB, rI = I0 * kB;
  const unsigned epoch = a.epoch;
  unsigned* failed = a.words + tile_id(0, a.nt);
  const bool diag = I0 == J;

  // a failed matrix is filled with NaN at the end: skip its work
  if (tid == 0) s_skip = ld_acquire(failed) == epoch;
  __syncthreads();
  if (s_skip) {
    if (tid == 0) {
      st_release(word(a, J, I0), epoch);
      if (w == 2) st_release(word(a, J, I0 + 1), epoch);
    }
    return;
  }

  // the ring's barriers, fresh for this task (the last task's copies have
  // all been waited for)
  const uint32_t full_s = smem_u32(s_full), empty_s = smem_u32(s_empty);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full_s + 8 * i, 1);
      mbar_init(empty_s + 8 * i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // ---- W[j][i] = A[rI + i][rJ + j] (U's row rJ + j, column rI + i); the
  // diagonal tile's lower part 0; past n: the identity on the diagonal
  // tile, else zeros. A thread reads column rJ + j of every other row, 64
  // rows in flight at a time (latency, not bandwidth, bounds this read)
  if (tid < kThreads) {
    constexpr int kRows = kB * kW2 / kThreads / 2;
    const int j = tid % kB, gc = rJ + j;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = tid / kB + 2 * (h * kRows + r), gr = rI + i;
        const bool dt = diag && i < kB;
        if (gr < n && gc < n) {
          v[r] = (!dt || i >= j)
                     ? __ldg(a.A + static_cast<long long>(gr) * n + gc)
                     : 0.f;
        } else {
          v[r] = dt && i == j ? 1.f : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        W[j * kLdW + tid / kB + 2 * (h * kRows + r)] = v[r];
    }
  }
  __syncthreads();   // W and the barriers, for every thread

  // ---- W -= U_KJ^T U_K[I0..] for K < J. The producer (the block's last
  // warp) fetches stage s (rows kBk (s % kSpt).. of tile row K = s / kSpt:
  // T's pieces of U's tiles (K, J), (K, I0), (K, I0 + 1)) into ring slot
  // s % kStages once the slot's last readers are done and the tiles are
  // published; every worker waits for the slot's bytes. Each worker a 16 x
  // 8 block: rows j = jb + 16 m + q of the J piece, columns 64 wi + ib +
  // 32 h + e of the pair (wi's half from its own piece); kDepth rows of
  // the sum in registers, then taken from W (each thread its own entries)
  const int nst = J * kSpt;
  const uint32_t ring_s = smem_u32(ring);
  const unsigned bytes = (w == 2 ? 3u : 2u) * kChunkB;
  auto fetch = [&](int s) {
    const int slot = s % kStages, use = s / kStages;
    if (use > 0) mbar_wait(empty_s + 8 * slot, (use - 1) & 1);
    const int K = s / kSpt, r0 = (s % kSpt) * kBk;
    if (r0 == 0) {
      wait_word(word(a, K, J), epoch);
      wait_word(word(a, K, I0), epoch);
      if (w == 2) wait_word(word(a, K, I0 + 1), epoch);
      fence_proxy_async();
    }
    const uint32_t dst = ring_s + 4u * slot * kStageF;
    const uint32_t bar = full_s + 8 * slot;
    mbar_expect(bar, bytes);
    bulk_copy(dst, tile(a, K, J) + r0 * kB, kChunkB, bar);
    bulk_copy(dst + kChunkB, tile(a, K, I0) + r0 * kB, kChunkB, bar);
    if (w == 2)
      bulk_copy(dst + 2 * kChunkB, tile(a, K, I0 + 1) + r0 * kB, kChunkB,
                bar);
  };
  if (tid == kThreads) {
    // the producer: every stage, up to kStages ahead of the slowest warp
    for (int s = 0; s < nst; ++s) fetch(s);
  }

  const int wi = warp & 3;
  const int jb = 64 * (warp >> 2) + 4 * (lane >> 3);
  const int ib = 4 * (lane & 7);
  // the thread's columns within its half's piece of a stage
  const int ioff = kChunkF * (1 + (wi >> 1)) + 64 * (wi & 1) + ib;
  float acc[16][8];
  if (tid < kThreads) {
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    const int slot = s % kStages;
    mbar_wait(full_s + 8 * slot, (s / kStages) & 1);
    const float* Js = ring + slot * kStageF + jb;
    const float* Is = ring + slot * kStageF + ioff;
    float fa[2][16], fb[2][8];
#pragma unroll
    for (int m = 0; m < 4; ++m) ld4(fa[0] + 4 * m, Js + 16 * m);
#pragma unroll
    for (int h = 0; h < 2; ++h) ld4(fb[0] + 4 * h, Is + 32 * h);
#pragma unroll
    for (int k = 0; k < kBk; ++k) {
      if (k + 1 < kBk) {
        const int nx = (k + 1) & 1;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          ld4(fa[nx] + 4 * m, Js + (k + 1) * kB + 16 * m);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ld4(fb[nx] + 4 * h, Is + (k + 1) * kB + 32 * h);
      }
      const int cu = k & 1;
#pragma unroll
      for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = fmaf(fa[cu][r], fb[cu][c], acc[r][c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_s + 8 * slot);
    if ((s + 1) % (kDepth / kBk) == 0 || s + 1 == nst) {
#pragma unroll
      for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* p = W + (jb + 16 * (r >> 2) + (r & 3)) * kLdW + 64 * wi
                     + ib + 32 * h;
          float v[4];
          ld4(v, p);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[e] -= acc[r][4 * h + e];
            acc[r][4 * h + e] = 0.f;
          }
          st4(p, v);
        }
    }
  }
  }
  __syncthreads();

  float* Up = a.U;
  if (diag) {
    const bool bad = factor_tile<kLdW>(W, rinv);
    if (w == 2) solve_tile<kLdW, kLdW, kB>(W, rinv, W + kB);
    if (bad && tid == 0) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(failed),
                   "r"(epoch)
                   : "memory");
    }
  } else {
    // the column's factored diagonal tile from T (whole: J < nt - 1)
    if (tid == 0) {
      wait_word(word(a, J, J), epoch);
      fence_proxy_async();
    }
    __syncthreads();
    if (tid < kThreads) {
      constexpr int kVec = kTileF / 4 / kThreads;
      const float4* src = reinterpret_cast<const float4*>(tile(a, J, J));
      float4 v[kVec];
#pragma unroll
      for (int it = 0; it < kVec; ++it)
        v[it] = __ldcg(src + tid + it * kThreads);
#pragma unroll
      for (int it = 0; it < kVec; ++it) {
        const int e = 4 * (tid + it * kThreads);
        *reinterpret_cast<float4*>(D + (e / kB) * kLdD + e % kB) = v[it];
      }
    }
    __syncthreads();
    if (tid < kB) rinv[tid] = 1.f / D[tid * kLdD + tid];
    __syncthreads();
    solve_tile<kLdD, kLdW, kW2>(D, rinv, W);
  }
  // U's rows rJ.. over the pair's columns (the diagonal tile: zeros below
  // its diagonal), and T's copies of those tiles (zeros past n)
  if (tid < kThreads) {
#pragma unroll 4
  for (int it = 0; it < kB * kW2 / kThreads; ++it) {
    const int e = tid + it * kThreads;
    const int j = e / kW2, i = e % kW2;
    if (rJ + j < n && rI + i < n && (i < kB || w == 2))
      Up[static_cast<long long>(rJ + j) * n + rI + i] =
          (!diag || i >= kB || i >= j) ? W[j * kLdW + i] : 0.f;
  }
#pragma unroll 4
  for (int it = 0; it < kB * kW2 / 4 / kThreads; ++it) {
    const int e = 4 * (tid + it * kThreads);
    const int j = e / kW2, i = e % kW2, h = i / kB, c = i % kB;
    if (h >= w) continue;
    float v[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const bool in = rI + i + x < n && rJ + j < n
                      && (!diag || h == 1 || c + x >= j);
      v[x] = in ? W[j * kLdW + i + x] : 0.f;
    }
    st4(tile(a, J, I0 + h) + j * kB + c, v);
  }
  // L's upper triangle: U's mirrored tiles (rows of the second tile, or of
  // both off the diagonal; columns rJ..)
  const int r0 = diag ? kB : 0;
#pragma unroll 4
  for (int it = 0; it < kB * kW2 / kThreads; ++it) {
    const int e = tid + it * kThreads;
    const int i = e / kB, j = e % kB;
    if (i >= r0 && rI + i < n)
      Up[static_cast<long long>(rI + i) * n + rJ + j] = 0.f;
  }
  }
  fence_proxy_async();
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    st_release(word(a, J, I0), epoch);
    if (w == 2) st_release(word(a, J, I0 + 1), epoch);
  }
}

// every tile word holds the epoch (each thread a share, then the block's
// barrier)
__device__ __forceinline__ void wait_all(const Args& a) {
  const long long ntri = tile_id(0, a.nt);
  for (long long v = threadIdx.x; v < ntri; v += kBlock)
    wait_word(a.words + v, a.epoch);
  __syncthreads();
}

// tile row r of a failed matrix: all NaN
__device__ __forceinline__ void fill_task(const Args& a, int r) {
  wait_all(a);
  if (ld_acquire(a.words + tile_id(0, a.nt)) != a.epoch) return;
  const int n = a.n;
  const int r0 = r * kB, r1 = min(n, r0 + kB);
  const long long len = static_cast<long long>(r1 - r0) * n;
  float* base = a.U + static_cast<long long>(r0) * n;
  for (long long e = threadIdx.x; e < len; e += kBlock)
    base[e] = __int_as_float(0x7fc00000);
}

// the flag: the matrix failed
__device__ __forceinline__ void flag_task(const Args& a) {
  wait_all(a);
  if (threadIdx.x != 0) return;
  *a.bad = ld_acquire(a.words + tile_id(0, a.nt)) == a.epoch ? 1 : 0;
}

__global__ void __launch_bounds__(kBlock, 1) whole_chol_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long s_task;
  const long long n_task = static_cast<long long>(a.n_order) + a.nt + 1;
  for (;;) {
    __syncthreads();   // the previous task is done with shared memory
    if (threadIdx.x == 0) s_task = next_task(a.ctr, a.epoch);
    __syncthreads();
    const long long t = s_task;
    if (t >= n_task) return;
    if (t < a.n_order) {
      const int code = __ldg(a.order + t);
      pair_task(a, code >> 16, code & 0xffff, smem);
    } else if (t < a.n_order + a.nt) {
      fill_task(a, static_cast<int>(t - a.n_order));
    } else {
      flag_task(a);
    }
  }
}

int launch(Args a, cudaStream_t s) {
  constexpr int kMaxDev = 64;
  static int blocks_of[kMaxDev] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDev) return -4;
  if (blocks_of[dev] == 0) {
    int coop = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop) return -2;
    e = cudaFuncSetAttribute(whole_chol_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, whole_chol_kernel, kBlock, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return -3;
    blocks_of[dev] = per_sm * sms;
  }
  a.nt = (a.n + kB - 1) / kB;
  const long long tasks = static_cast<long long>(a.n_order) + a.nt + 1;
  const unsigned grid = static_cast<unsigned>(
      tasks < blocks_of[dev] ? tasks : blocks_of[dev]);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(whole_chol_kernel), grid, kBlock, args,
      kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk34

// A: (n, n) f32 contiguous, its lower triangle read; U: (n, n) f32
// contiguous, not A, written with L^T (L column major, zeros below U's
// diagonal; all NaN if the matrix failed); T: scratch of nt (nt + 1) / 2
// 128 x 128 f32 tiles (nt = ceil(n / 128)), 16-byte aligned, contents
// ignored; order: n_order int32 pair tasks (J << 16 | I0, I0 = J, J + 2,
// ... < nt for every column J), in an order where every tile a task reads
// is written by a task before it (dd2d.whole_chol_order); bad: one byte,
// written 1 if the matrix failed, else 0. words: at least nt (nt + 1) / 2
// + 1 32-bit words, ctr: one 64-bit word; both zeros once at allocation,
// then left to the kernel; epoch: nonzero, a new one each call on them.
// Returns 0, a CUDA error code, -2 without cooperative launch, -3 when no
// block fits on an SM, -4 for a device ordinal beyond the cache.
extern "C" int dot_whole_chol(const void* A, void* U, void* T, int n,
                              const void* order, int n_order, unsigned epoch,
                              void* words, void* ctr, void* bad,
                              void* stream) {
  if (n == 0) return 0;
  dotk34::Args a{static_cast<const float*>(A), static_cast<float*>(U),
                 static_cast<float*>(T), static_cast<const int*>(order), n,
                 0, n_order, epoch, static_cast<unsigned*>(words),
                 static_cast<unsigned long long*>(ctr),
                 static_cast<unsigned char*>(bad)};
  return dotk34::launch(a, static_cast<cudaStream_t>(stream));
}
