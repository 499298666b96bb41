// K31 schur_update: the block scan's Schur-complement update
//   out[b] = float(D[b]) - float(A[b]) float(A[b])^T
// for a batch of (n x n) blocks: D in bf16 or f32, A in bf16, out in f32,
// on the tiles that hold the lower triangle (diagonal tiles in full). The
// strictly-upper tiles of out are never written: the scan's next K6 call
// reads the lower triangle only.
//
// Replaces dot_tpu/steppers/core.py:1544-1548 (_btd_scan_equilibrated's
// SYRK, dot_general(Lb, Lb, preferred_element_type=f32) on the bf16 Lb)
// and the subtraction from the next diagonal block around it. A product of
// two bf16 values is exact in f32, so Hopper's bf16 tensor cores with f32
// accumulation compute the reference's numbers; only the order of the sum
// differs. It takes the place of four casts, an f32 SIMT GEMM, the upcast
// of D and a subtraction.
//
// Bound on the H100 at the bar135 scan step (133 blocks of 768): the
// bytes. The lower triangle holds 60.4 GFLOP (0.061 ms at the 989 TFLOP/s
// bf16 rate); A read once in bf16, D's lower triangle read in bf16 and
// out's written in f32 are 0.39 GB (0.117 ms at 3.35 TB/s).
//
// Design: a persistent kernel over (matrix, lower 64 x 64 tile) work items,
// the items of one matrix next to each other so that its A stays in L2. A
// block is one consumer warpgroup and one producer warp; three blocks share
// an SM, so one block's epilogue overlaps another's products. The producer
// walks the block's items and their 64-wide k-slabs and loads both operands
// of a slab, row blocks of the same A read K-major, by TMA (128-byte
// swizzle; rows and columns past n come in as zeros) into a ring of stages
// guarded by mbarriers; a diagonal tile loads its one row block once. The
// consumers run wgmma (m64n64k16, bf16 from shared memory, f32 sums in
// registers), keep one slab's products in flight while the stage before is
// handed back, and in the epilogue read D's tile in pairs, eight loads in
// flight a thread, upcast it and store D - the sums in f32 as streaming
// pairs (evict-first: out, 314 MB at the bar135 step, cannot stay in the
// 50 MB L2; A can): no sum goes through device memory. At the bar135 step
// (H100 SXM, 700 W) this took 0.24 ms; a first epilogue that read one
// element at a time 0.34, and 128 x 128 tiles (two consumer warpgroups,
// one block an SM) 0.25. Every output element is one thread's sum over k
// in a fixed order, so the result repeats bit for bit. A's rows must lie
// 16-byte aligned (n a multiple of 8: the wrapper pads other widths).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dotk31 {

constexpr int kBK = 64;                     // a k-slab: 64 bf16 = 128 bytes
constexpr int kRowBytes = kBK * 2;
constexpr int kTile = 64;                   // rows = columns of a tile
constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kOpBytes = kTile * kRowBytes;  // one operand's slab
constexpr int kStageBytes = 2 * kOpBytes;
constexpr int kStages = 4;
constexpr int kAcc = kTile / 2;             // f32 sums a thread
// + 1024: the stages start on the swizzle pattern's 1024-byte period
constexpr size_t kSmem = static_cast<size_t>(kStages) * kStageBytes + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

// a wait that outlasts 2^34 cycles (~9 s) traps: a launch error, never a
// hung card
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1LL << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

// rows [row, row + 64) x columns [k, k + 64) of matrix b into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row), "r"(b)
      : "memory");
}

// the wgmma descriptor of a K-major operand in 128-byte swizzled rows:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching the sums before the wait
__device__ __forceinline__ void fence_sums(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// one m64n64k16 product from shared memory (bf16 A and B, both K-major),
// added to d in f32, or written over d where `acc` is 0
__device__ __forceinline__ void wgmma(float (&d)[kAcc], uint64_t da,
                                      uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// work item -> (matrix b, lower tile (ti, tj), tj <= ti)
__device__ __forceinline__ void decode(long long it, int tri, int& b,
                                       int& ti, int& tj) {
  b = static_cast<int>(it / tri);
  const int t = static_cast<int>(it - static_cast<long long>(b) * tri);
  int i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  ti = i;
  tj = t - i * (i + 1) / 2;
}

template <typename TD>
__global__ void __launch_bounds__(kThreads, 3)
schur_kernel(const __grid_constant__ CUtensorMap map,
             const TD* __restrict__ D, long long d_stride, int n, int tri,
             long long items, int nk, float* __restrict__ out, int vec) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer: one thread walks the block's items and their slabs
    if (threadIdx.x != kConsumers) return;
    int stage = 0, phase = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      int b, ti, tj;
      decode(it, tri, b, ti, tj);
      const bool diag = ti == tj;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], diag ? kOpBytes : kStageBytes);
        unsigned char* a = tiles + stage * kStageBytes;
        tma_load(a, &map, &full[stage], ks * kBK, ti * kTile, b);
        if (!diag)
          tma_load(a + kOpBytes, &map, &full[stage], ks * kBK, tj * kTile,
                   b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: the warpgroup's sums of one 64 x 64 tile
  const int t = threadIdx.x;
  const int lane = t % 32;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  int stage = 0, phase = 0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    int b, ti, tj;
    decode(it, tri, b, ti, tj);
    const bool diag = ti == tj;
    int prev = -1;
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a = tiles + stage * kStageBytes;
      const uint32_t sa = smem_u32(a);
      const uint32_t sb = smem_u32(diag ? a : a + kOpBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma(acc, desc(sa + kk * 32), desc(sb + kk * 32), (ks | kk) != 0);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_sums(acc);
    mbar_arrive(&empty[prev]);

    // the epilogue: thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8)
    // and columns 8 c + 2 (l % 4) (+ 1) of the tile
    const TD* Db = D + b * d_stride;
    float* Ob = out + static_cast<long long>(b) * n * n;
    const int r0 = ti * kTile + (t / 32) * 16 + lane / 4;
    const int c0 = tj * kTile + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= n) continue;
      const TD* Dr = Db + static_cast<long long>(r) * n;
      float* Or = Ob + static_cast<long long>(r) * n;
      if (vec) {
        // the row's eight pairs of D in flight, then eight streaming stores
        float2 dv[kTile / 8];
#pragma unroll
        for (int c = 0; c < kTile / 8; ++c) {
          const int col = c0 + 8 * c;
          dv[c] = col < n ? load2(Dr + col) : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int c = 0; c < kTile / 8; ++c) {
          const int col = c0 + 8 * c;
          if (col < n)
            __stcs(reinterpret_cast<float2*>(Or + col),
                   make_float2(dv[c].x - acc[4 * c + 2 * h],
                               dv[c].y - acc[4 * c + 2 * h + 1]));
        }
      } else {
#pragma unroll
        for (int c = 0; c < kTile / 8; ++c) {
          const int col = c0 + 8 * c;
          if (col < n) Or[col] = to_f32(Dr[col]) - acc[4 * c + 2 * h];
          if (col + 1 < n)
            Or[col + 1] = to_f32(Dr[col + 1]) - acc[4 * c + 2 * h + 1];
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the grid: every co-resident block (occupancy x SMs), at most one an item
template <typename TD>
int launch(const void* D, long long d_stride, const void* A, int lda,
           long long batch, int n, float* out, cudaStream_t s) {
  constexpr int kMaxDev = 64;
  static int blocks_of[kMaxDev] = {0};
  auto kern = schur_kernel<TD>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDev) return -4;
  if (blocks_of[dev] == 0) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return -3;
    blocks_of[dev] = per_sm * sms;
  }
  EncodeTiled enc = encoder();
  if (enc == nullptr) return -7;
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(lda) * 2,
                                 static_cast<cuuint64_t>(lda) * n * 2};
  const cuuint32_t box[3] = {kBK, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(A),
          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -8;
  const int nt = (n + kTile - 1) / kTile;
  const int tri = nt * (nt + 1) / 2;
  const long long items = batch * tri;
  const unsigned grid = static_cast<unsigned>(
      items < blocks_of[dev] ? items : blocks_of[dev]);
  const int nk = (n + kBK - 1) / kBK;
  // D and out as pairs: an even width and D's blocks on 2-element bounds
  const int vec = n % 2 == 0 && d_stride % 2 == 0
                  && reinterpret_cast<uintptr_t>(D) % (2 * sizeof(TD)) == 0;
  kern<<<grid, kThreads, kSmem, s>>>(map, static_cast<const TD*>(D),
                                     d_stride, n, tri, items, nk, out, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dotk31

// d_dtype: 0 f32, 2 bf16 (D's blocks d_stride elements apart, rows n);
// A: (batch, n, lda) bf16, lda a multiple of 8, 16-byte aligned; out:
// (batch, n, n) f32. Returns 0, a CUDA error code, -3 when no block fits
// on an SM, -4 for a device ordinal beyond the cache, -6 for a dtype of D
// not built, -7 when libcuda offers no cuTensorMapEncodeTiled, -8 when it
// refuses the tensor map.
extern "C" int dot_schur_update(int d_dtype, const void* D,
                                long long d_stride, const void* A, int lda,
                                long long batch, int n, void* out,
                                void* stream) {
  if (batch == 0 || n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  if (d_dtype == 2)
    return dotk31::launch<__nv_bfloat16>(D, d_stride, A, lda, batch, n, o,
                                         s);
  if (d_dtype == 0)
    return dotk31::launch<float>(D, d_stride, A, lda, batch, n, o, s);
  return -6;
}
