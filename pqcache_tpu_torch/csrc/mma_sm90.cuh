// Hopper (sm_90a) building blocks shared by the prefill kernels K2
// (flash_attention.cu) and K4 (flash_scores.cu) and the decode kernels K1
// (block_attn.cu), K3 (adc.cu) and the scorer J (jhist_mass.cu): mma.sync
// m16n8k16 in bf16, the wgmma shared-memory descriptor for
// 128-byte swizzled tiles, wgmma.mma_async (A from shared memory or from
// registers) with its fence / commit / wait, mbarrier rings, TMA tile loads
// (cp.async.bulk.tensor with complete_tx) and 1-D bulk copies, setmaxnreg,
// split cluster barriers, and on the host the CUtensorMap encoder and the
// cluster launch.
//
// Tile layout in shared memory. A bf16 tile of R rows and D columns is
// loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B as D / 64 boxes of 64
// columns (128 bytes, the swizzle span): box c holds columns [64c, 64c + 64)
// of every row at byte offset c * R * 128, one 128-byte row after another,
// 8-row groups of 1024 bytes. Every box starts on a 1024-byte boundary, so
// the hardware swizzle (address bits [4:6] ^= bits [7:9]) agrees between
// TMA and wgmma.
//  * K-major operand (the reduction index is the column: Q and K in Q K^T,
//    K and Q in K Q^T): a 16-deep k-step kk reads box kk / 4 at byte offset
//    (kk % 4) * 32; SBO = 1024 (the next 8 rows), LBO unused.
//  * MN-major operand (the reduction index is the row: V in P V, read with
//    the transpose-B immediate): a 16-deep k-step reads rows [16kk, 16kk +
//    16), i.e. byte offset kk * 2048; SBO = 1024 (the next 8 rows of k),
//    LBO = R * 128 (the next box of 64 output columns).
// The tensor map is 3-D [heads, T, D], so rows at or past T are zero-filled
// inside a head and the next head is never read.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -__builtin_huge_valf();

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats -> packed bf16 pair, `lo` in the low 16 bits
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- registers
// Move registers between warpgroups: every warp of the warpgroup executes
// it. The SM gives each of its four sub-partitions 16384 registers, and a
// CTA of 12 warps puts 3 on each: 168 registers a thread at launch. A
// producer warpgroup that drops to 40 lets two consumers rise to 232 (ptxas
// still compiles the consumer code for 168: see flash_attention.cu).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------- named barriers
// bar.sync waits until `n` threads have reached barrier `id` (arrivals from
// bar.arrive count too); bar.arrive counts this warp and goes on. Id 0 is
// __syncthreads'.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0: waiting on parity 1 passes at once (the "previous" phase).
// A wait of more than ~2^34 cycles (seconds) can only be a deadlock: it
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// ------------------------------------------------------------------ clusters
// barrier.cluster in two halves: every thread of every CTA of the cluster
// arrives (release), and its wait (acquire) returns once all have arrived;
// work between the two overlaps the barrier
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// an arrival that orders nothing: with a wait before the first access to a
// peer's shared memory, it makes sure every CTA of the cluster has started
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------- TMA
// One box of a 3-D tensor map into shared memory; completion is counted
// on `bar` in bytes. Coordinates: (column, row, head).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}
// one box of a 2-D tensor map into shared memory; coordinates (column, row)
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory, counted on `bar` like a tile
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// a [R rows, D] tile at (row, head): D / 64 boxes of [R][64]
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_3d(dst + c * R * 128, map, bar, c * 64, row, head);
}

// ----------------------------------------------------------------- mma.sync
// c[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 out. Lane (j, t) = (lane
// / 4, lane % 4) holds a0: A row j, k 2t + {0, 1}; a1: row j + 8; a2, a3:
// the same at k + 8; b0: B column j, k 2t + {0, 1}; b1: k + 8; c[0], c[1]:
// row j, columns 2t + {0, 1}; c[2], c[3]: row j + 8
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// -------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// k-step kk of a K-major tile with R rows, from row `row0` of the tile
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int row0,
                                                int kk) {
  return wg_desc(tile + (kk / 4) * R * 128 + row0 * 128 + (kk % 4) * 32, 16,
                 1024);
}
// k-step kk (rows [16kk, 16kk + 16)) of an MN-major tile with R rows
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return wg_desc(tile + kk * 2048, R * 128, 1024);
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
// keep the compiler from moving accumulator registers across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define PQ_F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PQ_REGS32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define PQ_REGS64                                                          \
  PQ_REGS32 ", "                                                           \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "  \
  "%60, %61, %62, %63"

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory,
// both K-major; scale_d 0 overwrites D. The accumulator layout: thread
// (warp w, lane) holds rows 16w + lane / 4 (+ 8), columns 8j + 2 (lane % 4)
// (+ 1) as d[4j + {0, 1}] (row) and d[4j + {2, 3}] (row + 8).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" PQ_REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : PQ_F8(0), PQ_F8(8), PQ_F8(16), PQ_F8(24), PQ_F8(32), PQ_F8(40),
        PQ_F8(48), PQ_F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] B[16 x N], A from registers (the layout of the
// accumulator above, two bf16 per register: a[0] rows r, k 2c..; a[1] rows
// r + 8; a[2], a[3] the same at k + 8), B from shared memory, MN-major
// (transpose-B immediate 1).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" PQ_REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : PQ_F8(0), PQ_F8(8), PQ_F8(16), PQ_F8(24), PQ_F8(32), PQ_F8(40),
        PQ_F8(48), PQ_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" PQ_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PQ_F8(0), PQ_F8(8), PQ_F8(16), PQ_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int D>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128_tb(d, a, db);
  else
    wgmma_rs_n64_tb(d, a, db);
}

#undef PQ_F8
#undef PQ_REGS32
#undef PQ_REGS64

// ------------------------------------------------------------- host: TMA map
// cuTensorMapEncodeTiled is a driver function; it is looked up through the
// runtime so the libraries need no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// 3-D map of a contiguous bf16 [heads, rows, D] tensor, boxes of
// [1, box_rows, 64] with the 128-byte swizzle; out-of-range rows read 0.
inline cudaError_t make_tmap(CUtensorMap* map, const void* ptr, int heads,
                             int rows, int D, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return cudaErrorInitializationError;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------- host: clusters
inline int device_attr(cudaDeviceAttr a) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, a, dev);
  return v;
}
inline int sm_count() {
  static const int n = device_attr(cudaDevAttrMultiProcessorCount);
  return n;
}
// the most shared memory one block may opt in to (227 KB on an H100)
inline int optin_smem() {
  static const int n = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  return n;
}

// Let `kernel` take all the dynamic shared memory a block may opt in to and
// clusters of up to 16 CTAs (8 is the portable limit). Call it once per
// kernel and process, so that a launch inside a CUDA-graph capture makes no
// attribute call.
template <typename K>
cudaError_t allow_big_clusters(K kernel) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin_smem() - (int)fa.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// launch `kernel` on `grid` with clusters of grid.x CTAs along x
template <typename... Exp, typename... Act>
cudaError_t launch_cluster(void (*kernel)(Exp...), dim3 grid, int threads,
                           size_t smem, cudaStream_t stream, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = grid.x;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// 2-D map of a contiguous [rows, cols] tensor of bf16 or uint8 elements
// (one row 16-byte aligned), boxes of [box_rows, 128 bytes] with the
// 128-byte swizzle; rows at or past `rows` read 0.
inline cudaError_t make_tmap_2d(CUtensorMap* map, const void* ptr,
                                CUtensorMapDataType type, int elem_bytes,
                                long long rows, int cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r =
      fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
