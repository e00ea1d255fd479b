// Warp-level helpers shared by the tensor-core attention kernels (K2 in
// flash_attention.cu, K4 in flash_scores.cu): cp.async tile copies, the
// mma.sync m16n8k16 bf16 product with f32 accumulators, and bf16 packing.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> packed bf16 pair, `lo` in the low 16 bits
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment (16 x 16 bf16, row-major) of a tile row-block in shared
// memory: rows r0 and r0 + 8 of `base`'s 16, columns c0.. and c0 + 8..
// (base already offset by the fragment's row r0 and column c0).
__device__ __forceinline__ void ld_frag_a(uint32_t a[4], const uint16_t* base,
                                          int ld) {
  a[0] = ld_u32(base);
  a[1] = ld_u32(base + 8 * ld);
  a[2] = ld_u32(base + 8);
  a[3] = ld_u32(base + 8 * ld + 8);
}

}  // namespace
