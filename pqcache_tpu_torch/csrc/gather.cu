// K6: batched row gather, hand-written for Hopper (sm_90a).
//
// Replaces pqcache_tpu/ops/gather_pallas.py::gather_rows (body _gather_kernel):
//   src  [H_total, T, row_bytes]   rows of any type (bf16, int8, f32), read raw
//   idx  [H, K] int32 or int64
//   -> out [H, K, row_bytes],  out[h, j] = src[head_offset + h, idx[h, j]]
// An index outside [0, T) is clamped into it, as XLA's gather does, so the
// kernel never reads outside src. head_offset picks a contiguous range of
// heads, e.g. one layer of the stacked [L * H_kv, T, 2D] tail, without a copy.
//
// What bounds it: nothing but the copy, so bytes. At the 32k decode shapes
// (8 kv heads x 3273 rows of 512 B in bf16) 13.4 MB are read and 13.4 MB
// written: 8.0 us at 3.35 TB/s, 4.0 us for an int8 tail's 256-B rows.
//
// Design: the TPU kernel fetched each row's aligned sublane tile by DMA, after
// a scalar prefetch of the indices, and selected the row in VMEM. Here rows
// are read straight from device memory. A CTA of NWARPS warps takes one head
// and NWARPS * ROWS consecutive entries of idx; a warp copies ROWS rows, its
// lanes striding over the rows' UNIT-sized pieces (16 bytes where the row
// size allows, so a 512-B bf16 row is one 16-byte load per lane and a 256-B
// int8 row half a warp's width, the other half taking the next row). Each
// lane issues all its loads before its first store, so a warp keeps ROWS rows
// in flight. A warp reads its row indices from idx itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int ROWS = 8;            // rows per warp
constexpr int UNROLL = 8;          // pieces in flight per lane

template <typename U, typename IT>
__global__ void __launch_bounds__(32 * NWARPS)
gather_kernel(const U* __restrict__ src, const IT* __restrict__ idx, int T, int K,
              int units, int head_offset, U* __restrict__ out) {
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = ((int)blockIdx.x * NWARPS + warp) * ROWS;
  const int nrows = min(ROWS, K - r0);
  if (nrows <= 0) return;
  const int total = nrows * units;
  const U* src_h = src + (size_t)(head_offset + h) * T * units;
  const IT* idx_h = idx + (size_t)h * K + r0;
  U* out_h = out + ((size_t)h * K + r0) * units;
  for (int base = 0; base < total; base += 32 * UNROLL) {
    U v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int u = base + k * 32 + lane;
      if (u < total) {
        const int r = u / units;
        long long row = (long long)idx_h[r];
        row = row < 0 ? 0 : (row >= T ? T - 1 : row);
        v[k] = src_h[(size_t)row * units + (u - r * units)];
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int u = base + k * 32 + lane;
      if (u < total) out_h[u] = v[k];
    }
  }
}

template <typename U, typename IT>
cudaError_t launch(const void* src, const void* idx, int H, int K, int T, int row_bytes,
                   int head_offset, void* out, cudaStream_t st) {
  const int per_cta = NWARPS * ROWS;
  gather_kernel<U, IT><<<dim3((K + per_cta - 1) / per_cta, H), 32 * NWARPS, 0, st>>>(
      static_cast<const U*>(src), static_cast<const IT*>(idx), T, K,
      row_bytes / (int)sizeof(U), head_offset, static_cast<U*>(out));
  return cudaGetLastError();
}

template <typename IT>
cudaError_t by_unit(const void* src, const void* idx, int H, int K, int T, int row_bytes,
                    int head_offset, void* out, cudaStream_t st) {
  // the widest piece that divides the row and keeps every access aligned
  const uintptr_t al = (uintptr_t)src | (uintptr_t)out | (uintptr_t)row_bytes;
#define PQ_ARGS src, idx, H, K, T, row_bytes, head_offset, out, st
  if (al % 16 == 0) return launch<uint4, IT>(PQ_ARGS);
  if (al % 8 == 0) return launch<uint2, IT>(PQ_ARGS);
  if (al % 4 == 0) return launch<unsigned int, IT>(PQ_ARGS);
  if (al % 2 == 0) return launch<unsigned short, IT>(PQ_ARGS);
  return launch<unsigned char, IT>(PQ_ARGS);
#undef PQ_ARGS
}

}  // namespace

// src [H_total, T, row_bytes] and out [H, K, row_bytes] contiguous, as raw
// bytes; idx [H, K] contiguous, idx_bytes 4 (int32) or 8 (int64);
// 0 <= head_offset and head_offset + H <= H_total (the caller checks).
// Returns a cudaError_t (0 = launched).
extern "C" int pq_gather_rows(const void* src, const void* idx, int idx_bytes, int H,
                              int K, int T, int row_bytes, int head_offset, void* out,
                              void* stream) {
  if (H < 1 || K < 1 || T < 1 || row_bytes < 1 || head_offset < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) return by_unit<int32_t>(src, idx, H, K, T, row_bytes, head_offset, out, st);
  if (idx_bytes == 8) return by_unit<int64_t>(src, idx, H, K, T, row_bytes, head_offset, out, st);
  return cudaErrorInvalidValue;
}
