// K1: block-retrieval decode attention, hand-written for Hopper (sm_90a).
//
// Replaces pqcache_tpu/ops/block_attn_pallas.py::block_topk_attention (Pallas
// body _kernel). Same function: the online-softmax partials (m, l, acc) of the
// g query rows of each kv head over the selected `bs`-row blocks of one layer
// of the interleaved KV tail, logits x 1/sqrt(D), tail rows >= n_cand masked.
//   q        [H_kv, g, D]            bf16 with a bf16 tail; f32 with an int8
//                                    tail (the caller folds the K scale in)
//   kv_tail  [L, H_kv, N, 2D]        bf16 or int8 (rows read raw; the caller
//                                    applies the V scale to acc)
//   blk_idx  [H_kv, nb_sel]          int32 or int64 selected block ids; an id
//                                    out of range counts as all masked
//   n_cand   [H_kv] int32 or one scalar, in device memory or by value
//   win_len  with win_max > 0 (local-window coverage): the rows [n_cand,
//            n_cand + win_len) of each head are attended too, win_len cut to
//            [0, min(win_max, N - n_cand)]; [H_kv] int32 or one scalar, in
//            device memory or by value (a CUDA graph replays what the card
//            holds, so a count that changes every step is read there)
//   -> m, l  [H_kv, g] f32, acc [H_kv, g, D] f32; a head with no unmasked
//      row gives (-1e30, 0, 0). The TPU kernel computes q, k, v and p in
//      f32; here they reach the tensor cores as bf16 or f16 pairs that carry
//      f32 to 2^-17 or better (below), with f32 sums.
//
// What bounds it: every selected row is read once and used for g dot products
// and g axpys, about 4 FLOP/byte: far below the card's ridge, so it is bound by
// the bytes it moves: 8 kv heads x 13 blocks x 256 rows x 512 B = 13.5 MB per
// layer-step at 32k in bf16, 4.04 us at 3.35 TB/s; half that in int8. The
// batched decode adds the local window and folds the slots into the heads:
// at the 128k decode cell (24 slots x 8 kv heads = 192 folded heads, 52
// blocks and a window of 12976 rows, int8) 26288 rows x 256 B x 192 heads =
// 1.29 GB per layer-step, 385 us. What held it below that was per-row work
// on the chip, not bytes: a CTA walked ~24 M rows/s whatever the row's width
// (the producer marked each row by a read-modify-write of shared memory,
// ~70 cycles a row at 23.5 M rows/s; the int8 consumer spent 64 MMAs and
// 64 I2F-pair conversions on 16 rows). On an H100 (700 W) at the 128k cell's shape this
// kernel takes 541 us (71% of the bytes' time) where that design took 1116
// us. The 192 CTAs, one a head, put two on 60 SMs and one on 72, and the
// pairs set the time (132 heads, one on every SM, take 475 us); with the
// consumers' work skipped the launch takes 500 us, so what is left is the
// ring's: one producer thread and three stages in flight per CTA.
//
// Design: one launch. Each kv head gets a thread-block cluster of CTAs (16
// at H_kv = 8; the largest power of two whose clusters all fit on the card
// at once, fewer as H_kv grows, so the grid about fills the SMs). CTA i of a
// head takes an equal contiguous share of the head's selected rows in
// blk_idx order (selection row j is row j % bs of block blk_idx[h, j / bs])
// and reads its block ids itself, turning each into the row range [lo, hi)
// of its block to read (the valid rows, [0, n_cand), cut to the share; an
// out-of-range block is an empty range). The local window is win_max more
// selection rows after the selected blocks, entry nb_sel + i holding the
// window's rows [i bs, (i + 1) bs): the contiguous range [n_cand + i bs,
// ...) of the tail, cut to win_len. Candidates lie below n_cand and the
// window at or above it, so no row is read twice, at the tail's end too
// (the TPU kernel's clamped duplicate entries have no counterpart here).
// The pair fetch of the TPU kernel (2 bs-row DMAs, the unselected half
// masked) computes the same function; its rows are already contiguous
// ranges here, so it has no separate path.
//   * Loads: one producer thread packs the ranges into a ring of NSTAGE
//     32 KB stages and fills them by TMA (cp.async.bulk.tensor over the
//     layer's tail as a 2-D tensor of rows, boxes of 32 or 8 rows, byte
//     completion on a full mbarrier), marking the stage's rows to use: a
//     box's rows are one run of at most 32 bits, set in at most two words of
//     a mask kept in registers and stored once a stage. The
//     1-D bulk copy would fit contiguous rows too, but it cannot swizzle: the
//     tensor copy writes the 128-byte swizzle that lets ldmatrix read 8 rows
//     without bank conflicts. A range's last 8-row box may fetch up to 7 rows
//     past its end (not marked, never used); no other row outside a range
//     is fetched.
//   * Compute: four consumer warps take the stages' 16-row groups in turn
//     and multiply with mma.sync m16n8k16, f32 sums: a first version on the
//     CUDA cores, f32 FMAs from shared memory, took 21-25 us on an H100 at
//     the main shapes, held back by its instruction count, not its bytes.
//     Accuracy as the TPU kernel's f32. The online softmax runs in f32 on
//     the accumulator fragments, and P reaches the second product without
//     leaving the registers. Rows not to use get p = 0. A warp frees a stage
//     by one arrival on its empty mbarrier.
//       bf16 tail: S = Q K^T and P V with the g heads on the MMA's M side
//     (rows g..15 zero) and the rows on N; a bf16 q times a bf16 k is exact,
//     p enters as hi + lo bf16 pairs (two products), good to 2^-17; a row's
//     max is over the 4 lanes of a quad, and P's A fragment is S's C
//     fragment. Rows not to use may hold anything, and 0 x NaN is NaN: their
//     V is zeroed in the stage.
//       int8 tail: the rows on M and the heads on N, S^T = K q^T and acc^T =
//     V^T P^T, four heads to an n8 tile as (hi, lo) column pairs, so one MMA
//     does a 16-channel step for every head and both halves: 16 MMAs a group
//     at g <= 4, 32 at g 8. The MMAs are f16: an int8 row converts exactly
//     by one byte permute and one f16x2 subtraction a pair (0x6480: 1024 +
//     v + 128 - 1152), against two I2F and an F2F before; q, scaled per head
//     by the power of two that puts its largest |entry| in [2^13, 2^14), and
//     p, times 2^15, enter as f16 hi + lo pairs (2^-22, clear of f16's
//     overflow and subnormals), and the powers of two come off the f32 sums
//     exactly. P^T's B fragment is S^T's C fragment transposed by movmatrix;
//     a head's max and sum run over the 8 lanes of its column. int8 rows are
//     finite, so p = 0 alone masks a row. Measured at the 128k cell's shape
//     (H100, 700 W): the same layout in bf16, converted by W8's byte
//     permutes, took 627 us, by two I2F a pair 628 us, on 32-row groups 632
//     us; this one 541 us.
//   * Merge on chip: each CTA folds its warps into one (m, l, acc[g][D]),
//     then sends slice p of it, and its (m, l), to CTA p of the cluster
//     through distributed shared memory; after one cluster barrier each CTA
//     merges its slice from every CTA in rank order and writes it once. No
//     partials in device memory, no second kernel, no scratch; the same
//     inputs give bitwise the same output. The TPU's n_par DMA lanes have
//     no counterpart.

#include <cooperative_groups.h>
#include <cuda_fp16.h>

#include "mma_sm90.cuh"  // mbarriers, TMA, cluster barriers and launch

namespace cg = cooperative_groups;

namespace {

constexpr int NCW = 4;                      // consumer warps
constexpr int NTHREADS = 32 * (NCW + 1);    // and one producer warp
constexpr int STAGE_BYTES = 32 * 1024;
constexpr int NSTAGE = 3;
constexpr int RING_BYTES = NSTAGE * STAGE_BYTES;
constexpr int MAX_CTAS = 16;                // non-portable cluster limit
constexpr int BIG = 32, SMALL = 8;          // rows of the two TMA boxes
constexpr float MASKED = -1e30f;

template <typename KT, int D>
struct Cfg {
  static constexpr int ROW_BYTES = 2 * D * (int)sizeof(KT);
  static constexpr int COLS = 128 / (int)sizeof(KT);  // elements of a 128-byte box column
  static constexpr int NBOX = ROW_BYTES / 128;        // box columns of a row
  static constexpr int R = STAGE_BYTES / ROW_BYTES;   // rows of a stage
  static constexpr int MASK_WORDS = R / 32;
  static constexpr int KSTEPS = D / 16;               // 16 channels per mma
  static constexpr int DT = D / 8;                    // 8-wide output tiles
  static constexpr int V_CHUNKS = D * (int)sizeof(KT) / 16;   // 16-byte pieces of V
};

// byte `byte` of stage row `row`: box column byte / 128 holds every row of
// the stage, 128 bytes each, with the 16-byte pieces of a row XORed by
// row % 8 (TMA's 128-byte swizzle, 1024-byte atoms)
template <int R>
__device__ __forceinline__ uint32_t sw(uint32_t stage, int row, int byte) {
  return stage + (byte >> 7) * (R * 128) + row * 128 +
         ((((byte >> 4) & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldsm4(uint32_t a, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t a, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// mma16816 (mma_sm90.cuh) with f16 A and B
__device__ __forceinline__ void mma16816h(float (&c)[4], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// two f32 as bf16 pairs hi and lo with hi + lo = (x0, x1) to 2^-17
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}
// two f32 as f16 pairs hi and lo with hi + lo = (x0, x1) to 2^-22 for
// 2^-3 <= |x| <= 2^15 (below 2^-3, lo is subnormal: to 2^-25 absolute)
__device__ __forceinline__ void split16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 f = __half22float2(h);
  const __half2 l = __floats2half2_rn(x0 - f.x, x1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// one f32 as the f16 pair (hi, lo), hi low, as split16
__device__ __forceinline__ uint32_t hilo16(float x) {
  const __half h = __float2half_rn(x);
  const __half2 v = __halves2half2(h, __float2half_rn(x - __half2float(h)));
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two bytes of an int8 word as an exact f16 pair, by one byte permute and
// one f16x2 subtraction: wx = w ^ 0x80808080 holds v + 128 in each byte;
// `sel` puts two of them under 0x64 high bytes, the f16s 1024 + v + 128,
// and subtracting 0x6480 = 1152 leaves v (sel 0x4j4i: bytes i low, j high)
__device__ __forceinline__ uint32_t i8h2(uint32_t wx, uint32_t sel) {
  uint32_t x = __byte_perm(wx, 0x64646464u, sel);
  asm("sub.f16x2 %0, %0, %1;\n" : "+r"(x) : "r"(0x64806480u));
  return x;
}
// 2^e as an f32, for |e| < 127
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }
// the 8 x 8 b16 matrix whose row lane / 4 holds columns 2 (lane % 4) + {0,
// 1} in x, transposed: lane (j, t) gets elements (2t, j), (2t + 1, j)
__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ uint16_t bf16_bits(__nv_bfloat16 b) {
  return *reinterpret_cast<const uint16_t*>(&b);
}

// grid (CTAS, H_kv), cluster (CTAS, 1, 1), NTHREADS threads. Dynamic shared
// memory: 1024 bytes of alignment slack, the ring, one int4 (first row, lo,
// hi) per block of the share. CTA p of a cluster finishes the outputs
// [p * sl, p * sl + sl) of the g x D; every CTA sends it its partial of that
// slice and its (m, l).
template <typename QT, typename KT, int D, int G>
__global__ void __launch_bounds__(NTHREADS, 2)
block_attn_kernel(const __grid_constant__ CUtensorMap tm_big,
                  const __grid_constant__ CUtensorMap tm_small,
                  const QT* __restrict__ q, int layer, int H_kv, int N,
                  const void* __restrict__ blk_idx, int idx64, int nb_sel,
                  const int* __restrict__ n_cand_vec, int n_cand_stride,
                  int n_cand_scalar, int win_max, const int* __restrict__ win_vec,
                  int win_stride, int win_scalar, int bs,
                  float scale, float* __restrict__ m_out,
                  float* __restrict__ l_out, float* __restrict__ acc_out) {
  using C = Cfg<KT, D>;
  constexpr int R = C::R;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * NSTAGE];   // full, then empty
  __shared__ uint32_t rows_ok[NSTAGE][C::MASK_WORDS];  // rows of a stage to use
  __shared__ int st_rows[NSTAGE];                      // rows filled (+ 1 << 16: last)
  __shared__ float in_ml[MAX_CTAS][2 * G];             // every CTA's (m, l)
  __shared__ float in_acc[G * D + MAX_CTAS];           // [ncta][sl]
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int4* tab = reinterpret_cast<int4*>(ring + RING_BYTES);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ncta = (int)cluster.num_blocks();
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == NCW * 32) {   // the producer's descriptors, early
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_big)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_small)) : "memory");
  }
  const long long total = (long long)nb_sel * bs + win_max;
  const int j0 = (int)(total * rank / ncta);
  const int j1 = (int)(total * (rank + 1) / ncta);
  const int kb0 = j0 / bs;
  const int nblk = j1 > j0 ? (j1 - 1) / bs - kb0 + 1 : 0;

  // the share's blocks as row ranges [lo, hi) of the block to read: the
  // valid range (candidates are [0, n_cand)) cut to the share; the window's
  // entries: rows [n_cand, n_cand + win) of the tail, cut to the share
  const long long n_c = n_cand_vec ? n_cand_vec[h * n_cand_stride] : n_cand_scalar;
  long long win = 0;
  if (win_max) {
    win = win_vec ? win_vec[h * win_stride] : win_scalar;
    win = max(0ll, min(win, min((long long)win_max, (long long)N - n_c)));
  }
  for (int k = threadIdx.x; k < nblk; k += NTHREADS) {
    const int kb = kb0 + k;
    const int first = kb * bs;                // its first selection row
    int4 e = make_int4(0, 0, 0, 0);
    if (kb < nb_sel) {
      const size_t i = (size_t)h * nb_sel + kb;
      const long long blk = idx64 ? static_cast<const long long*>(blk_idx)[i]
                                  : static_cast<const int*>(blk_idx)[i];
      if (blk >= 0 && (blk + 1) * bs <= N) {
        const long long row0 = blk * bs;
        e.x = (int)row0;
        e.y = max(0, j0 - first);
        e.z = (int)min(min((long long)bs, n_c - row0), (long long)(j1 - first));
      }
    } else {
      const long long off = (long long)(kb - nb_sel) * bs;
      e.x = (int)(n_c + off);
      e.y = max(0, j0 - first);
      e.z = (int)min(min((long long)bs, win - off), (long long)(j1 - first));
    }
    if (e.z < e.y) e.z = e.y;
    tab[k] = e;
  }
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[NSTAGE]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full0 + 8 * s, 2);   // expect_tx, then the stage's row count
      mbar_init(empty0 + 8 * s, NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();
  cluster_arrive_relaxed();   // waited on before the first remote store

  if (warp == NCW) {
    // producer: one thread packs the share's ranges into the stages in
    // boxes of BIG or SMALL rows (a range's last box may run past its end:
    // those rows are not marked), counts the bytes, then issues the boxes
    if (lane == 0) {
      const int head_row = (layer * H_kv + h) * N;
      int kb = -1, r = 0, r1 = 0, row0 = 0;      // cursor: block, rows [r, r1)
      for (int st = 0;; ++st) {
        const int slot = st % NSTAGE;
        mbar_wait(empty0 + 8 * slot, ((st / NSTAGE) & 1) ^ 1);
        const uint32_t stage = smem_u32(ring + slot * STAGE_BYTES);
        uint32_t ok[C::MASK_WORDS];               // the stage's rows to use
#pragma unroll
        for (int w = 0; w < C::MASK_WORDS; ++w) ok[w] = 0u;
        const int kb_s = kb, r_s = r, r1_s = r1, row0_s = row0;
        int filled = 0;
        for (int pass = 0; pass < 2; ++pass) {     // count and mark, then copy
          if (pass) {
#pragma unroll
            for (int w = 0; w < C::MASK_WORDS; ++w) rows_ok[slot][w] = ok[w];
            mbar_expect_tx(full0 + 8 * slot, (uint32_t)filled * C::ROW_BYTES);
            kb = kb_s, r = r_s, r1 = r1_s, row0 = row0_s;
            filled = 0;
          }
          while (filled < R) {
            if (r >= r1) {
              if (++kb >= nblk) break;
              const int4 e = tab[kb];
              row0 = e.x, r = e.y, r1 = e.z;
              continue;
            }
            const int n = r1 - r;
            const int size = n >= BIG && filled + BIG <= R ? BIG : SMALL;
            if (!pass) {
              // the box's rows to use, [filled, filled + min(size, n)): a
              // run of at most 32 bits, so in at most two words
              const uint64_t run = ((1ull << min(size, n)) - 1) << (filled & 31);
              const int w0 = filled >> 5;
#pragma unroll
              for (int w = 0; w < C::MASK_WORDS; ++w) {
                if (w == w0) ok[w] |= (uint32_t)run;
                if (w == w0 + 1) ok[w] |= (uint32_t)(run >> 32);
              }
            } else {
#pragma unroll
              for (int c = 0; c < C::NBOX; ++c)
                tma_load_2d(stage + c * (R * 128) + filled * 128,
                            size == BIG ? &tm_big : &tm_small, full0 + 8 * slot,
                            c * C::COLS, head_row + row0 + r);
            }
            filled += size;
            r += size;
          }
        }
        // whether any row is left after this stage
        bool more = r < r1;
        for (int k = kb + 1; k < nblk && !more; ++k) more = tab[k].z > tab[k].y;
        st_rows[slot] = filled | (more ? 0 : 1 << 16);
        mbar_arrive(full0 + 8 * slot);   // the second arrival: the mark is done
        if (!more) break;
      }
    }
    __syncwarp();
  } else {
    // consumers: the 16-row groups of the share, counted across stages, go
    // to the warps in turn, so a stage of two groups and the next one are
    // taken by different warps. walk(group) calls group(stage, g0, okb) on
    // each of this warp's groups with a row to use (bit i of okb: row g0 + i
    // of the stage), then frees the ring for the warps' partials.
    auto walk = [&](auto&& group) {
      for (int st = 0, gbase = 0;; ++st) {
        const int slot = st % NSTAGE;
        mbar_wait(full0 + 8 * slot, (st / NSTAGE) & 1);
        const int info = st_rows[slot], filled = info & 0xffff;
        const uint32_t stage = smem_u32(ring + slot * STAGE_BYTES);
        const int first = (warp - gbase % NCW + NCW) % NCW;   // this warp's first group
        gbase += (filled + 15) / 16;
        for (int g0 = 16 * first; g0 < filled; g0 += NCW * 16) {
          const uint32_t okb = (rows_ok[slot][g0 >> 5] >> (g0 & 31)) & 0xffffu;
          if (okb) group(stage, g0, okb);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * slot);
        if (info >> 16) break;
      }
      // every stage is consumed (so every copy has landed): the ring is free
      // for the warps' partials [NCW][G][D + 2]
      named_bar_sync(1, NCW * 32);
    };
    const int t = lane & 3, gj = lane >> 2, mi = lane >> 3, lr = lane & 7;
    float* part = reinterpret_cast<float*>(ring) + warp * G * (D + 2);
    if constexpr (sizeof(KT) == 2) {
      // bf16 tail: lane (j, t) holds q head j's scores of rows 2t, 2t + 1,
      // 8 + 2t, 9 + 2t of a group, and its accumulator columns; A's rows
      // 8..15 and those of heads past g are 0
      const QT* qh = q + ((size_t)h * G + min(gj, G - 1)) * D;
      uint32_t qa[C::KSTEPS][2];   // channels 16kk + 2t + 8hf + {0, 1}
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = 16 * kk + 2 * t + 8 * hf;
          qa[kk][hf] = gj < G ? (uint32_t)bf16_bits(qh[c]) |
                                    ((uint32_t)bf16_bits(qh[c + 1]) << 16)
                              : 0u;
        }
      float acc[C::DT][4], m = MASKED, lsum = 0.f;
#pragma unroll
      for (int i = 0; i < C::DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      walk([&](uint32_t stage, int g0, uint32_t okb) {
        if (okb != 0xffffu) {
          // rows not to use may hold anything, and 0 x NaN is NaN in the
          // products: zero their V
          for (int i = lane; i < 16 * C::V_CHUNKS; i += 32) {
            const int rr = i / C::V_CHUNKS;
            if (!((okb >> rr) & 1u))
              asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                               sw<R>(stage, g0 + rr, 2 * D + (i % C::V_CHUNKS) * 16)),
                           "r"(0u) : "memory");
          }
          // order these writes before the stage's next fill by TMA
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
        }
        // S = Q K^T over the group's 16 rows: two 8-row tiles
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk) {
          uint32_t b[4];   // rows 0-7 (k, k + 8), rows 8-15 (k, k + 8)
          ldsm4(sw<R>(stage, g0 + lr + (mi >> 1) * 8, (16 * kk + (mi & 1) * 8) * 2), b);
          mma16816(s[0], qa[kk][0], 0u, qa[kk][1], 0u, b[0], b[1]);
          mma16816(s[1], qa[kk][0], 0u, qa[kk][1], 0u, b[2], b[3]);
        }
        // online softmax over the group, in f32
        const float v[4] = {s[0][0] * scale, s[0][1] * scale, s[1][0] * scale,
                            s[1][1] * scale};
        const int rows[4] = {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t};
        bool ok[4];
        float mx = MASKED;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ok[i] = (okb >> rows[i]) & 1u;
          if (ok[i]) mx = fmaxf(mx, v[i]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m, mx), corr = __expf(m - m_new);
        m = m_new;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = ok[i] ? __expf(v[i] - m_new) : 0.f;
        lsum = lsum * corr + ((p[0] + p[1]) + (p[2] + p[3]));
#pragma unroll
        for (int i = 0; i < C::DT; ++i) {
          acc[i][0] *= corr;
          acc[i][1] *= corr;
        }
        // P (f32) as hi + lo bf16 for P V: its A fragment is S's C fragment
        uint32_t ph0, pl0, ph2, pl2;
        split(p[0], p[1], ph0, pl0);
        split(p[2], p[3], ph2, pl2);
#pragma unroll
        for (int tp = 0; tp < C::DT; tp += 2) {
          uint32_t b[4];   // V^T: (d tile tp: rows 0-7, 8-15), then tp + 1
          ldsm4_t(sw<R>(stage, g0 + lr + (mi & 1) * 8, (D + 8 * (tp + (mi >> 1))) * 2), b);
          mma16816(acc[tp], ph0, 0u, ph2, 0u, b[0], b[1]);
          mma16816(acc[tp], pl0, 0u, pl2, 0u, b[0], b[1]);
          mma16816(acc[tp + 1], ph0, 0u, ph2, 0u, b[2], b[3]);
          mma16816(acc[tp + 1], pl0, 0u, pl2, 0u, b[2], b[3]);
        }
      });
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      if (gj < G) {
        float* o = part + gj * (D + 2);
#pragma unroll
        for (int i = 0; i < C::DT; ++i) {   // tile i: columns 8i + 2t + {0, 1}
          o[2 + 8 * i + 2 * t] = acc[i][0];
          o[3 + 8 * i + 2 * t] = acc[i][1];
        }
        if (t == 0) {
          o[0] = m;
          o[1] = lsum;
        }
      }
    } else {
      // int8 tail: the group's 16 rows on the MMA's M side and the heads on
      // N, four to an n8 tile as (hi, lo) column pairs: S^T = K q^T and
      // acc^T = V^T P^T, one f16 MMA per 16 channels for every head of the
      // tile and both halves. Lane (j, t) holds head 4T + t's scores of rows
      // j and j + 8 of a group, and its accumulators of channels 16c + 2j
      // (hi, lo) and 16c + 2j + 1 of each 16-channel chunk c. int8 is exact
      // in f16; q, times a power of two that puts each head's largest |q|
      // in [2^13, 2^14), and p, times 2^15, are f16 hi + lo pairs clear of
      // overflow and of the subnormals; the powers of two come off the f32
      // sums exactly. ldmatrix gives a lane an int8 row's channels in fours,
      // 4t .. 4t + 3 of 16, taken as k = 2t, 2t + 1, 2t + 8, 2t + 9: q is
      // packed in that order.
      constexpr int NT = (G + 3) / 4;
      constexpr float P_UP = 32768.f;
      uint32_t qb[NT][C::KSTEPS][2];   // column j: head 4T + j / 2, hi (j even) or lo
      float sc[NT];                    // head 4T + t's logit scale
#pragma unroll
      for (int T = 0; T < NT; ++T) {
        const int head = 4 * T + (gj >> 1);
        const QT* qh = q + ((size_t)h * G + min(head, G - 1)) * D;
        float qv[C::KSTEPS][4], mx = 0.f;
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qv[kk][e] = head < G ? qh[16 * kk + 4 * t + e] : 0.f;
            mx = fmaxf(mx, fabsf(qv[kk][e]));
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        int ex;
        frexpf(mx, &ex);   // mx < 2^ex
        const int up = mx > 0.f ? max(-126, min(126, 14 - ex)) : 0;
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            uint32_t hi, lo;
            split16(qv[kk][2 * hf] * pow2(up), qv[kk][2 * hf + 1] * pow2(up), hi, lo);
            qb[T][kk][hf] = gj & 1 ? lo : hi;
          }
        // head 4T + t was packed by the lanes of j = 2t
        sc[T] = scale * pow2(-__shfl_sync(0xffffffffu, up, 8 * t));
      }
      float acc[NT][C::KSTEPS][4], m[NT], lsum[NT];
#pragma unroll
      for (int T = 0; T < NT; ++T) {
        m[T] = MASKED;
        lsum[T] = 0.f;
#pragma unroll
        for (int i = 0; i < C::KSTEPS; ++i)
          acc[T][i][0] = acc[T][i][1] = acc[T][i][2] = acc[T][i][3] = 0.f;
      }
      walk([&](uint32_t stage, int g0, uint32_t okb) {
        // every int8 row is finite, so a row not to use needs only p = 0
        float s[NT][4];
#pragma unroll
        for (int T = 0; T < NT; ++T) s[T][0] = s[T][1] = s[T][2] = s[T][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; kk += 2) {
          uint32_t b[4];   // (rows 0-7, chunk kk), (rows 8-15, kk), then kk + 1
          ldsm4(sw<R>(stage, g0 + lr + (mi & 1) * 8, 16 * (kk + (mi >> 1))), b);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const uint32_t w0 = b[2 * x] ^ 0x80808080u, w1 = b[2 * x + 1] ^ 0x80808080u;
            const uint32_t a0 = i8h2(w0, 0x4140), a1 = i8h2(w1, 0x4140);
            const uint32_t a2 = i8h2(w0, 0x4342), a3 = i8h2(w1, 0x4342);
#pragma unroll
            for (int T = 0; T < NT; ++T)
              mma16816h(s[T], a0, a1, a2, a3, qb[T][kk + x][0], qb[T][kk + x][1]);
          }
        }
        // online softmax over the group, in f32: a head's rows lie across
        // the 8 lanes of its t
        const bool ok0 = (okb >> gj) & 1u, ok1 = (okb >> (gj + 8)) & 1u;
        uint32_t pb[NT][2];
#pragma unroll
        for (int T = 0; T < NT; ++T) {
          const float v0 = (s[T][0] + s[T][1]) * sc[T], v1 = (s[T][2] + s[T][3]) * sc[T];
          float mx = fmaxf(ok0 ? v0 : MASKED, ok1 ? v1 : MASKED);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_new = fmaxf(m[T], mx), corr = __expf(m[T] - m_new);
          m[T] = m_new;
          const float p0 = ok0 ? __expf(v0 - m_new) : 0.f;
          const float p1 = ok1 ? __expf(v1 - m_new) : 0.f;
          lsum[T] = lsum[T] * corr + (p0 + p1);
#pragma unroll
          for (int i = 0; i < C::KSTEPS; ++i) {
            acc[T][i][0] *= corr;
            acc[T][i][1] *= corr;
            acc[T][i][2] *= corr;
            acc[T][i][3] *= corr;
          }
          // P^T's B fragment: 2^15 p as (hi, lo) of head t at rows j, j + 8
          // is the 8 x 8 matrix [row][head, half]; its transpose is column
          // j's rows 2t, 2t + 1
          pb[T][0] = movtrans(hilo16(p0 * P_UP));
          pb[T][1] = movtrans(hilo16(p1 * P_UP));
        }
#pragma unroll
        for (int ch = 0; ch < C::KSTEPS; ch += 2) {
          // transposed, a b16 of int8 rows is two channels of two rows:
          // bytes (row 2t, 2j), (2t, 2j + 1), (2t + 1, 2j), (2t + 1, 2j + 1)
          uint32_t b[4];   // (rows 0-7, chunk ch), (rows 8-15, ch), then ch + 1
          ldsm4_t(sw<R>(stage, g0 + lr + (mi & 1) * 8, D + 16 * (ch + (mi >> 1))), b);
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const uint32_t w0 = b[2 * y] ^ 0x80808080u, w1 = b[2 * y + 1] ^ 0x80808080u;
            const uint32_t a0 = i8h2(w0, 0x4240), a1 = i8h2(w0, 0x4341);
            const uint32_t a2 = i8h2(w1, 0x4240), a3 = i8h2(w1, 0x4341);
#pragma unroll
            for (int T = 0; T < NT; ++T)
              mma16816h(acc[T][ch + y], a0, a1, a2, a3, pb[T][0], pb[T][1]);
          }
        }
      });
#pragma unroll
      for (int T = 0; T < NT; ++T) {
        float ls = lsum[T];
        ls += __shfl_xor_sync(0xffffffffu, ls, 4);
        ls += __shfl_xor_sync(0xffffffffu, ls, 8);
        ls += __shfl_xor_sync(0xffffffffu, ls, 16);
        if (4 * T + t < G) {
          float* o = part + (4 * T + t) * (D + 2);
#pragma unroll
          for (int i = 0; i < C::KSTEPS; ++i) {
            o[2 + 16 * i + 2 * gj] = (acc[T][i][0] + acc[T][i][1]) * (1.f / P_UP);
            o[3 + 16 * i + 2 * gj] = (acc[T][i][2] + acc[T][i][3]) * (1.f / P_UP);
          }
          if (gj == 0) {
            o[0] = m[T];
            o[1] = ls;
          }
        }
      }
    }
  }
  __syncthreads();

  // the CTA's partial, its warps merged in order, goes out by slices: the
  // outputs [p * sl, p * sl + sl) to CTA p of the cluster, and (m, l) to
  // every CTA (distributed shared memory: plain stores through the mapped
  // address). Then one cluster barrier.
  const int sl = (G * D + ncta - 1) / ncta;
  const float* wp = reinterpret_cast<const float*>(ring);
  cluster_wait();             // every CTA of the cluster has started
  for (int i = threadIdx.x; i < G * D; i += NTHREADS) {
    const int j = i / D, d = i % D;
    float mx = MASKED;
#pragma unroll
    for (int w = 0; w < NCW; ++w) mx = fmaxf(mx, wp[(w * G + j) * (D + 2)]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < NCW; ++w) {
      const float* o = wp + (w * G + j) * (D + 2);
      const float wt = __expf(o[0] - mx);
      a = fmaf(o[2 + d], wt, a);
      ls = fmaf(o[1], wt, ls);
    }
    const int p = i / sl;
    *cluster.map_shared_rank(&in_acc[rank * sl + i - p * sl], p) = a;
    if (d == 0)
      for (int p2 = 0; p2 < ncta; ++p2) {
        *cluster.map_shared_rank(&in_ml[rank][j], p2) = mx;
        *cluster.map_shared_rank(&in_ml[rank][G + j], p2) = ls;
      }
  }
  cluster_arrive();
  cluster_wait();

  // this CTA's slice of the head's result, from every CTA's partial in rank
  // order; no CTA touches a peer's shared memory after the barrier
  for (int i = rank * sl + threadIdx.x; i < min(G * D, rank * sl + sl);
       i += NTHREADS) {
    const int j = i / D, d = i % D;
    float mx = MASKED;
    for (int p = 0; p < ncta; ++p) mx = fmaxf(mx, in_ml[p][j]);
    float a = 0.f, ls = 0.f;
    for (int p = 0; p < ncta; ++p) {
      const float wt = __expf(in_ml[p][j] - mx);
      a = fmaf(in_acc[p * sl + i - rank * sl], wt, a);
      ls = fmaf(in_ml[p][G + j], wt, ls);
    }
    acc_out[(size_t)h * G * D + i] = a;
    if (d == 0) {
      m_out[h * G + j] = mx;
      l_out[h * G + j] = ls;
    }
  }
}

// the most clusters of `ctas` CTAs that fit on the card at once
template <typename K>
int active_clusters(K kernel, int ctas, int threads, size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = ctas;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// the per-head counts: a device vector read at h * stride (stride 0: one
// value for every head), or a scalar by value when the pointer is null
struct Counts {
  const int* n_cand_vec;
  int n_cand_stride, n_cand_scalar, win_max;
  const int* win_vec;
  int win_stride, win_scalar;
};

int last_ctas = 0;     // CTAs per kv head of the last launch

template <typename QT, typename KT, int D, int G>
cudaError_t launch(const void* q, const void* kv, int layer, int H_kv, int N,
                   const void* blk_idx, int idx64, int nb_sel, Counts cnt,
                   int bs, float* m, float* l, float* acc, cudaStream_t stream) {
  using C = Cfg<KT, D>;
  auto kernel = block_attn_kernel<QT, KT, D, G>;
  // once per process, so that a launch inside a CUDA-graph capture makes no
  // attribute call
  static const cudaError_t attr = allow_big_clusters(kernel);
  if (attr != cudaSuccess) return attr;
  // the layer's rows [0, (layer + 1) H_kv N) of the tail as one 2-D tensor
  // of rows of 2D elements, read in boxes of BIG or SMALL rows
  const long long rows = ((long long)layer + 1) * H_kv * N;
  if (rows >= (1ll << 31)) return cudaErrorInvalidValue;
  const CUtensorMapDataType type = sizeof(KT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                   : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap tm_big, tm_small;
  cudaError_t e = make_tmap_2d(&tm_big, kv, type, sizeof(KT), rows, 2 * D, BIG);
  if (e == cudaSuccess) e = make_tmap_2d(&tm_small, kv, type, sizeof(KT), rows, 2 * D, SMALL);
  if (e != cudaSuccess) return e;
  // CTAs per kv head: the largest power of two up to MAX_CTAS, the SMs per
  // head and the selection's stages whose clusters, one per head, all fit
  // on the card at once (a cluster that waits for room doubles the time),
  // else 1
  const long long total = (long long)nb_sel * bs + cnt.win_max;
  const long long by_rows = (total + C::R - 1) / C::R;
  const int by_sms = max(1, sm_count() / H_kv);
  static int fits[MAX_CTAS + 1] = {};   // per size: clusters that fit, + 1
  int ctas = 0;
  for (int c = MAX_CTAS; c >= 1 && !ctas; c /= 2) {
    if (c > by_sms || c > by_rows) continue;
    if (!fits[c]) fits[c] = 1 + active_clusters(kernel, c, NTHREADS, 1024 + RING_BYTES);
    if (fits[c] - 1 >= H_kv || c == 1) ctas = c;
  }
  last_ctas = ctas;
  const long long share = (total + ctas - 1) / ctas;
  const size_t smem = 1024 + RING_BYTES + (share / bs + 2) * sizeof(int4);
  if (smem > (size_t)optin_smem() - 16 * 1024) return cudaErrorInvalidValue;
  return launch_cluster(kernel, dim3(ctas, H_kv), NTHREADS, smem, stream, tm_big,
                        tm_small, static_cast<const QT*>(q), layer, H_kv, N,
                        blk_idx, idx64, nb_sel, cnt.n_cand_vec, cnt.n_cand_stride,
                        cnt.n_cand_scalar, cnt.win_max, cnt.win_vec, cnt.win_stride,
                        cnt.win_scalar, bs, 1.0f / sqrtf((float)D), m, l, acc);
}

template <typename QT, typename KT, int D>
cudaError_t by_group(int g, const void* q, const void* kv, int layer,
                     int H_kv, int N, const void* blk_idx, int idx64,
                     int nb_sel, Counts c, int bs, float* m, float* l,
                     float* acc, cudaStream_t s) {
#define PQ_ARGS q, kv, layer, H_kv, N, blk_idx, idx64, nb_sel, c, bs, m, l, acc, s
  switch (g) {
    case 1: return launch<QT, KT, D, 1>(PQ_ARGS);
    case 2: return launch<QT, KT, D, 2>(PQ_ARGS);
    case 4: return launch<QT, KT, D, 4>(PQ_ARGS);
    case 8: return launch<QT, KT, D, 8>(PQ_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PQ_ARGS
}

template <typename QT, typename KT>
cudaError_t by_dim(int D, int g, const void* q, const void* kv, int layer,
                   int H_kv, int N, const void* blk_idx, int idx64,
                   int nb_sel, Counts c, int bs, float* m, float* l,
                   float* acc, cudaStream_t s) {
#define PQ_ARGS g, q, kv, layer, H_kv, N, blk_idx, idx64, nb_sel, c, bs, m, l, acc, s
  if (D == 64) return by_group<QT, KT, 64>(PQ_ARGS);
  if (D == 128) return by_group<QT, KT, 128>(PQ_ARGS);
  return cudaErrorInvalidValue;
#undef PQ_ARGS
}

}  // namespace

// kv_dtype: 1 = bf16 (q bf16), 2 = int8 (q f32); g in {1, 2, 4, 8}; D in
// {64, 128}. blk_idx int64 when idx64, else int32. n_cand_vec may be null
// (then n_cand_scalar applies to every head), else head h reads
// n_cand_vec[h * n_cand_stride]; win_vec / win_stride / win_scalar the same
// for win_len when win_max > 0. kv 16-byte aligned; all buffers contiguous.
// One launch; writes m, l [H_kv, g] and acc [H_kv, g, D] and nothing else.
// Returns a cudaError_t (0 = launched).
extern "C" int pq_block_attn(const void* q, const void* kv, int kv_dtype,
                             int H_kv, int N, int D, int g, int layer,
                             const void* blk_idx, int idx64, int nb_sel,
                             const int* n_cand_vec, int n_cand_stride,
                             int n_cand_scalar, int win_max, const int* win_vec,
                             int win_stride, int win_scalar, int bs, float* m,
                             float* l, float* acc, void* stream) {
  if (nb_sel < 1 || bs < 1 || H_kv < 1 || N < bs || win_max < 0 ||
      (long long)nb_sel * bs + win_max > (1ll << 30) ||
      reinterpret_cast<uintptr_t>(kv) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Counts c = {n_cand_vec, n_cand_stride, n_cand_scalar, win_max,
                    win_vec, win_stride, win_scalar};
#define PQ_ARGS D, g, q, kv, layer, H_kv, N, blk_idx, idx64, nb_sel, c, bs, m, l, acc, s
  if (kv_dtype == 1) return by_dim<__nv_bfloat16, __nv_bfloat16>(PQ_ARGS);
  if (kv_dtype == 2) return by_dim<float, int8_t>(PQ_ARGS);
  return cudaErrorInvalidValue;
#undef PQ_ARGS
}

// CTAs per kv head that the last pq_block_attn launch chose
extern "C" int pq_block_attn_ctas() { return last_ctas; }

// ---------------------------------------------------------------------------
// K1's latent variant (latent_attn_kernel, latent_merge_kernel), for a latent
// (MLA) tail: one kv head whose rows are the keys, [c (512) | k_pe (64)] in
// bf16, and whose first DV columns are the values, for G = 16 query heads.
// The same function as pq_block_attn of bf16 rows with q and k 576 wide and
// v the rows' first 512 columns: the online-softmax partials (m, l, acc) of
// the 16 heads over the selected blocks' rows below n_cand and, with
// win_max > 0, the window's rows [n_cand, n_cand + win_len), logits x
// 1/sqrt(D); a head with no row gives (-1e30, 0, 0).
//
// What bounds it: the rows' bytes. Each row is read once from HBM and used
// for the 16 heads' logits and values, about 2 x 16 x (576 + 512) / 1152 =
// 30 FLOP a byte: below the card's ridge. At the 128k MLA cell (40 slots,
// about 26.2k rows a slot) one layer-step reads 1.2 GB: 0.36 ms at 3.35 TB/s.
//
// Design: grid (splits, H_kv), 8 warps a CTA, two CTAs an SM (96 KB of
// shared memory each: the two interleave, one's softmax and barriers under
// the other's products and copies). CTA s of a head takes whole 32-row
// tiles of the head's selection rows (selected blocks then window, as
// pq_block_attn orders them), tiles [s T / splits, (s + 1) T / splits).
// A tile is copied by cp.async into one of two shared-memory buffers while
// the other is used, each row at a pitch of 1168 bytes so that ldmatrix's
// 8 rows fall on distinct banks; a row not to use is zero-filled (src-size
// 0) and masked. Three barriers a tile.
//   * S = Q K^T by mma.sync m16n8k16 with the 16 heads on M (Q from shared
//     memory by ldmatrix) and the tile's rows on N: warp w takes rows
//     [8 (w % 4), + 8) over half w / 4 of the 36 k-steps, in four
//     independent accumulators, and the two halves add in shared memory;
//     bf16 q times bf16 k is exact, f32 sums.
//   * Online softmax in f32 through shared memory: warp w keeps the running
//     (m, l) of heads 2w, 2w + 1, writes P and each head's rescale factor.
//   * O += P V with the heads on M and the values on N: warp w owns value
//     columns [64w, 64w + 64) (8 n8 tiles, 32 f32 a lane); P enters as
//     bf16 hi + lo pairs (good to 2^-17, as pq_block_attn's), V^T's
//     fragments by ldmatrix.trans from the same tile.
// On an H100 (700 W) at the MLA cell's layer (40 slots, 1.21 GB): 0.494 ms,
// 73.5% of the bytes' time, where one CTA an SM on 64-row tiles with four
// barriers and one S accumulator took 0.560 ms (64.8%).
// Each CTA writes its partial (acc [16][512], m [16], l [16]) to `part`;
// latent_merge_kernel then merges a head's splits in split order, so the
// same inputs give bitwise the same output.

namespace {
namespace latent {

constexpr int G = 16;             // query heads: the MMA's M
constexpr int T = 32;             // rows a tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

template <int D, int DV>
struct LCfg {
  static constexpr int ROW = D * 2;           // bytes of a row
  static constexpr int PITCH = ROW + 16;      // its pitch in shared memory
  static constexpr int CHUNKS = ROW / 16;     // 16-byte pieces of a row
  static constexpr int TILE_BYTES = T * PITCH;
  static constexpr int Q_BYTES = G * PITCH;
  static constexpr int SP = T + 4;            // f32 pitch of the S / P tile
  static constexpr int SMEM = 2 * TILE_BYTES + Q_BYTES + (2 * G * SP + G + 4 * T) * 4;
  static constexpr int KSTEPS = D / 16;
  static constexpr int VCOLS = DV / WARPS;    // value columns a warp
  static constexpr int NT = VCOLS / 8;        // its n8 tiles
  // a lane holds one row of a head in the softmax; two k halves of whole
  // pairs of k-steps; two heads a warp
  static_assert(T == 32 && KSTEPS % 4 == 0 && NT % 2 == 0 && G == 2 * WARPS,
                "shape");
};

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// part [H_kv, splits, G * DV + 2 G]: acc [G][DV], then m [G], then l [G]
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 2)
latent_attn_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ kv,
                   int layer, int H_kv, int N, const void* __restrict__ blk_idx,
                   int idx64, int nb_sel, const int* __restrict__ n_cand_vec,
                   int n_cand_stride, int n_cand_scalar, int win_max,
                   const int* __restrict__ win_vec, int win_stride, int win_scalar,
                   int bs, float scale, float* __restrict__ part) {
  using C = LCfg<D, DV>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* qs = smem + 2 * C::TILE_BYTES;
  float* sp = reinterpret_cast<float*>(qs + C::Q_BYTES);   // [2][G][SP]
  float* alpha = sp + 2 * G * C::SP;                       // [G]
  int* ok = reinterpret_cast<int*>(alpha + G);             // [2][T]
  int* rowtab = ok + 2 * T;                                // [2][T]

  const int h = blockIdx.y, part_i = blockIdx.x, splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, t4 = lane & 3;

  // (selection rows of a head fit an int: the entry point checks)
  const int n_c = n_cand_vec ? n_cand_vec[h * n_cand_stride] : n_cand_scalar;
  int win = 0;
  if (win_max) {
    win = win_vec ? win_vec[h * win_stride] : win_scalar;
    win = max(0, min(win, min(win_max, N - n_c)));
  }
  const int sel_rows = nb_sel * bs;
  const int total = sel_rows + win_max;
  const int tiles = (total + T - 1) / T;
  const int t0 = (int)((long long)tiles * part_i / splits);
  const int t1 = (int)((long long)tiles * (part_i + 1) / splits);
  const int j0 = t0 * T, j1 = min(t1 * T, total);
  const int ntiles = t1 - t0;
  const uint16_t* base = kv + ((size_t)layer * H_kv + h) * (size_t)N * D;

  // rowtab[buf][r]: the tail row of selection row j0 + it T + r of tile it,
  // or -1: a selected block's row below n_cand (an id out of range: none),
  // or a window row. Threads [0, T) fill a tile's table a tile ahead of its
  // copies, so the copies read it after a barrier.
  auto fill_rows = [&](int it, int buf) {
    if (tid >= T || it >= ntiles) return;
    const int j = j0 + it * T + tid;
    int row = -1;
    if (j < j1 && j < sel_rows) {
      const int kb = j / bs;
      const size_t i = (size_t)h * nb_sel + kb;
      const long long blk = idx64 ? static_cast<const long long*>(blk_idx)[i]
                                  : static_cast<const int*>(blk_idx)[i];
      if (blk >= 0 && (blk + 1) * bs <= N) {
        const long long r = blk * bs + (j - kb * bs);
        row = r < n_c ? (int)r : -1;
      }
    } else if (j < j1 && j - sel_rows < win) {
      row = n_c + (j - sel_rows);
    }
    rowtab[buf * T + tid] = row;
  };
  auto load = [&](int buf) {
    const uint32_t dst = smem_u32(smem + buf * C::TILE_BYTES);
    const int* rows = rowtab + buf * T;
    for (int c = tid; c < T * C::CHUNKS; c += THREADS) {
      const int r = c / C::CHUNKS, k = c - r * C::CHUNKS;
      const int row = rows[r];
      cp16(dst + r * C::PITCH + k * 16, row >= 0 ? base + (size_t)row * D + k * 8 : base,
           row >= 0 ? 16 : 0);
      if (k == 0) ok[buf * T + r] = row >= 0;
    }
    cp_commit();
  };

  // the head's queries, then the first tile
  const uint16_t* qh = q + (size_t)h * G * D;
  for (int c = tid; c < G * C::CHUNKS; c += THREADS) {
    const int r = c / C::CHUNKS, k = c - r * C::CHUNKS;
    cp16(smem_u32(qs + r * C::PITCH + k * 16), qh + r * D + k * 8, 16);
  }
  cp_commit();
  fill_rows(0, 0);
  __syncthreads();
  if (ntiles > 0) load(0);
  fill_rows(1, 1);   // read after the first tile's barrier

  float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.f, 0.f};
  float acc[C::NT][4];
#pragma unroll
  for (int i = 0; i < C::NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const uint32_t qb = smem_u32(qs);

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    // the tile has landed and every warp is done with the last one: its
    // buffer, its table and S / P may be rewritten
    cp_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) load(buf ^ 1);
    fill_rows(it + 2, buf);
    const uint32_t tb = smem_u32(smem + buf * C::TILE_BYTES);
    // S of rows [8 warp, 8 warp + 8): c[0..1] head grp, c[2..3] head grp + 8,
    // rows 8 warp + 2 t4 (+ 1)
    const int rw = warp & 3, kh = warp >> 2;   // rows [8 rw, +8), k half kh
    float sa[4][4] = {};
#pragma unroll
    for (int k2 = 0; k2 < C::KSTEPS / 2; k2 += 2) {
      const int kk = kh * (C::KSTEPS / 2) + k2;
      uint32_t a0[4], a1[4], b[4];
      ldsm4(qb + (lane & 15) * C::PITCH + (kk * 16 + (lane >> 4) * 8) * 2, a0);
      ldsm4(qb + (lane & 15) * C::PITCH + ((kk + 1) * 16 + (lane >> 4) * 8) * 2, a1);
      ldsm4(tb + (8 * rw + (lane & 7)) * C::PITCH + (kk * 16 + (lane >> 3) * 8) * 2, b);
      mma16816(sa[(k2 >> 1) & 3], a0[0], a0[1], a0[2], a0[3], b[0], b[1]);
      mma16816(sa[(k2 >> 1) & 3], a1[0], a1[1], a1[2], a1[3], b[2], b[3]);
    }
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = (sa[0][e] + sa[1][e]) + (sa[2][e] + sa[3][e]);
    {
      // half 0 masks a row (MASKED), half 1 adds 0 to it
      const int n0 = 8 * rw + 2 * t4;
      const int* okb = ok + buf * T;
      const bool u0 = okb[n0], u1 = okb[n0 + 1];
      const float x0 = kh ? 0.f : MASKED;
      float* sh = sp + kh * G * C::SP;
      *reinterpret_cast<float2*>(sh + grp * C::SP + n0) =
          make_float2(u0 ? s[0] * scale : x0, u1 ? s[1] * scale : x0);
      *reinterpret_cast<float2*>(sh + (grp + 8) * C::SP + n0) =
          make_float2(u0 ? s[2] * scale : x0, u1 ? s[3] * scale : x0);
    }
    __syncthreads();
    // the softmax of heads 2 warp, 2 warp + 1 over the tile's 64 rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hh = 2 * warp + i;
      float* row = sp + hh * C::SP;
      const float x0 = row[lane] + row[G * C::SP + lane];
      float mx = x0;
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      const float p0 = x0 > MASKED ? expf(x0 - m_new) : 0.f;
      float sum = p0;
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float a = m_run[i] > MASKED ? expf(m_run[i] - m_new) : 1.f;
      l_run[i] = l_run[i] * a + sum;
      m_run[i] = m_new;
      row[lane] = p0;
      if (lane == 0) alpha[hh] = a;
    }
    __syncthreads();
    // O of value columns [64 warp, 64 warp + 64): rescale, then P V
    {
      const float a_lo = alpha[grp], a_hi = alpha[grp + 8];
#pragma unroll
      for (int i = 0; i < C::NT; ++i) {
        acc[i][0] *= a_lo;
        acc[i][1] *= a_lo;
        acc[i][2] *= a_hi;
        acc[i][3] *= a_hi;
      }
#pragma unroll
      for (int ks = 0; ks < T / 16; ++ks) {
        const float* p0 = sp + grp * C::SP + 16 * ks + 2 * t4;
        const float* p1 = sp + (grp + 8) * C::SP + 16 * ks + 2 * t4;
        uint32_t ah[4], al[4];
        split(p0[0], p0[1], ah[0], al[0]);
        split(p1[0], p1[1], ah[1], al[1]);
        split(p0[8], p0[9], ah[2], al[2]);
        split(p1[8], p1[9], ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < C::NT / 2; ++np) {
          uint32_t b[4];
          ldsm4_t(tb + (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * C::PITCH +
                      (C::VCOLS * warp + 16 * np + 8 * (lane >> 4)) * 2,
                  b);
          mma16816(acc[2 * np], ah[0], ah[1], ah[2], ah[3], b[0], b[1]);
          mma16816(acc[2 * np], al[0], al[1], al[2], al[3], b[0], b[1]);
          mma16816(acc[2 * np + 1], ah[0], ah[1], ah[2], ah[3], b[2], b[3]);
          mma16816(acc[2 * np + 1], al[0], al[1], al[2], al[3], b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

  float* ph = part + ((size_t)h * splits + part_i) * (G * DV + 2 * G);
#pragma unroll
  for (int i = 0; i < C::NT; ++i) {
    const int col = C::VCOLS * warp + 8 * i + 2 * t4;
    *reinterpret_cast<float2*>(ph + grp * DV + col) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(ph + (grp + 8) * DV + col) = make_float2(acc[i][2], acc[i][3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ph[G * DV + 2 * warp + i] = m_run[i];
      ph[G * DV + G + 2 * warp + i] = l_run[i];
    }
  }
}

// grid (H_kv, G), DV threads: head (h, hh)'s splits merged in split order
template <int DV>
__global__ void __launch_bounds__(DV)
latent_merge_kernel(const float* __restrict__ part, int splits, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ acc_out) {
  const int h = blockIdx.x, hh = blockIdx.y, c = threadIdx.x;
  const size_t stride = (size_t)G * DV + 2 * G;
  const float* p = part + (size_t)h * splits * stride;
  float M = MASKED;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, p[s * stride + G * DV + hh]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ms = p[s * stride + G * DV + hh];
    const float w = ms > MASKED ? expf(ms - M) : 0.f;
    L += w * p[s * stride + G * DV + G + hh];
    A += w * p[s * stride + hh * DV + c];
  }
  acc_out[((size_t)h * G + hh) * DV + c] = A;
  if (c == 0) {
    m_out[h * G + hh] = M;
    l_out[h * G + hh] = L;
  }
}

}  // namespace latent
}  // namespace

// The latent variant: q [H_kv, 16, 576] bf16, kv [L, H_kv, N, 576] bf16 (the
// values its rows' first 512 columns), blk_idx, the counts and win_max as
// pq_block_attn's; D 576, v_dim 512, g 16. `part` holds splits x H_kv x
// (16 x 512 + 32) f32 of scratch. Two launches, the splits and their merge;
// writes m, l [H_kv, 16], acc [H_kv, 16, 512] (and part). Returns a
// cudaError_t (0 = launched).
extern "C" int pq_latent_attn(const void* q, const void* kv, int H_kv, int N, int D,
                              int v_dim, int g, int layer, const void* blk_idx, int idx64,
                              int nb_sel, const int* n_cand_vec, int n_cand_stride,
                              int n_cand_scalar, int win_max, const int* win_vec,
                              int win_stride, int win_scalar, int bs, int splits,
                              float* part, float* m, float* l, float* acc, void* stream) {
  using namespace latent;
  constexpr int LD = 576, LDV = 512;
  using C = LCfg<LD, LDV>;
  if (D != LD || v_dim != LDV || g != G || nb_sel < 1 || bs < 1 || H_kv < 1 ||
      H_kv > 65535 || N < bs || N % bs || win_max < 0 || splits < 1 || splits > 64 ||
      (long long)N >= (1ll << 31) ||
      (long long)nb_sel * bs + win_max > (1ll << 30) ||
      reinterpret_cast<uintptr_t>(kv) % 16 || reinterpret_cast<uintptr_t>(q) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = latent_attn_kernel<LD, LDV>;
  // once per process, so that a launch inside a CUDA-graph capture makes no
  // attribute call
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(splits, H_kv), THREADS, C::SMEM, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(kv), layer, H_kv, N,
      blk_idx, idx64, nb_sel, n_cand_vec, n_cand_stride, n_cand_scalar, win_max, win_vec,
      win_stride, win_scalar, bs, 1.0f / sqrtf((float)LD), part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  latent_merge_kernel<LDV><<<dim3(H_kv, G), LDV, 0, s>>>(part, splits, m, l, acc);
  return cudaGetLastError();
}
