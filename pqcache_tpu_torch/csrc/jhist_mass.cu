// The joint-histogram block scorer, hand-written for Hopper (sm_90a).
//
// It replaces no Pallas kernel. The JAX package computes this mass with an
// XLA einsum (pqcache_tpu/core/pq.py::joint_block_mass), where the TPU fuses
// the uint8 -> f32 convert into the dot; the port's plain version
// (ops/jhist.py::jhist_block_mass_ref) copies the histogram to f32 and runs
// an f32 GEMM. For one layer:
//   e      [Hf * g, 2, C] f32    exp-LUT factors in [0, 1]
//                                (core/pq.py::jhist_exp_lut)
//   J      [Hf, NB, C * C] uint8 joint code histogram, read in place
//   pending (optional): pos [Hf, K] int64 tail positions and codes
//          [Hf, 2, K] int64 of the joins the histogram does not count yet,
//          ring_r int32 on the device: the first ring_r of the K are live
//   -> mass [Hf * g, NB] f32, raw (not normalised):
//   mass[h, n] = sum_c0 e0[h, c0] * sum_c1 e1[h, c1] * J[kv(h), n, c0 C + c1]
//              + sum_{t < ring_r, clamp(pos_t / block, 0, NB - 1) == n}
//                    e0[h, code0_t] * e1[h, code1_t]
// The pair table e0 x e1 is never built: per folded kv head and row n,
//   T[c0, h] = sum_c1 J_n[c0, c1] e1[h, c1]      on the tensor cores,
//   mass[h, n] = sum_c0 e0[h, c0] T[c0, h]       64 FFMAs a head at C 64.
// The pending terms are summed in order t = 0 .. K - 1 and then added to
// the histogram's sum, as the plain version adds its one-hot product; every
// sum runs in a fixed order, so two calls agree bit for bit.
//
// What bounds it: the histogram's bytes. At the 128k decode cell (192
// folded kv heads x 514 blocks x 4096 bytes) one layer streams 404 MB:
// 0.121 ms at 3.35 TB/s. The version before this one contracted on the CUDA
// cores, g FFMAs, a byte permute and load bookkeeping for every byte (about
// 7 instructions a byte at g 4): it could not issue them fast enough to
// overlap the stream and read 54-60% of the bytes (34% at g 8). On the
// tensor cores a byte costs half a byte permute and 3 / 256 of an MMA
// (mma.sync m16n8k16, 48 a 4 KB row), about 1.2 instructions a byte in all,
// and the kernel streams: on an H100 SXM at 700 W, 0.144-0.147 ms for that
// layer, cold (82-86% of the bytes), 77-79% at the 32k cell's 127 rows a
// head, whose short CTAs spend more of their time starting.
//
// The product T = J_n e1 as m16n8k16 MMAs: M = c0 (C / 16 tiles), K = c1
// (C / 16 tiles), N = 8 heads (the g of the group, the rest zero).
// - Operand layout. The K index may be permuted at will if B's rows follow
//   it: lane (grp = lane / 4, t = lane % 4) takes the c1 of its A fragments
//   as V consecutive bytes, c1 in [64 j + t V, 64 j + t V + V), V =
//   min(16, C / 4); the 4 bytes of its k-tile's word w are its fragment's
//   k slots 2t, 2t + 1 (bytes 0, 1) and 2t + 8, 2t + 9 (bytes 2, 3). Its
//   rows are c0 = grp and grp + 8 of each m tile. So a warp's load of a row
//   covers 8 c0 rows of 4 V bytes each, contiguous at C <= 64: one 16-byte
//   copy a lane, 512 bytes a warp, at the 128k cell.
// - The counts, exactly. A byte b zero-extended to 16 bits is the bf16
//   b 2^-133 for every b in 0..255 (a subnormal below 128, a normal at 128
//   and above; the tensor cores keep both): one byte permute makes two
//   A elements, no conversion.
// - The factors at f32 precision. e1 2^126 is cut into three bf16 pieces,
//   hi + mid + lo, each the next 8 bits of the significand, truncated:
//   each residual is exact, and 3 x 8 bits hold f32's 24
//   (ops/jhist.py::split_factors is the plain twin). The pieces keep f32's
//   exponent range, and every nonzero piece is a normal bf16 (e1 2^126 >=
//   2^-23). A count times a piece has at most 16 significant bits: exact
//   in the MMA, whose sums are f32. Each k tile takes three MMAs, one a
//   piece (lo, mid, hi), into one accumulator.
// - Scale. Each product is (b e1 2^126) 2^-133 = b e1 2^-7, so T is 2^-7
//   of the true sum: normal while e1 >= 2^-119, and e0 is held as e0 2^7 to
//   give mass unscaled.
// - Rows past C (C < 16) meet zero e0 and columns past C zero B, so
//   whatever their slots hold (finite: a byte read as a bf16 is finite)
//   adds nothing: one body for every C in 2..256.
//
// Design:
// - A CTA of NWARPS warps takes one folded kv head and a tile of rows, rpw
//   contiguous rows a warp (a head's last warps may have fewer). The CTA
//   stages the head's factors in shared memory: B's fragments
//   [k tile][piece][lane], e0 2^7 as [c0][8] (a float2 gives the lane's two
//   heads of a c0) and e1 [8][C] for the pending terms.
// - A warp walks its rows in units of at most UNIT loads a lane: at C <= 64
//   one row, above it MG m tiles of a row, every k tile. Loads are cp.async
//   copies into a per-lane ring of DEPTH slots in shared memory, AHEAD
//   loads ahead: a lane reads back only what it copied, so it needs no
//   barrier, and the bytes in flight cost no registers. The first copies
//   fly while the CTA stages the factors; the pending joins' positions and
//   codes are loaded with the factors and read after the rows.
// - A unit's MG m tiles are independent accumulator chains. At a unit's end
//   each lane dots its rows of T with e0 (4 FFMAs an m tile); at a row's
//   end the 8 lanes of a head pair sum across the warp (shuffles, a fixed
//   tree) and the row's sums go to shared memory. The CTA then adds the
//   pending terms of its rows (only a CTA whose rows hold a pending join
//   loops over them) and writes its outputs, coalesced along the rows.
// - The grid is sized from the SM count and the bytes: rows per warp so that
//   the grid makes about WAVES waves of CTAS_PER_SM CTAs an SM, evened out
//   over a head's tiles. Small CTAs, many to an SM (4 warps, 5 CTAs), keep
//   more warps streaming than 8-warp CTAs whose rings and registers allow 2.
// Every row is read, the zero rows past a slot's candidates too.
// C = 2 (2-byte runs) is too narrow for cp.async: V 2 loads synchronously.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int THREADS = 32 * NWARPS;
constexpr int UNIT = 8;              // most loads of a lane a unit sums
constexpr int AHEAD = 8;             // copies in flight ahead of the unit
constexpr int DEPTH = UNIT + AHEAD;  // ring slots a lane, 16 bytes each
constexpr int SLOT = 16;
constexpr int HEADS = 8;             // the MMA's N: an n tile of a group's heads
constexpr int PIECES = 3;            // bf16 pieces of an f32 factor
constexpr int CTAS_PER_SM = 5;      // 20 warps an SM, at most 102 registers
constexpr int WAVES = 8;             // waves of CTAs the grid aims at
constexpr int MAX_RPW = 16;          // rows per warp
constexpr int MAX_K = 1024;          // pending joins
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr float E1_SCALE = 0x1p126f; // B = e1 2^126; a count is b 2^-133
constexpr float E0_SCALE = 0x1p7f;   // so T is 2^-7 of the true sum

// The walk over one row of C x C counts
template <int C>
struct Walk {
  static constexpr int V = C >= 64 ? 16 : C >= 16 ? C / 4 : (C < 4 ? C : 4);
  static constexpr int J = C > 64 ? C / 64 : 1;   // copies of a c0 row
  static constexpr int MT = C > 16 ? C / 16 : 1;  // m tiles (c0), k tiles (c1)
  static constexpr int WPL = V >= 4 ? V / 4 : 1;  // 32-bit words a copy
  static constexpr int NL = 2 * MT * J;           // copies of a row, a lane
  static constexpr int UL = NL < UNIT ? NL : UNIT;
  static constexpr int MG = UL / (2 * J);         // m tiles of a unit
  static constexpr int UPR = NL / UL;             // units of a row
};

template <int V> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<2> { using T = uint16_t; };

// V bytes from global to shared memory: cp.async for V >= 4, else a plain
// load and store
template <int V>
__device__ __forceinline__ void copy_in(void* dst, const uint8_t* src) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
                 "l"(src) : "memory");
  } else if constexpr (V >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(V) : "memory");
  } else {
    *static_cast<typename Vec<V>::T*>(dst) =
        *reinterpret_cast<const typename Vec<V>::T*>(src);
  }
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest AHEAD has landed
template <int V>
__device__ __forceinline__ void wait_ahead() {
  if constexpr (V >= 4) asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD) : "memory");
}

// the V bytes of a slot as 32-bit words (V 2: one half word)
template <int V>
__device__ __forceinline__ void read_slot(const void* slot, uint32_t (&w)[V >= 4 ? V / 4 : 1]) {
  const typename Vec<V>::T v = *static_cast<const typename Vec<V>::T*>(slot);
  if constexpr (V == 16) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (V == 8) {
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = v;
  }
}

// x = sum of the three bf16 bit patterns p, exactly: each piece is the
// residual cut to its top 16 bits (sign, exponent, 7 bits), so each
// subtraction is exact and the third residual has at most 8 bits
__device__ __forceinline__ void split_factor(float x, uint32_t (&p)[PIECES]) {
#pragma unroll
  for (int q = 0; q < PIECES; ++q) {
    const uint32_t top = __float_as_uint(x) & 0xffff0000u;
    p[q] = top >> 16;
    x -= __uint_as_float(top);
  }
}

// Shared memory: the lanes' rings, B [k tile][n tile][piece][lane] (uint2),
// e0 [16 MT][NH], e1 [NH][C], the rows' sums [NH][tile], the pending joins'
// local rows and codes [K] each. NH, the group's heads padded, is 8 (one n
// tile) or 16 (two: MLA's 16 heads of one latent kv head, the counts still
// read once; 3 CTAs an SM for the doubled accumulators).
constexpr int RING_BYTES = NWARPS * DEPTH * 32 * SLOT;

template <int C, int NH = HEADS>
__global__ void __launch_bounds__(THREADS, NH == HEADS ? CTAS_PER_SM : 3)
jhist_mass_kernel(const float* __restrict__ e, const uint8_t* __restrict__ J, int g,
                  int NB, int rpw, const int64_t* __restrict__ pos,
                  const int64_t* __restrict__ codes, const int* __restrict__ ring_r, int K,
                  int block, float* __restrict__ out) {
  using W = Walk<C>;
  constexpr int R = C * C, KT = W::MT, CP = 16 * W::MT, NTN = NH / HEADS;
  extern __shared__ __align__(16) unsigned char smem[];
  // tile b of a head: rows [b tile, (b + 1) tile), rpw a warp
  const int tile = NWARPS * rpw;
  const int hk = blockIdx.y;
  const int tile0 = blockIdx.x * tile;
  const int nrows = min(tile, NB - tile0);
  uint2* bs = reinterpret_cast<uint2*>(smem + RING_BYTES);
  float* e0s = reinterpret_cast<float*>(bs + KT * NTN * PIECES * 32);
  float* e1s = e0s + CP * NH;
  float* res = e1s + NH * C;
  int* pcol = reinterpret_cast<int*>(res + NH * tile);
  int* pcode = pcol + K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, t = lane & 3;

  // This warp's rows are contiguous. Copy k of a lane is copy l of unit u
  // of its row: m tile pair i / 2 of the unit, c0 = 8 i + grp, chunk j of
  // the c0 row, V bytes at c1 = 64 j + t V. Its first copies fly while the
  // CTA stages the factors.
  const int r0 = warp * rpw;
  const int rows_w = max(0, min(rpw, nrows - r0));
  const int n_copy = rows_w * W::NL;
  const uint8_t* src = J + ((size_t)hk * NB + tile0 + r0) * R;
  unsigned char* ring = smem + ((size_t)warp * DEPTH * 32 + lane) * SLOT;
  auto issue = [&](int k) {
    if (k < n_copy) {
      const int row = k / W::NL, kr = k % W::NL;
      const int u = kr / W::UL, l = kr % W::UL;
      const int c0 = 8 * (2 * u * W::MG + l / W::J) + grp;
      const int c1 = 64 * (l % W::J) + t * W::V;
      if (c0 < C && c1 < C)
        copy_in<W::V>(ring + (k % DEPTH) * 32 * SLOT, src + (size_t)row * R + c0 * C + c1);
    }
    if constexpr (W::V >= 4) commit();
  };
#pragma unroll 1
  for (int k = 0; k < AHEAD; ++k) issue(k);

  // the pending joins' ring count, positions and codes (their low words)
  // are loaded with the factors, in one round trip, and read after the rows
  const int* pos32 = reinterpret_cast<const int*>(pos);
  const int* codes32 = reinterpret_cast<const int*>(codes);
  int rr = 0, p_pos = 0, p_a = 0, p_b = 0;
  if (K > 0) {
    rr = *ring_r;
    if (tid < K) {
      p_pos = pos32[2 * ((size_t)hk * K + tid)];
      p_a = codes32[2 * ((size_t)hk * 2 * K + tid)];
      p_b = codes32[2 * (((size_t)hk * 2 + 1) * K + tid)];
    }
  }
  // e0 2^7 [CP][NH] and e1 [NH][C], zero past g and past C
  const float* eh = e + (size_t)hk * g * 2 * C;
  for (int i = tid; i < CP * NH; i += THREADS) {
    const int c = i / NH, h = i % NH;
    e0s[i] = h < g && c < C ? eh[h * 2 * C + c] * E0_SCALE : 0.f;
  }
  for (int i = tid; i < NH * C; i += THREADS) {
    const int h = i / C, c = i % C;
    e1s[i] = h < g ? eh[h * 2 * C + C + c] : 0.f;
  }
  __syncthreads();
  // B's fragments: lane ln's k slots 2 tl + 8 r + {0, 1} of k tile kt are
  // bytes 2 r + {0, 1} of its word kt % WPL of chunk kt / WPL, i.e. c1 =
  // 64 j + tl V + 4 w + 2 r + {0, 1}, for head 8 nt + ln / 4 of n tile nt
  for (int i = tid; i < KT * NTN * 32 * 2; i += THREADS) {
    const int r = i & 1, ln = (i >> 1) & 31, ktn = i >> 6;
    const int kt = ktn / NTN, nt = ktn % NTN;
    const int h = HEADS * nt + (ln >> 2), tl = ln & 3, w = kt % W::WPL;
    uint32_t word[PIECES] = {0u, 0u, 0u};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = 4 * w + 2 * r + half;
      const int c1 = 64 * (kt / W::WPL) + tl * W::V + b;
      uint32_t p[PIECES];
      split_factor(b < W::V && c1 < C ? e1s[h * C + c1] * E1_SCALE : 0.f, p);
#pragma unroll
      for (int q = 0; q < PIECES; ++q) word[q] |= p[q] << (16 * half);
    }
#pragma unroll
    for (int q = 0; q < PIECES; ++q)
      reinterpret_cast<uint32_t*>(bs + (ktn * PIECES + q) * 32 + ln)[r] = word[q];
  }
  __syncthreads();

  // Units of UL copies: issue the unit's share of copies AHEAD ahead, wait
  // for its own, and multiply. A byte zero-extended to 16 bits is the bf16
  // b 2^-133: a0 / a2 are bytes 0-1 / 2-3 of the c0 = grp word, a1 / a3 of
  // the grp + 8 word.
  const float2* e0p = reinterpret_cast<const float2*>(e0s);
  float s0[NTN], s1[NTN];                // heads 8 nt + 2t, + 1 of the row
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) s0[nt] = s1[nt] = 0.f;
  const int n_unit = rows_w * W::UPR;
#pragma unroll 1
  for (int u = 0; u < n_unit; ++u) {
#pragma unroll
    for (int l = 0; l < W::UL; ++l) issue(u * W::UL + AHEAD + l);
    wait_ahead<W::V>();
    uint32_t wd[W::UL][W::WPL];
#pragma unroll
    for (int l = 0; l < W::UL; ++l)
      read_slot<W::V>(ring + ((u * W::UL + l) % DEPTH) * 32 * SLOT, wd[l]);
    float acc[W::MG][NTN][4];
#pragma unroll
    for (int m = 0; m < W::MG; ++m)
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
        acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint2 b[NTN][PIECES];
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int q = 0; q < PIECES; ++q)
          b[nt][q] = bs[((kt * NTN + nt) * PIECES + q) * 32 + lane];
      const int j = kt / W::WPL, w = kt % W::WPL;
#pragma unroll
      for (int m = 0; m < W::MG; ++m) {
        const uint32_t lo = wd[2 * m * W::J + j][w], hi = wd[(2 * m + 1) * W::J + j][w];
        const uint32_t a0 = __byte_perm(lo, 0u, 0x4140u), a1 = __byte_perm(hi, 0u, 0x4140u);
        const uint32_t a2 = __byte_perm(lo, 0u, 0x4342u), a3 = __byte_perm(hi, 0u, 0x4342u);
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
          for (int q = PIECES - 1; q >= 0; --q)
            mma16816(acc[m][nt], a0, a1, a2, a3, b[nt][q].x, b[nt][q].y);
      }
    }
    // the unit's rows of T (c0 = 16 mt + grp, + 8; heads 8 nt + 2t, + 1)
    // against e0
    const int mt0 = (u % W::UPR) * W::MG;
#pragma unroll
    for (int m = 0; m < W::MG; ++m) {
      const int c0 = 16 * (mt0 + m) + grp;
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        const float2 za = e0p[c0 * (NH / 2) + HEADS / 2 * nt + t];
        const float2 zb = e0p[(c0 + 8) * (NH / 2) + HEADS / 2 * nt + t];
        s0[nt] = fmaf(za.x, acc[m][nt][0], s0[nt]);
        s0[nt] = fmaf(zb.x, acc[m][nt][2], s0[nt]);
        s1[nt] = fmaf(za.y, acc[m][nt][1], s1[nt]);
        s1[nt] = fmaf(zb.y, acc[m][nt][3], s1[nt]);
      }
    }
    if (u % W::UPR == W::UPR - 1) {
      // the row's sums over the 8 lanes of each head pair, in a fixed tree
      const int rl = r0 + u / W::UPR;
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0[nt] += __shfl_xor_sync(0xffffffffu, s0[nt], o);
          s1[nt] += __shfl_xor_sync(0xffffffffu, s1[nt], o);
        }
        const int h0 = HEADS * nt + 2 * t;
        if (grp == 0) {
          if (h0 < g) res[h0 * tile + rl] = s0[nt];
          if (h0 + 1 < g) res[(h0 + 1) * tile + rl] = s1[nt];
        }
        s0[nt] = s1[nt] = 0.f;
      }
    }
  }
  // the pending joins of this tile's rows: their local row (or -1) and
  // codes
  int any = 0;
  for (int i = tid; i < K; i += THREADS) {
    if (i >= THREADS) {
      p_pos = pos32[2 * ((size_t)hk * K + i)];
      p_a = codes32[2 * ((size_t)hk * 2 * K + i)];
      p_b = codes32[2 * (((size_t)hk * 2 + 1) * K + i)];
    }
    int col = -1;
    if (i < rr) {
      const int c = min(max(p_pos, 0) / block, NB - 1);
      if (c >= tile0 && c < tile0 + nrows) col = c - tile0;
    }
    pcol[i] = col;
    pcode[i] = min(max(p_a, 0), C - 1) | (min(max(p_b, 0), C - 1) << 16);
    any |= col >= 0;
  }
  any = __syncthreads_or(any);

  for (int i = tid; i < g * nrows; i += THREADS) {
    const int h = i / nrows, r = i - h * nrows;
    float v = res[h * tile + r];
    if (any) {
      float s = 0.f;
      for (int k = 0; k < K; ++k) {
        if (pcol[k] == r) {
          const int pc = pcode[k];
          const float z = e0s[(pc & 0xffff) * NH + h] * (1.f / E0_SCALE);
          s = __fadd_rn(s, __fmul_rn(z, e1s[h * C + (pc >> 16)]));
        }
      }
      v = __fadd_rn(v, s);
    }
    out[((size_t)hk * g + h) * NB + tile0 + r] = v;
  }
}

template <int C, int NH>
cudaError_t launch(const float* e, const uint8_t* J, int Hf, int g, int NB,
                   const int64_t* pos, const int64_t* codes, const int* ring_r, int K,
                   int block, float* out, cudaStream_t st) {
  using W = Walk<C>;
  if (reinterpret_cast<uintptr_t>(J) % W::V) return cudaErrorMisalignedAddress;
  // rows per warp: the bytes over about WAVES waves of CTAS_PER_SM CTAs an
  // SM, at most MAX_RPW, then evened out over a head's tiles
  const int R = C * C;
  const double per_warp = (double)Hf * NB * R /
                          ((double)sm_count() * CTAS_PER_SM * NWARPS * WAVES);
  int rpw = max(1, min((int)((per_warp + R - 1) / R), MAX_RPW));
  const int tiles = (NB + NWARPS * rpw - 1) / (NWARPS * rpw);
  rpw = (NB + tiles * NWARPS - 1) / (tiles * NWARPS);
  const int tile = NWARPS * rpw;
  const int smem = RING_BYTES + (int)sizeof(uint2) * W::MT * (NH / HEADS) * PIECES * 32 +
                   (int)sizeof(float) * (16 * W::MT * NH + NH * C + NH * tile) +
                   (int)sizeof(int) * 2 * K;
  auto kernel = jhist_mass_kernel<C, NH>;
  if (smem > SMEM_DEFAULT) {
    // allowed once per process and instantiation, so that a launch inside a
    // CUDA-graph capture makes no attribute call
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin_smem());
    if (attr != cudaSuccess) return attr;
  }
  kernel<<<dim3(tiles, Hf), THREADS, smem, st>>>(
      e, J, g, NB, rpw, pos, codes, ring_r, K, block, out);
  return cudaGetLastError();
}

}  // namespace

// e [Hf * g, 2, C] f32 in [0, 1], J [Hf, NB, C * C] uint8, out [Hf * g, NB]
// f32, all contiguous; C a power of two in [2, 256] and 1 <= g <= 8, or C
// in [16, 256] and 9 <= g <= 16. Pending
// joins: pos [Hf, K] and codes [Hf, 2, K] int64 contiguous, ring_r one
// int32 on the device, 1 <= block; K 0 (and null pointers) for none, at
// most 1024. One launch, which writes out and nothing else. Returns a
// cudaError_t (0 = launched).
extern "C" int pq_jhist_block_mass(const float* e, const uint8_t* J, int Hf, int g, int C,
                                   int NB, const int64_t* pos, const int64_t* codes,
                                   const int* ring_r, int K, int block, float* out,
                                   void* stream) {
  if (Hf < 1 || Hf > 65535 || NB < 1 || g < 1 || g > 2 * HEADS || K < 0 || K > MAX_K ||
      (K > 0 && (!pos || !codes || !ring_r || block < 1)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PQ_ARGS e, J, Hf, g, NB, pos, codes, ring_r, K, block, out, st
  if (g > HEADS) {   // 9 to 16 heads: two n tiles (C 64: the MLA cell's)
    switch (C) {
      case 16: return launch<16, 2 * HEADS>(PQ_ARGS);
      case 32: return launch<32, 2 * HEADS>(PQ_ARGS);
      case 64: return launch<64, 2 * HEADS>(PQ_ARGS);
      case 128: return launch<128, 2 * HEADS>(PQ_ARGS);
      case 256: return launch<256, 2 * HEADS>(PQ_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (C) {
    case 2: return launch<2, HEADS>(PQ_ARGS);
    case 4: return launch<4, HEADS>(PQ_ARGS);
    case 8: return launch<8, HEADS>(PQ_ARGS);
    case 16: return launch<16, HEADS>(PQ_ARGS);
    case 32: return launch<32, HEADS>(PQ_ARGS);
    case 64: return launch<64, HEADS>(PQ_ARGS);
    case 128: return launch<128, HEADS>(PQ_ARGS);
    case 256: return launch<256, HEADS>(PQ_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PQ_ARGS
}
