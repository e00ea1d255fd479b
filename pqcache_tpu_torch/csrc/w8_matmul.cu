// W8: weight-only int8 matrix products of decode rows, hand-written for Hopper
// (sm_90a). One launch computes a group of 1 to 3 products that share x and K.
//
// Replaces no Pallas kernel: in the JAX package, pqcache_tpu/models/llama.py
// ::_mm (:69) and ::lm_head_logits (:90) write `x @ w.astype(bf16)` and XLA
// converts the int8 operand inside the dot, so the weights are read from
// device memory once, as int8. A plain PyTorch version (dequantize to a bf16
// copy, then a bf16 GEMM) reads about 5 bytes per weight instead of 1.
//   x      [M, K] bf16, M <= 64 (decode rows: the Engine's 1, bench.py's B)
//   w_p    [K, N_p] int8, row-major ([in, out] as the layers store it)
//   s_p    [N_p]    bf16 scale per output column
//   lm_head 0 (a layer):   y_p [M, N_p] bf16 = bf16( bf16(x @ w_p) * s_p )
//   lm_head 1 (the head):  y_p [M, N_p] f32  = f32(bf16(x @ w_p)) * f32(s_p)
// (JAX's rounding points: the product rounded to bf16, then scaled in bf16 for
// a layer, in f32 for the head.) Sums in f32 on the tensor cores. The decode
// path groups q/k/v (N 4096/1024/1024 at Llama-3.1-8B width) and gate/up
// (14336 twice); wo, down and the LM head are groups of one.
//
// What bounds it: bytes. The K x N int8 weights are read once; x, s and y
// are small. At M <= 64 it does at most 128 operations per weight byte, below
// the card's ~295. At Llama-3.1-8B width and M = 8 a group reads 4.2 MB
// (wk) to 525 MB (the LM head): 1.25 to 157 us at 3.35 TB/s, so a fixed cost
// per launch weighs on the small products. The kernel this one replaced lost
// ~1.2 us from the previous kernel to its first CTA, ~5 us until its first
// weights reached registers, ~3 us in split-K cluster barriers and a serial
// reduction through distributed shared memory, and left 8-16 SMs idle; each
// of q, k, v, gate and up paid that alone (PERF.md, the W8 findings).
//
// Design: a persistent grid of at most one CTA per SM walks a linear list of
// equal units (product, column tile of CW = 256 columns, k block of KB = 64
// rows), tile by tile and k block by k block, cut into `grid` contiguous
// ranges that differ by at most one unit (stream-K): every SM streams the
// same bytes +- one unit whatever the shapes. ops/w8.py::plan_group and
// ::units compute the same cut in Python.
//  * One producer warp keeps a ring of STAGES = 8 stages (16 KB of weights
//    each) full: a unit is two TMA boxes of [64 rows][128 bytes] of weights
//    and one of x, [8 MT rows][64 columns] (cp.async.bulk.tensor with the
//    128-byte swizzle, completion counted on the stage's mbarrier; rows
//    past K, M and columns past N read 0). The first units are requested
//    RAMP at a time, so the first lands early and the arithmetic overlaps
//    the stream. x comes with every unit from L2: staged whole per CTA, it
//    cost ~6 us a launch with every SM reading the same lines at once. A
//    product whose N or address is not a multiple of 16 bytes (no tensor
//    map) is copied by the producer warp's own loads into the same layout.
//  * Consumers: two groups of 8 warps take the units in turn (one at
//    M > 32, for registers); a warp owns 32 columns of the tile. Per 16-deep
//    k step a lane reads one word (4 columns) of rows {2t, 2t+1, 2t+8,
//    2t+9} (t = lane % 4), which the swizzle puts in 4 different groups of
//    8 banks, converts int8 to bf16 exactly (a byte permute into 2^23 + u,
//    one subtraction; the bf16 pair is the two floats' high halves) and
//    multiplies with mma.sync m16n8k16, these rows being the A fragment's
//    k {2t, 2t+1, 2t+8, 2t+9} and x the B fragment. The conversion is the
//    consumers' main cost: alone they would take about as long as the
//    stream (PERF.md).
//  * Split-K fix-up in a fixed order, no float atomics: at a segment's end
//    the groups' sums are added in group order through shared memory; a
//    tile cut between CTAs c0..c1 has each leave its f32 partial in a
//    scratch slot and count its arrival on the tile's counter (release /
//    acquire at gpu scope); the last to arrive adds the partials in CTA
//    order, writes y and sets the counter back to 0 for the next launch.
//    Eager and replayed calls give the same bits.
//  * A programmatic dependent launch: the grid starts while the kernel
//    before it finishes, and requests its first weights at once; it waits
//    (griddepcontrol.wait) only before reading x.
// Nothing allocated here: the wrapper (ops/w8.py) allocates y and caches the
// scratch (partials and counters, zeroed once per device). The products are
// passed by value in the kernel's parameters, so a launch captures into a
// CUDA graph as it is.

#include "mma_sm90.cuh"  // mbarriers, TMA, named barriers

namespace {

// A unit is a k block of KB = 64 rows of a tile of CW = 256 columns (16 KB
// of weights) and the x columns of its k block.
constexpr int CW = 256, KB = 64, BOX = KB * 128;
constexpr int UNIT_BYTES = KB * CW;
constexpr int STAGES = 8;
constexpr int RAMP = 2;                  // units requested at once at the start
constexpr int COLW = 8;                  // consumer warps across a tile: 32 columns each
constexpr int MAX_GROUP = 3;
constexpr int SLOT = CW * 64;            // floats of a partial (at most 64 rows)
constexpr int MAX_TILES = 8192;          // arrival counters (scratch)
constexpr int BAR_CONSUMERS = 1;         // named barrier of the consumer warps

// The products of a launch. The tensor maps are kernel parameters of their
// own (__grid_constant__, their addresses taken for TMA); this struct is
// read from the constant bank with fixed offsets only (pick).
struct W8Group {
  int tma[MAX_GROUP];          // 1: N_p and w_p 16-byte aligned, the map is set
  const int8_t* w[MAX_GROUP];
  const __nv_bfloat16* s[MAX_GROUP];
  void* out[MAX_GROUP];
  int n[MAX_GROUP];
  int tile0[MAX_GROUP + 1];  // first tile of each product; tile0[count] = tiles
  int count, ipt, units;     // products, k blocks per tile, tiles * ipt
};

// field p of a product (p < 3) without an indexed read of the parameters
template <typename T>
__device__ __forceinline__ T pick(int p, T a, T b, T c) {
  return p == 0 ? a : p == 1 ? b : c;
}

// unit i of the walk: tile after tile, k block after k block
struct Unit {
  int tile, kb, p, n0, ncols;  // tile over the group, k block, product, columns
  __device__ __forceinline__ void locate(const W8Group& g) {
    p = (g.count > 1 && tile >= g.tile0[1]) + (g.count > 2 && tile >= g.tile0[2]);
    n0 = (tile - pick(p, 0, g.tile0[1], g.tile0[2])) * CW;
    ncols = min(CW, pick(p, g.n[0], g.n[1], g.n[2]) - n0);
  }
  __device__ __forceinline__ void at(const W8Group& g, int i) {
    tile = i / g.ipt;
    kb = i - tile * g.ipt;
    locate(g);
  }
  __device__ __forceinline__ void next(const W8Group& g) {
    if (++kb == g.ipt) {
      kb = 0;
      ++tile;
      locate(g);
    }
  }
};

// first unit of CTA c of `grid` over `units`
__device__ __forceinline__ int range_lo(int c, int grid, int units) {
  return (int)((long long)c * units / grid);
}
// the CTA whose range holds unit i
__device__ __forceinline__ int cta_of(int i, int grid, int units) {
  return (int)(((long long)(i + 1) * grid - 1) / units);
}

// byte offset in a stage of weight row r (< KB), column byte c (< CW): box
// c / 128 of 64 rows of 128 bytes whose 16-byte chunks are XOR-ed with r % 8
// (CU_TENSOR_MAP_SWIZZLE_128B, as TMA writes them)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  const int b = c & 127;
  return (c >> 7) * BOX + r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// byte b of w as an exact f32: wx = w ^ 0x80808080 holds v + 128 in each
// byte; 0x4B0000uu is 2^23 + (v + 128)
__device__ __forceinline__ float i8f(uint32_t wx, int b) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 | b)) - 8388736.0f;
}
// two such floats as a bf16 pair, `lo` low: an integer of at most 8
// significant bits keeps its low 16 f32 bits zero, so the high halves are
// its bf16 exactly
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// y[row, n .. n + 1] from the f32 sums (v0, v1): JAX's rounding points
__device__ __forceinline__ void finish(float v0, float v1, const __nv_bfloat16* s,
                                       void* out, int row, int n, int N, int lm_head) {
  const float s0 = __bfloat162float(s[n]), s1 = __bfloat162float(s[n + 1]);
  const size_t o = (size_t)row * N + n;
  if (lm_head) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
        make_float2(bf16r(v0) * s0, bf16r(v1) * s1);
  } else {
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + o) =
        pack_bf16(bf16r(v0) * s0, bf16r(v1) * s1);
  }
}

// one arrival at a tile's counter: release this CTA's partial, acquire the
// others'; the previous count
__device__ __forceinline__ int arrive_acq_rel(int* p) {
  int v;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// announce `bytes` of transactions on an mbarrier without arriving
__device__ __forceinline__ void mbar_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The consumers: GROUPS groups of COLW warps that take the units in turn
// (one group's waits and bookkeeping overlap the other's arithmetic); a
// lane keeps 8 MT accumulators, and at MT 8 one group keeps them in the
// registers 65536 / threads allows. One producer warp.
template <int MT>
__host__ __device__ constexpr int groups() { return MT <= 4 ? 2 : 1; }
template <int MT>
__host__ __device__ constexpr int threads() { return 32 * (COLW * groups<MT>() + 1); }
// a stage: the unit's two weight boxes, then x's box of 8 MT rows
template <int MT>
__host__ __device__ constexpr int stage_bytes() { return UNIT_BYTES + 1024 * MT; }
// the sums of groups 1.. at a segment's end
template <int MT>
__host__ __device__ constexpr int red_bytes() { return (groups<MT>() - 1) * COLW * 32 * 8 * MT * 4; }
// the ring aligned to 1024 bytes (the 128-byte swizzle's period)
template <int MT>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + STAGES * stage_bytes<MT>() + red_bytes<MT>() + 2 * STAGES * 8;
}

// grid: at most one CTA per SM (ops/w8.py::plan_group); threads<MT>()
// threads; smem_bytes<MT>() of dynamic shared memory. MT m16n8 tiles of 8
// rows cover M.
template <int MT>
__global__ void __launch_bounds__(threads<MT>(), 1)
w8_kernel(const __grid_constant__ CUtensorMap map0, const __grid_constant__ CUtensorMap map1,
          const __grid_constant__ CUtensorMap map2, const __grid_constant__ CUtensorMap xmap,
          const W8Group grp, float* __restrict__ part, int* __restrict__ counts, int M,
          int K, int lm_head) {
  constexpr int GROUPS = groups<MT>(), CONSUMERS = COLW * GROUPS;
  constexpr int REGS = 8 * MT;                     // accumulators a lane
  constexpr int STAGE = stage_bytes<MT>(), XBOX = 1024 * MT;
  constexpr int NCT = 32 * CONSUMERS;              // consumer threads
  static_assert(STAGES % GROUPS == 0 && COLW * 32 * REGS <= SLOT &&
                smem_bytes<MT>() <= 232448, "");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(ring + STAGES * STAGE);
  const uint32_t bars = smem_u32(ring + STAGES * STAGE + red_bytes<MT>());
  auto full_bar = [&](int st) { return bars + 8 * st; };
  auto empty_bar = [&](int st) { return bars + 8 * (STAGES + st); };
  __shared__ int last_arrival;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grid = gridDim.x, units = grp.units, ipt = grp.ipt;
  const int lo = range_lo(blockIdx.x, grid, units);
  const int hi = range_lo(blockIdx.x + 1, grid, units);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), COLW);              // the warps of one group
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the next kernel, if a programmatic dependent, may start on the SMs
  // this grid leaves; it reads nothing of this grid before its own wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  Unit u;
  if (warp == CONSUMERS) {
    if (lane <= grp.count && (lane == grp.count || pick(lane, grp.tma[0], grp.tma[1], grp.tma[2])))
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(
                       lane == grp.count ? &xmap : pick(lane, &map0, &map1, &map2)))
                 : "memory");
    // producer. A unit is two TMA boxes of weights (rows past K and columns
    // past N read 0) and x's box (rows past M read 0); the weights of a
    // product whose rows are not 16-byte aligned are copied by the warp's
    // loads into the same swizzled layout.
    // Launched as a programmatic dependent of the kernel before it, the
    // grid may start while that kernel still runs: the weights of the first
    // RAMP units (which no kernel writes) are requested at once, x (which
    // the kernel before may write) only after griddepcontrol.wait; every
    // later read and write of this grid follows that in causality.
    const bool all_tma = grp.tma[0] && (grp.count < 2 || grp.tma[1]) &&
                         (grp.count < 3 || grp.tma[2]);
    const int early = all_tma ? min(hi - lo, RAMP) : 0;
    for (int i = lo; i < lo + early; ++i) {
      u.at(grp, i);
      const CUtensorMap* map = pick(u.p, &map0, &map1, &map2);
      unsigned char* dst = ring + (i - lo) * STAGE;
      if (lane == 0) {
        mbar_expect_tx(full_bar(i - lo), UNIT_BYTES + XBOX);
        tma_load_2d(smem_u32(dst), map, full_bar(i - lo), u.n0, u.kb * KB);
        tma_load_2d(smem_u32(dst + BOX), map, full_bar(i - lo), u.n0 + 128, u.kb * KB);
      }
    }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    u.at(grp, lo);
    for (int i = lo; i < hi; ++i, u.next(grp)) {
      const int j = i - lo, st = j % STAGES;
      unsigned char* dst = ring + st * STAGE;
      if (j < early) {
        if (lane == 0)
          tma_load_2d(smem_u32(dst + UNIT_BYTES), &xmap, full_bar(st), u.kb * KB, 0);
        continue;
      }
      // One lane polls a barrier. The ring's first STAGES units are
      // requested RAMP at a time, each once the unit RAMP before it has
      // landed: were every SM to ask for all its stages at once, its first
      // unit would land with its last (~6 us at Llama-3.1-8B's wo, PERF.md)
      // and the arithmetic could not overlap the stream.
      if (lane == 0) {
        if (j >= STAGES) mbar_wait(empty_bar(st), ((j / STAGES) & 1) ^ 1);
        else if (j >= RAMP) mbar_wait(full_bar(j - RAMP), 0);
      }
      __syncwarp();
      const int tma = pick(u.p, grp.tma[0], grp.tma[1], grp.tma[2]);
      if (lane == 0) {
        if (tma) {
          const CUtensorMap* map = pick(u.p, &map0, &map1, &map2);
          mbar_expect_tx(full_bar(st), UNIT_BYTES + XBOX);
          tma_load_2d(smem_u32(dst), map, full_bar(st), u.n0, u.kb * KB);
          tma_load_2d(smem_u32(dst + BOX), map, full_bar(st), u.n0 + 128, u.kb * KB);
        } else {
          mbar_tx(full_bar(st), XBOX);
        }
        tma_load_2d(smem_u32(dst + UNIT_BYTES), &xmap, full_bar(st), u.kb * KB, 0);
      }
      if (tma) continue;
      const int N = pick(u.p, grp.n[0], grp.n[1], grp.n[2]), rows = min(KB, K - u.kb * KB);
      const int8_t* src =
          pick(u.p, grp.w[0], grp.w[1], grp.w[2]) + (size_t)u.kb * KB * N + u.n0;
      for (int r = 0; r < rows; ++r)
        for (int c = 4 * lane; c < u.ncols; c += 128) {
          uint32_t v;
          asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n"
              : "=r"(v) : "l"(src + (size_t)r * N + c));
          *reinterpret_cast<uint32_t*>(dst + swz(r, c)) = v;
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(full_bar(st));
    }
    return;
  }

  // consumers: warp cw of group gr owns columns [32 cw, 32 cw + 32) of each
  // tile and the units gr, gr + GROUPS, ... of the range
  u.at(grp, lo);
  const int gr = warp / COLW, cw = warp % COLW;
  const int g = lane >> 2, t = lane & 3;
  const int col = 32 * cw + 4 * g;                 // this lane group's first column
  float acc[2][MT][4];
  // this lane's word of weight rows 2t, 2t + 1, 2t + 8, 2t + 9 of a k step:
  // the rows' 16-byte chunks are XOR-ed with 2t or 2t + 1, so the 4 rows of
  // a load land in 4 different groups of 8 banks
  uint32_t off[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) off[q] = swz(2 * t + (q & 1) + 8 * (q >> 1), col);
  // x row 8 mt + g, k 2t of k step ks: 16-byte chunk 2 ks (k + 8: 2 ks + 1)
  // XOR-ed with g, so the 8 rows of a load hit 8 different chunks
  const uint32_t xoff = UNIT_BYTES + g * 128 + 4 * t;
  int seg_lo = lo;                                 // this segment's first unit

  for (int i = lo; i < hi; ++i, u.next(grp)) {
    const int j = i - lo, st = j % STAGES;
    const int N = pick(u.p, grp.n[0], grp.n[1], grp.n[2]), rows = min(KB, K - u.kb * KB);
    if (i == lo || u.kb == 0) {                    // a segment starts
      seg_lo = i;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][mt][e] = 0.f;
    }
    if (j % GROUPS == gr) {
      if (lane == 0) mbar_wait(full_bar(st), (j / STAGES) & 1);
      __syncwarp();
      if (32 * cw < u.ncols) {
        const unsigned char* sm = ring + st * STAGE;
#pragma unroll
        for (int ks = 0; ks < KB / 16; ++ks) {
          if (16 * ks >= rows) break;
          uint32_t wx[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wx[q] = *reinterpret_cast<const uint32_t*>(sm + off[q] + 2048 * ks) ^ 0x80808080u;
          uint32_t b[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const unsigned char* xr = sm + xoff + mt * 1024;
            b[mt][0] = *reinterpret_cast<const uint32_t*>(xr + (((2 * ks) ^ g) << 4));
            b[mt][1] = *reinterpret_cast<const uint32_t*>(xr + (((2 * ks + 1) ^ g) << 4));
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // tile row g: column col + 2h; row g + 8: column col + 2h + 1;
            // k pairs (2t, 2t + 1) from wx[0], wx[1], (2t + 8, 2t + 9) from
            // wx[2], wx[3]
            const uint32_t a0 = pack_hi(i8f(wx[0], 2 * h), i8f(wx[1], 2 * h));
            const uint32_t a1 = pack_hi(i8f(wx[0], 2 * h + 1), i8f(wx[1], 2 * h + 1));
            const uint32_t a2 = pack_hi(i8f(wx[2], 2 * h), i8f(wx[3], 2 * h));
            const uint32_t a3 = pack_hi(i8f(wx[2], 2 * h + 1), i8f(wx[3], 2 * h + 1));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma(acc[h][mt], a0, a1, a2, a3, b[mt][0], b[mt][1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));
    }
    if (i != hi - 1 && u.kb != ipt - 1) continue;

    // the segment ends. acc[h][mt]: c[0], c[1] column col + 2h, rows
    // 8 mt + 2t + {0, 1}; c[2], c[3] the next column. The groups' sums are
    // added in group order into group 0's, which goes on alone.
    if constexpr (GROUPS > 1) {
      float* theirs = red + cw * (32 * REGS) + lane;
      if (gr == 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) theirs[32 * ((h * MT + mt) * 4 + e)] = acc[h][mt][e];
      }
      named_bar_sync(BAR_CONSUMERS, NCT);
      if (gr == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[h][mt][e] += theirs[32 * ((h * MT + mt) * 4 + e)];
      }
      named_bar_sync(BAR_CONSUMERS, NCT);
    }
    auto write_y = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = 8 * mt + 2 * t + e;
            if (row < M && col + 2 * h < u.ncols)
              finish(acc[h][mt][e], acc[h][mt][2 + e], pick(u.p, grp.s[0], grp.s[1], grp.s[2]),
                     pick(u.p, grp.out[0], grp.out[1], grp.out[2]), row,
                     u.n0 + col + 2 * h, N, lm_head);
          }
    };
    const int t0 = u.tile * ipt;
    if (seg_lo == t0 && i == t0 + ipt - 1) {       // the whole tile: write y
      if (gr == 0) write_y();
      continue;
    }
    // a tile cut between CTAs c0..c1 in k order: each leaves its partial
    // (slot 0 if its range starts in the tile, else 1) and counts its
    // arrival; the last to arrive adds the partials in CTA order and
    // writes y, and sets the count back to 0 for the next launch
    const int c0 = cta_of(t0, grid, units), c1 = cta_of(t0 + ipt - 1, grid, units);
    auto partial = [&](int c) {
      const int slot = range_lo(c, grid, units) >= t0 ? 0 : 1;
      return part + (2 * (size_t)c + slot) * SLOT + cw * (32 * REGS) + lane;
    };
    if (gr == 0) {
      float* mine = partial(blockIdx.x);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) __stcg(mine + 32 * ((h * MT + mt) * 4 + e), acc[h][mt][e]);
    }
    // the barrier orders every consumer's stores before thread 0's release
    // (cumulative at gpu scope)
    named_bar_sync(BAR_CONSUMERS, NCT);
    if (threadIdx.x == 0) {
      const int seen = arrive_acq_rel(counts + u.tile);
      last_arrival = seen == c1 - c0;
      if (last_arrival) counts[u.tile] = 0;
    }
    named_bar_sync(BAR_CONSUMERS, NCT);
    if (!last_arrival || gr != 0) continue;
    // y = the partials of c0, c0 + 1, ..., c1 added in that order, the
    // loads of BATCH partials in flight at a time
    constexpr int BATCH = 64 / REGS;
    for (int c = c0; c <= c1; c += BATCH) {
      float v[BATCH][REGS];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const float* theirs = partial(min(c + b, c1));
#pragma unroll
        for (int r = 0; r < REGS; ++r) v[b][r] = __ldcg(theirs + 32 * r);
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (c + b > c1) break;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float w = v[b][(h * MT + mt) * 4 + e];
              acc[h][mt][e] = c + b == c0 ? w : acc[h][mt][e] + w;
            }
      }
    }
    write_y();
  }
}

template <int MT>
cudaError_t run(const CUtensorMap (&maps)[MAX_GROUP], const W8Group& grp, const void* x,
                float* part, int* counts, int M, int K, int grid, int lm_head,
                cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(       // once per process
      w8_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<MT>());
  if (attr != cudaSuccess) return attr;
  CUtensorMap xmap;
  const cudaError_t e = make_tmap_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K,
                                     8 * MT);
  if (e != cudaSuccess) return e;
  // a programmatic dependent launch: the grid may start before the kernel
  // before it on the stream has finished (it waits for it where it reads
  // x); graph capture keeps the dependency as a programmatic edge
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads<MT>());
  cfg.dynamicSmemBytes = smem_bytes<MT>();
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, w8_kernel<MT>, maps[0], maps[1], maps[2],
                                            xmap, grp, part, counts, M, K, lm_head);
  return le != cudaSuccess ? le : cudaGetLastError();
}

}  // namespace

// The group y_p = (x @ w_p) * s_p, p < count (1 to 3 products sharing x and
// K), as above. grid: the CTAs, at most the SMs and the units
// (ops/w8.py::plan_group); part: scratch of 2 grid * 256 * 64 floats;
// counts: MAX_TILES ints, zero before the first launch (each launch leaves
// them zero). Nothing is allocated or copied to the device per call.
extern "C" int pq_w8_group(const void* x, const void* w0, const void* w1, const void* w2,
                           const void* s0, const void* s1, const void* s2, void* o0,
                           void* o1, void* o2, int n0, int n1, int n2, int count, int M,
                           int K, int grid, int lm_head, void* part, void* counts,
                           void* stream) {
  const void* ws[MAX_GROUP] = {w0, w1, w2};
  const void* ss[MAX_GROUP] = {s0, s1, s2};
  void* os[MAX_GROUP] = {o0, o1, o2};
  const int ns[MAX_GROUP] = {n0, n1, n2};
  if (count < 1 || count > MAX_GROUP || M < 1 || M > 64 || K < 16 || K % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  W8Group grp = {};
  CUtensorMap maps[MAX_GROUP] = {};
  grp.count = count;
  grp.ipt = (K + KB - 1) / KB;
  for (int p = 0; p < count; ++p) {
    if (ns[p] < 4 || ns[p] % 4 || reinterpret_cast<uintptr_t>(ws[p]) % 4)
      return cudaErrorInvalidValue;
    grp.tma[p] = ns[p] % 16 == 0 && reinterpret_cast<uintptr_t>(ws[p]) % 16 == 0;
    if (grp.tma[p]) {
      const cudaError_t e = make_tmap_2d(&maps[p], ws[p], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K,
                                         ns[p], KB);
      if (e != cudaSuccess) return e;
    }
    grp.w[p] = static_cast<const int8_t*>(ws[p]);
    grp.s[p] = static_cast<const __nv_bfloat16*>(ss[p]);
    grp.out[p] = os[p];
    grp.n[p] = ns[p];
    grp.tile0[p + 1] = grp.tile0[p] + (ns[p] + CW - 1) / CW;
  }
  for (int p = count + 1; p <= MAX_GROUP; ++p) grp.tile0[p] = grp.tile0[count];
  grp.units = grp.tile0[count] * grp.ipt;
  if (grid < 1 || grid > grp.units || grp.tile0[count] > MAX_TILES)
    return cudaErrorInvalidValue;
  float* pt = static_cast<float*>(part);
  int* cn = static_cast<int*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return run<1>(maps, grp, x, pt, cn, M, K, grid, lm_head, st);
  if (M <= 16) return run<2>(maps, grp, x, pt, cn, M, K, grid, lm_head, st);
  if (M <= 32) return run<4>(maps, grp, x, pt, cn, M, K, grid, lm_head, st);
  return run<8>(maps, grp, x, pt, cn, M, K, grid, lm_head, st);
}
