// W8: weight-only int8 matrix product of decode rows, hand-written for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package, pqcache_tpu/models/llama.py
// ::_mm (:69) and ::lm_head_logits (:90) write `x @ w.astype(bf16)` and XLA
// converts the int8 operand inside the dot, so the weights are read from
// device memory once, as int8. A plain PyTorch version (dequantize to a bf16
// copy, then a bf16 GEMM) reads about 5 bytes per weight instead of 1.
//   x   [M, K] bf16, M <= 64 (decode rows: the Engine's 1, bench.py's B)
//   w   [K, N] int8, row-major ([in, out] as the layers store it, N contiguous)
//   s   [N]    bf16 scale per output column
//   lm_head 0 (a layer):   y [M, N] bf16 = bf16( bf16(x @ w) * s )
//   lm_head 1 (the head):  y [M, N] f32  = f32(bf16(x @ w)) * f32(s)
// (JAX's rounding points: the product rounded to bf16, then scaled in bf16 for
// a layer, in f32 for the head.) Sums in f32 on the tensor cores.
//
// What bounds it: bytes. K x N int8 weights read once; x, s and y are small.
// At Llama-3.1-8B width, M = 8: 4.2 MB (wk, wv) to 525 MB (the LM head), 1.25
// to 157 us at 3.35 TB/s. At M <= 64 it does at most 128 operations per
// weight byte, below the card's ~295, so it stays bound by bytes; on the
// small matrices a fixed cost per launch dominates (PERF.md).
//
// Design: a warp owns 8 * NB output columns (lane group g = lane / 4 owns NB
// consecutive ones) and a K slice. Per 16-deep step each lane loads NB bytes
// from each of 4 weight rows (rows 4 t .. 4 t + 3, t = lane % 4) straight from
// device memory: 8 lanes read 8 * NB contiguous bytes of a row, so the loads
// are coalesced 16-byte (NB 16) pieces; a group of U steps is loaded into
// registers while the group before it is converted and multiplied, so two
// groups are in flight per lane. The mma.sync m16n8k16 operands are built in
// registers with no shared-memory transpose: a product sums over k in any
// order, so logical k
// columns {2t, 2t+1, 2t+8, 2t+9} of the A fragment are mapped to this lane's
// rows 4t .. 4t + 3, and the B fragment (x) takes the same rows; the 16 rows of
// tile j are columns (2j, 2j + 1) of each lane group's NB. int8 converts to
// bf16 exactly (a byte permute into 2^23 + u, one subtraction, one pack).
// x is staged in shared memory in K chunks (8-byte reads, rows padded so a
// half-warp hits 16 banks). Split-K is one launch: the CTAs that split a
// column tile's K form a thread-block cluster; each leaves its f32 partial
// in its own shared memory (the x buffer, done with), and after a cluster
// barrier CTA r adds slice r of the tile over the cluster's CTAs in rank
// order through distributed shared memory, scales and stores it:
// deterministic, no atomics, no scratch, no second kernel. Static shared
// memory under 48 KB; the one attribute (clusters above 8) is set once per
// process. Nothing allocated here: the wrapper (ops/w8.py) allocates y.

#include <cooperative_groups.h>

#include "mma_sm90.cuh"  // pack_bf16, cluster launch and attribute

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int U = 4;  // 16-deep steps a lane loads as one group

// NB bytes of w at p, as NB / 4 words; read once, so not kept in L1
template <int NB>
__device__ __forceinline__ void ldw(const int8_t* p, uint32_t (&v)[NB / 4]) {
  if constexpr (NB == 16) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "l"(p));
  } else if constexpr (NB == 8) {
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
        : "=r"(v[0]), "=r"(v[1]) : "l"(p));
  } else {
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(v[0]) : "l"(p));
  }
}

// byte b of w (int8) as an exact float: w ^ 0x80808080 holds v + 128 in each
// byte; 0x4B0000uu is 2^23 + (v + 128)
__device__ __forceinline__ float i8f(uint32_t wx, int b) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 | b)) - 8388736.0f;
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
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

// grid (splits, ceil(N / CW)), clusters of `splits` CTAs along x (one column
// tile of CW = WARPS * 8 * NB columns), WARPS warps. MT m16n8 tiles of 8 rows
// cover M; NB bytes per lane and weight row (N % NB == 0, so a lane's columns
// are all inside N or all outside).
template <int MT, int NB>
__global__ void __launch_bounds__(32 * WARPS)
w8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
          const __nv_bfloat16* __restrict__ s, void* __restrict__ out, int M, int N,
          int K, int lm_head) {
  constexpr int ROWS = 8 * MT;        // x rows staged, M padded with zeros
  constexpr int KC = 2048 / MT;       // k per staged chunk (a multiple of 16 U)
  constexpr int STRIDE = KC + 16;     // row stride in bf16: 2 KC + 32 bytes
  constexpr int NT = NB / 2;          // tiles of 16 columns per warp
  constexpr int CW = WARPS * 8 * NB;  // columns of the CTA's tile
  // the staged x, then this CTA's f32 partial [ROWS][CW]
  constexpr int XS_BYTES = ROWS * STRIDE * 2, RED_BYTES = ROWS * CW * 4;
  static_assert(RED_BYTES <= XS_BYTES, "the partial must fit the x buffer");
  __shared__ __align__(16) unsigned char smem[XS_BYTES];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = ((int)blockIdx.y * WARPS + warp) * 8 * NB + g * NB;
  const bool live = n0 < N;
  const int steps = K / 16, split = blockIdx.x, splits = gridDim.x;
  const int s_lo = (int)((long long)steps * split / splits);
  const int s_hi = (int)((long long)steps * (split + 1) / splits);
  const int8_t* wl = w + (size_t)(4 * t) * N + n0;

  float acc[NT][MT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;

  // the weight rows of the U steps from st: zeros past the split or N
  auto load = [&](uint32_t (&v)[U][4][NB / 4], int st) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (live && st + u < s_hi) {
          ldw<NB>(wl + (size_t)(16 * (st + u) + i) * N, v[u][i]);
        } else {
#pragma unroll
          for (int q = 0; q < NB / 4; ++q) v[u][i][q] = 0u;
        }
      }
  };
  // x[:, 16 c_lo ...] for the chunk of steps from c_lo, rows >= M zero
  int c_lo = s_lo, c_hi = s_lo;
  auto stage = [&](int st) {
    if (st < c_hi) return;
    c_lo = st;
    c_hi = min(s_hi, st + KC / 16);
    const int per_row = 2 * (c_hi - c_lo);      // 16-byte pieces of a row
    __syncthreads();                            // the last chunk is read
    for (int i = threadIdx.x; i < ROWS * per_row; i += 32 * WARPS) {
      const int r = i / per_row, c = 8 * (i - r * per_row);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < M) v = *reinterpret_cast<const uint4*>(x + (size_t)r * K + 16 * c_lo + c);
      *reinterpret_cast<uint4*>(xs + r * STRIDE + c) = v;
    }
    __syncthreads();
  };
  auto compute = [&](const uint32_t (&v)[U][4][NB / 4], int st) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (st + u >= s_hi) break;
      const int kk = 16 * (st + u - c_lo) + 4 * t;
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint2 bv = *reinterpret_cast<const uint2*>(xs + (8 * mt + g) * STRIDE + kk);
        b[mt][0] = bv.x;    // k rows 4t, 4t + 1: logical 2t, 2t + 1
        b[mt][1] = bv.y;    // k rows 4t + 2, 4t + 3: logical 2t + 8, 2t + 9
      }
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) {      // 4 columns: tiles 2q, 2q + 1
        float f[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t wx = v[u][i][q] ^ 0x80808080u;
#pragma unroll
          for (int c = 0; c < 4; ++c) f[i][c] = i8f(wx, c);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // tile row g: column 4q + 2h of the lane group; row g + 8: the next
          const uint32_t a0 = pack_bf16(f[0][2 * h], f[1][2 * h]);
          const uint32_t a1 = pack_bf16(f[0][2 * h + 1], f[1][2 * h + 1]);
          const uint32_t a2 = pack_bf16(f[2][2 * h], f[3][2 * h]);
          const uint32_t a3 = pack_bf16(f[2][2 * h + 1], f[3][2 * h + 1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma(acc[2 * q + h][mt], a0, a1, a2, a3, b[mt][0], b[mt][1]);
        }
      }
    }
  };

  // two groups of U steps in flight: the next group's loads are issued
  // before the current group is converted and multiplied
  uint32_t va[U][4][NB / 4], vb[U][4][NB / 4];
  load(va, s_lo);
  for (int st = s_lo; st < s_hi; st += 2 * U) {
    stage(st);
    load(vb, st + U);
    compute(va, st);
    if (st + U >= s_hi) break;
    stage(st + U);
    load(va, st + 2 * U);
    compute(vb, st + U);
  }
  // c[0], c[1]: column n0 + 2j, rows 8 mt + 2t + {0, 1}; c[2], c[3]: column + 1
  if (splits == 1) {
    if (!live) return;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * mt + 2 * t + e;
          if (row < M) finish(acc[j][mt][e], acc[j][mt][2 + e], s, out, row,
                              n0 + 2 * j, N, lm_head);
        }
    return;
  }
  // split-K: the partial into this CTA's shared memory, then CTA `split`
  // finishes columns [split * cw, split * cw + cw) of the tile
  float* red = reinterpret_cast<float*>(smem);
  const int c0 = warp * 8 * NB + g * NB;        // n0's column in the tile
  __syncthreads();                              // x is read
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(red + (8 * mt + 2 * t + e) * CW + c0 + 2 * j) =
            make_float2(acc[j][mt][e], acc[j][mt][2 + e]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                               // every partial is written
  const int cw = CW / splits, pairs = M * cw / 2;
  for (int i = threadIdx.x; i < pairs; i += 32 * WARPS) {
    const int row = i / (cw / 2), c = split * cw + 2 * (i - row * (cw / 2));
    const int n = (int)blockIdx.y * CW + c;
    if (n >= N) continue;
    float2 a = make_float2(0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(red + row * CW + c, r));
      a.x += v.x;
      a.y += v.y;
    }
    finish(a.x, a.y, s, out, row, n, N, lm_head);
  }
  cluster.sync();                               // peers are done reading
}

template <int MT, int NB>
cudaError_t run(const void* x, const void* w, const void* s, void* out, int M, int N,
                int K, int splits, int lm_head, cudaStream_t st) {
  auto kernel = w8_kernel<MT, NB>;
  static const cudaError_t attr = allow_big_clusters(kernel);   // once
  if (attr != cudaSuccess) return attr;
  const int cols = WARPS * 8 * NB;
  return launch_cluster(kernel, dim3(splits, (N + cols - 1) / cols), 32 * WARPS, 0, st,
                        static_cast<const __nv_bfloat16*>(x),
                        static_cast<const int8_t*>(w),
                        static_cast<const __nv_bfloat16*>(s), out, M, N, K, lm_head);
}

template <int MT>
cudaError_t by_nb(int nb, const void* x, const void* w, const void* s, void* out,
                  int M, int N, int K, int splits, int lm_head, cudaStream_t st) {
  // the widest load keeps NT * MT * 4 accumulators at or under 64 registers
  if constexpr (MT <= 2) {
    if (nb == 16) return run<MT, 16>(x, w, s, out, M, N, K, splits, lm_head, st);
  }
  if constexpr (MT <= 4) {
    if (nb == 8) return run<MT, 8>(x, w, s, out, M, N, K, splits, lm_head, st);
  }
  if (nb == 4) return run<MT, 4>(x, w, s, out, M, N, K, splits, lm_head, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// y = (x @ w) * s as above; mt = ceil(M / 8) rounded up to 1, 2, 4 or 8, nb the
// bytes a lane loads per weight row (16, 8 or 4; N % nb == 0), splits the CTAs
// of a cluster along K (a power of two, 1 to 16). ops/w8.py::plan chooses them.
extern "C" int pq_w8_matmul(const void* x, const void* w, const void* s, void* out, int M,
                            int N, int K, int mt, int nb, int splits, int lm_head,
                            void* stream) {
  if (M < 1 || M > 8 * mt || (mt > 1 && M <= 4 * mt) || N < 4 || N % nb || K < 16 ||
      K % 16 || splits < 1 || splits > 16 || (splits & (splits - 1)) ||
      splits > K / 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return by_nb<1>(nb, x, w, s, out, M, N, K, splits, lm_head, st);
    case 2: return by_nb<2>(nb, x, w, s, out, M, N, K, splits, lm_head, st);
    case 4: return by_nb<4>(nb, x, w, s, out, M, N, K, splits, lm_head, st);
    case 8: return by_nb<8>(nb, x, w, s, out, M, N, K, splits, lm_head, st);
    default: return cudaErrorInvalidValue;
  }
}
