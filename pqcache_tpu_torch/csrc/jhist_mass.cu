// The joint-histogram block scorer, hand-written for Hopper (sm_90a).
//
// It replaces no Pallas kernel. The JAX package computes this mass with an
// XLA einsum (pqcache_tpu/core/pq.py::joint_block_mass), where the TPU fuses
// the uint8 -> f32 convert into the dot; the port's plain version
// (ops/jhist.py::jhist_block_mass_ref) copies the histogram to f32 and runs
// an f32 GEMM. For one layer:
//   e      [Hf * g, 2, C] f32    exp-LUT factors (core/pq.py::jhist_exp_lut)
//   J      [Hf, NB, C * C] uint8 joint code histogram, read in place
//   pending (optional): pos [Hf, K] int64 tail positions and codes
//          [Hf, 2, K] int64 of the joins the histogram does not count yet,
//          ring_r int32 on the device: the first ring_r of the K are live
//   -> mass [Hf * g, NB] f32, raw (not normalised):
//   mass[h, n] = sum_c0 e0[h, c0] * sum_c1 e1[h, c1] * J[kv(h), n, c0 C + c1]
//              + sum_{t < ring_r, clamp(pos_t / block, 0, NB - 1) == n}
//                    e0[h, code0_t] * e1[h, code1_t]
// The pair table e0 x e1 is never built: the factored sum reads 2 C floats a
// head and does half the operations. Counts convert to floats exactly and
// every sum is f32 (exact products while e1 >= 2^-103; the factors are at
// most 1, as jhist_exp_lut gives them). The pending terms are summed in order t = 0 .. K - 1 and
// then added to the histogram's sum, as the plain version adds its one-hot
// product; every sum runs in a fixed order, so two calls agree bit for bit.
//
// What bounds it: the histogram's bytes. Each byte feeds g FFMAs (8 FLOP a
// byte at g 4), far below the ~295 FLOP a byte where the tensor cores would
// matter, and a bf16 product would round the f32 factors. At the 128k decode
// cell (192 folded kv heads x 514 blocks x 4096 bytes) one layer streams
// 404 MB: 0.121 ms at 3.35 TB/s. The FFMAs, one byte permute a byte and the
// loads' bookkeeping come to about 7 instructions a byte, which the SMs
// issue in about 0.09 ms of the same layer: the kernel has to overlap its
// arithmetic with the stream to approach the bound.
//
// Design:
// - A CTA of NWARPS warps takes one folded kv head and a tile of rows, rpw
//   contiguous rows a warp (a head's last tile may be shorter). The CTA
//   stages the head's factors in shared memory, e0 as [C][G] (one 16-byte
//   load gives 4 heads' factors of a c0) and e1 as [G][C].
// - A lane reads V consecutive bytes of a row at a time (16, or 8 where 8
//   heads need the registers): one c0 and V consecutive c1. The lanes of a
//   row take fixed columns, so each lane holds its V x G e1 factors in
//   registers, and a load costs V byte permutes, V x G FFMAs into per-head
//   partial sums and G FFMAs by e0. A byte becomes a float without a
//   conversion: its bits as a float are x 2^-149, exactly, and with e1
//   held as e1 2^126 each product is e1 x 2^-23, exactly.
// - Loads are cp.async copies into a per-lane ring of DEPTH slots in shared
//   memory, AHEAD loads ahead: a lane reads back only what it copied, so it
//   needs no barrier, and the bytes in flight cost no registers. A lane sums
//   two loads at a time, in independent chains.
// - The first copies fly while the CTA stages the factors; the pending
//   joins' positions and codes are loaded with the factors, in the same
//   round trip, and read after the rows.
// - At a row's end its lanes sum across the warp (shuffles, a fixed tree),
//   and the row's sums go to shared memory. The CTA then adds the pending
//   terms of its rows (only a CTA whose rows hold a pending join loops over
//   them) and writes its outputs, coalesced along the rows.
// - The grid is sized from the SM count and the bytes: rows per warp so that
//   the grid makes about WAVES waves of CTAS_PER_SM CTAs an SM.
// Every row is read, the zero rows past a slot's candidates too.
// C = 2 rows (4 bytes) are too narrow for cp.async: V 2 loads synchronously.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = 32 * NWARPS;
constexpr int DEPTH = 8;           // loads per lane in the ring
constexpr int AHEAD = DEPTH - 2;   // copies in flight ahead of the sums
constexpr int CTAS_PER_SM = 2;
constexpr int WAVES = 8;           // waves of CTAs the grid aims at
constexpr int MAX_RPW = 16;        // rows per warp
constexpr int MAX_K = 1024;        // pending joins
constexpr int SMEM_DEFAULT = 48 * 1024;

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
__device__ __forceinline__ void read_slot(const void* slot, uint32_t (&w)[(V + 3) / 4]) {
  const typename Vec<V>::T v = *static_cast<const typename Vec<V>::T*>(slot);
  if constexpr (V == 16) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (V == 8) {
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = v;
  }
}

// the G factors e0[., c0] of a shared [C][G] table
template <int G>
__device__ __forceinline__ void load_e0(const float* e0s, int c0, float (&z)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int q = 0; q < G / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(e0s + c0 * G)[q];
      z[4 * q] = t.x; z[4 * q + 1] = t.y; z[4 * q + 2] = t.z; z[4 * q + 3] = t.w;
    }
  } else if constexpr (G == 2) {
    const float2 t = reinterpret_cast<const float2*>(e0s)[c0];
    z[0] = t.x; z[1] = t.y;
  } else {
    z[0] = e0s[c0];
  }
}

// Shared memory: the lanes' rings, e0 [C][G], e1 [G][C], the rows' sums
// [G][tile], the pending joins' local rows and codes [K] each.
template <int V>
__host__ __device__ constexpr int ring_bytes() {
  return NWARPS * DEPTH * 32 * V;
}

template <int V, int G>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
jhist_mass_kernel(const float* __restrict__ e, const uint8_t* __restrict__ J, int g, int C,
                  int NB, int rpw, const int64_t* __restrict__ pos,
                  const int64_t* __restrict__ codes, const int* __restrict__ ring_r, int K,
                  int block, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = C * C;
  const int LPR = min(32, R / V);        // lanes of a row
  const int IT = max(1, R / (32 * V));   // loads a lane makes of a row
  // tile b of a head: rows [b tile, (b + 1) tile), rpw a warp
  const int tile = NWARPS * rpw;
  const int hk = blockIdx.y;
  const int tile0 = blockIdx.x * tile;
  const int nrows = min(tile, NB - tile0);
  float* e0s = reinterpret_cast<float*>(smem + ring_bytes<V>());
  float* e1s = e0s + C * G;
  float* res = e1s + G * C;
  int* pcol = reinterpret_cast<int*>(res + G * tile);
  int* pcode = pcol + K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // This warp's rows are contiguous, and each load of the warp covers 32 V
  // bytes of them: load k of a lane reads the V bytes at k 32 V + lane V
  // of the warp's span. Its first copies fly while the CTA stages the
  // factors.
  const int r0 = warp * rpw;
  const int rows_w = max(0, min(rpw, nrows - r0));
  const int span = rows_w * R, off = lane * V;
  const int n_vec = (span + 32 * V - 1) / (32 * V);
  const uint8_t* src = J + ((size_t)hk * NB + tile0 + r0) * R + off;
  unsigned char* ring = smem + ((size_t)warp * DEPTH * 32 + lane) * V;
  auto issue = [&](int k) {
    if (k < n_vec && k * 32 * V + off < span)
      copy_in<V>(ring + (k % DEPTH) * 32 * V, src + (size_t)k * 32 * V);
    if constexpr (V >= 4) commit();
  };
#pragma unroll
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
  for (int i = tid; i < G * C; i += THREADS) {
    const int h = i / C, c = i - h * C;
    float a = 0.f, b = 0.f;
    if (h < g) {
      const float* eh = e + ((size_t)hk * g + h) * 2 * C;
      a = eh[c];
      b = eh[C + c];
    }
    e0s[c * G + h] = a;
    e1s[h * C + c] = b;
  }
  __syncthreads();

  // this lane's columns [c1b, c1b + V) of c0 = c0b + i dc0 at its i-th
  // load of a row. A byte taken as a float's bits is x 2^-149, exactly; e1
  // held as e1 2^126 makes each product e1 x 2^-23 exactly (normal while
  // e1 >= 2^-103), so the sums are the unscaled sums' roundings, 2^-23
  // times, and a row's sum is scaled back by 2^23: no conversion op
  const int sub = lane % LPR;
  const int c1b = (sub * V) % C, c0b = (sub * V) / C, dc0 = LPR * V / C;
  float e1r[G][V];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int j = 0; j < V; ++j) e1r[h][j] = e1s[h * C + c1b + j] * 0x1p126f;

  // Row steps of RPS rows (one row where a row spans the warp), each of
  // IT loads a lane, summed two loads at a time where IT allows: the pair's
  // partial sums are independent chains. Copies run AHEAD loads ahead, so
  // that a pair's two copies land in the slots of the two loads before it.
  const int RPS = 32 / LPR;
  const int steps = (rows_w + RPS - 1) / RPS;
  int k = 0;                             // the lane's next load
  auto fetch = [&](int at, bool live, uint32_t (&w)[(V + 3) / 4]) {
    read_slot<V>(ring + (at % DEPTH) * 32 * V, w);
    if (!live) {
#pragma unroll
      for (int j = 0; j < (V + 3) / 4; ++j) w[j] = 0u;
    }
  };
  auto sum = [&](const uint32_t (&w)[(V + 3) / 4], int i, float (&acc)[G]) {
    float z[G];
    load_e0<G>(e0s, c0b + i * dc0, z);
    float p[G];
#pragma unroll
    for (int h = 0; h < G; ++h) p[h] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float x = __uint_as_float(__byte_perm(w[j / 4], 0u, 0x4440u | (j % 4)));
#pragma unroll
      for (int h = 0; h < G; ++h) p[h] = fmaf(e1r[h][j], x, p[h]);
    }
#pragma unroll
    for (int h = 0; h < G; ++h) acc[h] = fmaf(z[h], p[h], acc[h]);
  };
#pragma unroll 1
  for (int st = 0; st < steps; ++st) {
    const int rl = st * RPS + lane / LPR;
    const bool live = rl < rows_w;
    float acc[G];
#pragma unroll
    for (int h = 0; h < G; ++h) acc[h] = 0.f;
    if (IT == 1) {
      issue(k + AHEAD);
      wait_ahead<V>();
      uint32_t w[(V + 3) / 4];
      fetch(k, live, w);
      sum(w, 0, acc);
      ++k;
    } else {
#pragma unroll 1
      for (int i = 0; i < IT; i += 2, k += 2) {
        issue(k + AHEAD);
        issue(k + AHEAD + 1);
        wait_ahead<V>();
        uint32_t wa[(V + 3) / 4], wb[(V + 3) / 4];
        fetch(k, live, wa);
        fetch(k + 1, live, wb);
        float acc_b[G];
#pragma unroll
        for (int h = 0; h < G; ++h) acc_b[h] = 0.f;
        sum(wa, i, acc);
        sum(wb, i + 1, acc_b);
#pragma unroll
        for (int h = 0; h < G; ++h) acc[h] += acc_b[h];
      }
    }
    // the step's rows, each summed over its LPR lanes in a fixed tree
#pragma unroll
    for (int h = 0; h < G; ++h) {
      for (int o = LPR / 2; o > 0; o >>= 1)
        acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], o);
    }
    if (sub == 0 && live) {
#pragma unroll
      for (int h = 0; h < G; ++h) res[h * tile + r0 + rl] = acc[h] * 0x1p23f;
    }
  }
  // the pending joins of this tile's rows: their local row (or -1) and
  // codes
  int any = 0;
  for (int t = tid; t < K; t += THREADS) {
    if (t >= THREADS) {
      p_pos = pos32[2 * ((size_t)hk * K + t)];
      p_a = codes32[2 * ((size_t)hk * 2 * K + t)];
      p_b = codes32[2 * (((size_t)hk * 2 + 1) * K + t)];
    }
    int col = -1;
    if (t < rr) {
      const int c = min(max(p_pos, 0) / block, NB - 1);
      if (c >= tile0 && c < tile0 + nrows) col = c - tile0;
    }
    pcol[t] = col;
    pcode[t] = min(max(p_a, 0), C - 1) | (min(max(p_b, 0), C - 1) << 16);
    any |= col >= 0;
  }
  any = __syncthreads_or(any);

  for (int i = tid; i < g * nrows; i += THREADS) {
    const int h = i / nrows, r = i - h * nrows;
    float v = res[h * tile + r];
    if (any) {
      float s = 0.f;
      for (int t = 0; t < K; ++t) {
        if (pcol[t] == r) {
          const int pc = pcode[t];
          s = __fadd_rn(s, __fmul_rn(e0s[(pc & 0xffff) * G + h], e1s[h * C + (pc >> 16)]));
        }
      }
      v = __fadd_rn(v, s);
    }
    out[((size_t)hk * g + h) * NB + tile0 + r] = v;
  }
}

template <int V, int G>
cudaError_t launch(const float* e, const uint8_t* J, int Hf, int g, int C, int NB,
                   const int64_t* pos, const int64_t* codes, const int* ring_r, int K,
                   int block, float* out, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(J) % V) return cudaErrorMisalignedAddress;
  // rows per warp: the bytes over about WAVES waves of CTAS_PER_SM CTAs an
  // SM, a whole number of row steps, at most MAX_RPW and no more than a
  // head's rows need
  const int R = C * C, RPS = 32 / min(32, R / V);
  const double per_warp = (double)Hf * NB * R /
                          ((double)sm_count() * CTAS_PER_SM * NWARPS * WAVES);
  int rpw = max(1, min((int)((per_warp + R - 1) / R),
                       min(MAX_RPW, (NB + NWARPS - 1) / NWARPS)));
  rpw = (rpw + RPS - 1) / RPS * RPS;
  const int tile = NWARPS * rpw;
  const int smem = ring_bytes<V>() + (int)sizeof(float) * (2 * C * G + G * tile) +
                   (int)sizeof(int) * 2 * K;
  auto kernel = jhist_mass_kernel<V, G>;
  if (smem > SMEM_DEFAULT) {
    // allowed once per process and instantiation, so that a launch inside a
    // CUDA-graph capture makes no attribute call
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin_smem());
    if (attr != cudaSuccess) return attr;
  }
  kernel<<<dim3((NB + tile - 1) / tile, Hf), THREADS, smem, st>>>(
      e, J, g, C, NB, rpw, pos, codes, ring_r, K, block, out);
  return cudaGetLastError();
}

template <int G>
cudaError_t by_width(const float* e, const uint8_t* J, int Hf, int g, int C, int NB,
                     const int64_t* pos, const int64_t* codes, const int* ring_r, int K,
                     int block, float* out, cudaStream_t st) {
#define PQ_ARGS e, J, Hf, g, C, NB, pos, codes, ring_r, K, block, out, st
  // V: one c0's run of bytes, at most 16 (8 at G 8: V x G factors in
  // registers)
  const int V = min(C, G <= 4 ? 16 : 8);
  switch (V) {
    case 16:
      if constexpr (G <= 4) return launch<16, G>(PQ_ARGS);
      return cudaErrorInvalidValue;
    case 8: return launch<8, G>(PQ_ARGS);
    case 4: return launch<4, G>(PQ_ARGS);
    case 2: return launch<2, G>(PQ_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PQ_ARGS
}

}  // namespace

// e [Hf * g, 2, C] f32, J [Hf, NB, C * C] uint8, out [Hf * g, NB] f32, all
// contiguous; C a power of two in [2, 256], 1 <= g <= 8. Pending joins: pos
// [Hf, K] and codes [Hf, 2, K] int64 contiguous, ring_r one int32 on the
// device, 1 <= block; K 0 (and null pointers) for none, at most 1024. One
// launch, which writes out and nothing else. Returns a cudaError_t (0 =
// launched).
extern "C" int pq_jhist_block_mass(const float* e, const uint8_t* J, int Hf, int g, int C,
                                   int NB, const int64_t* pos, const int64_t* codes,
                                   const int* ring_r, int K, int block, float* out,
                                   void* stream) {
  if (Hf < 1 || Hf > 65535 || NB < 1 || g < 1 || g > 8 || C < 2 || C > 256 || (C & (C - 1)) ||
      K < 0 || K > MAX_K || (K > 0 && (!pos || !codes || !ring_r || block < 1)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PQ_ARGS e, J, Hf, g, C, NB, pos, codes, ring_r, K, block, out, st
  if (g == 1) return by_width<1>(PQ_ARGS);
  if (g == 2) return by_width<2>(PQ_ARGS);
  if (g <= 4) return by_width<4>(PQ_ARGS);
  return by_width<8>(PQ_ARGS);
#undef PQ_ARGS
}
