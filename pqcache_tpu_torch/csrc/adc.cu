// K5 (ADC scores) and K3 (fused ADC block scorer), hand-written for Hopper
// (sm_90a). Both index a per-kv-head lookup table held in shared memory by
// uint8 PQ codes.
//
// K5 replaces pqcache_tpu/ops/adc_pallas.py::adc_scores_pallas (body
// _adc_kernel) and adc_scores_pallas_v2 (_adc_kernel_v2, _adc_v2_call):
//   lut    [Hf, g, S, C] f32   (Hf = leading dims x H_kv, folded)
//   codes  [Hf, S, T]    uint8
//   -> scores [Hf, g, T] f32,  scores[h,j,t] = sum_s lut[h,j,s,codes[h,s,t]]
// With round_bf16 the LUT entries are rounded to bf16 on load: the v2 TPU
// kernel feeds a bf16 LUT to its one-hot matmul and sums in f32, so v2 is the
// f32 sum of bf16-rounded entries and v1 the sum of the f32 entries. The sum
// starts at subvector 0 and adds the others in order, which for S <= 2 is the
// plain version's sum exactly.
//
// What bounds K5: each token reads S code bytes and writes g f32 scores, with
// S lookups per score and no other arithmetic: bytes. At the 32k decode
// shapes (8 kv heads x 4 q heads, S 2, T 33024) that is 528 KB of codes and
// 4.23 MB of scores, 1.42 us at 3.35 TB/s; at bench.py's batched per-token
// shapes (64 folded heads, T 33536) 4.3 MB and 34.3 MB, 11.5 us.
//
// K5 design: the TPU kernel built a one-hot matrix and ran an MXU matmul, its
// way around a slow scalar gather. Here the lookup is direct, and the kernel
// is a stream: codes in, scores out, each moved once in 16-byte pieces.
// - A warp takes units of 512 tokens of one folded head. Each lane copies 16
//   consecutive tokens' codes of each subvector (16 bytes, cp.async) into
//   the warp's buffer in shared memory; the first unit's copies are issued
//   before the CTA stages the LUT, so they fly during the stage, and the
//   next unit's before the current one is computed (two buffers).
// - A lane then takes 4-token words at 4 lane + 128 k (k < 4) of the unit,
//   so each 16-byte score store of the warp writes 512 contiguous bytes of
//   one q head's row. (A lane writing its own 16 consecutive tokens puts
//   its stores 64 bytes apart: 6.2 us at the Engine's shapes on an H100 at
//   700 W, twice the one-token-per-thread kernel this one replaced.)
// - The LUT is staged once per CTA as float4 rows [S][C][g/4] (rounded to
//   bf16 for v2), so one (subvector, code) lookup reads 4 q heads' entries
//   in one 16-byte shared load, and replicated R times (8 at the main
//   shapes, 16 KB): lane l reads copy l % 8, so the 8 lanes of a
//   quarter-warp each read their own bank group and random codes cause no
//   bank conflict (on an H100 at 700 W, 3.09 us against 3.23 with one
//   copy at the Engine's shapes; the same at 64 heads). g not a multiple of 4 keeps one
//   [S][C][g] copy and scalar lookups.
// - The grid is sized from the SM count: at most K5_WAVE_CTAS CTAs per SM,
//   all resident at once, each looping over its warps' share of units.
// - T % 16 != 0, or a codes or scores pointer off 16 bytes, takes the scalar
//   path, chosen at launch: byte code loads straight from device memory and
//   4-byte score stores.
// No atomics, no scratch in device memory.
//
// K3 replaces pqcache_tpu/ops/adc_pallas.py::adc_block_scores_pallas and
// adc_block_scores_pallas_batched (_adc_block_call, body k2):
//   lut [B, H_kv, g, S, C] f32, codes [B, H_kv, S, T] uint8 (T % sel_block
//   == 0), n_cand [B] int32 or one scalar
//   -> per-q-head normalised block mass [B, H, T / sel_block] f32: ADC
//      scores x 1/sqrt(head_dim), tokens at or past n_cand masked, softmax
//      over the row, summed per sel_block block; a row with n_cand 0 is all
//      zeros. Everything is f32; the TPU kernel's bf16 rounding of p before
//      its indicator matmul is not copied.
// What bounds K3: it reads the codes once (528 KB at the main shapes: 8 kv
// heads, S 2, T 33024) and writes a few KB: bytes, 0.17 us at 3.35 TB/s,
// which is below the cost of one launch. So the goal is one launch whose
// time approaches an empty kernel's.
//
// K3 design: the TPU kernel carries a running max and per-block sums across
// its sequential grid; here one launch does it all on chip. Each (b, kv
// head) gets a cluster of up to 8 CTAs (fewer as B * H_kv grows, so the grid
// about fills the SMs), and CTA i takes an equal contiguous share of the
// row's blocks. At the main shapes on an H100 (codes cold, CUDA-graph
// replay) 8 CTAs took 8.86-8.87 us, 16 took 9.09-9.12, 4 13.6 and 1 43.5. A thread takes one chunk of TPI tokens of one block
// (16 unless a block is longer than 4096 tokens): it issues its 16-byte code
// loads (16 tokens of one subvector each) before the CTA stages the LUT, so
// the loads fly while the LUT is copied, then computes the chunk's scores
// for the g q heads from the shared-memory LUT, once, keeping a running max
// and exp-sum four tokens at a time. The chunks of a block are folded by
// shuffles (in groups of up to 32, a power of two), the rest in shared
// memory, into the block's (m_b, u_b); warp j then takes the CTA's
// (M, Z) = (max m_b, sum u_b exp(m_b - M)) for q head j. Every CTA sends its
// (M, Z) to every CTA of the cluster through distributed shared memory;
// after one cluster barrier each takes the row's from them in rank order and
// writes u_b exp(m_b - M) / max(Z, 1e-30) for its blocks. A share longer
// than one round of chunks (256 per CTA) is taken in rounds: a finished
// round's u_b exp(m_b - M_round) waits in the output, rescaled at the end.
// No second kernel, no scratch in device memory, no atomics: deterministic.

#include <cooperative_groups.h>

#include "mma_sm90.cuh"  // split cluster barriers, the cluster launch

namespace cg = cooperative_groups;

namespace {

constexpr int K5_THREADS = 128;        // K5: threads per CTA
constexpr int K5_WARPS = K5_THREADS / 32;
constexpr int K5_UNIT = 512;           // K5: tokens of one warp's unit
constexpr int K5_WAVE_CTAS = 4;        // K5: CTAs per SM the grid aims for
constexpr int K5_COPIES = 8;           // K5: LUT copies, at most
constexpr int K5_COPIES_SMEM = 32 * 1024;   // K5: bytes the copies may take
constexpr int MAX_SMEM = 227 * 1024;
constexpr int K3_THREADS = 256;        // K3: also the chunks of one round
constexpr int K3_MAX_CTAS = 8;         // K3: CTAs per (b, kv head), at most
constexpr int MAX_G = 8;               // K3: q heads per kv head
constexpr int TOK = 16;                // K3: tokens of one 16-byte code load
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <bool ROUND>
__device__ __forceinline__ float lut_entry(float v) {
  return ROUND ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait for all but the newest group of copies
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// stage one kv head's LUT [g][S][C] in shared memory: g % 4 == 0 as float4
// rows [S][C][g/4], each row R times side by side (a thread per row, its
// copies written from copy row % R on, so that neighbouring threads write
// distinct bank groups); otherwise one copy [S][C][g]
template <int S, bool ROUND>
__device__ __forceinline__ void stage_lut(float* s_lut, const float* lut_h, int g, int C,
                                          int R) {
  if ((g & 3) == 0) {
    const int G4 = g / 4;
    float4* rows = reinterpret_cast<float4*>(s_lut);
    for (int row = threadIdx.x; row < S * C * G4; row += K5_THREADS) {
      const int q = row % G4, c = (row / G4) % C, s = row / (G4 * C);
      const float* src = lut_h + ((size_t)(4 * q) * S + s) * C + c;
      const float4 v = make_float4(lut_entry<ROUND>(src[0]), lut_entry<ROUND>(src[S * C]),
                                   lut_entry<ROUND>(src[2 * S * C]),
                                   lut_entry<ROUND>(src[3 * S * C]));
      for (int r = 0; r < R; ++r) rows[row * R + (row + r) % R] = v;
    }
  } else {
    for (int i = threadIdx.x; i < g * S * C; i += K5_THREADS) {
      const int c = i % C, js = i / C;
      s_lut[((js % S) * C + c) * g + js / S] = lut_entry<ROUND>(lut_h[i]);
    }
  }
}

__device__ __forceinline__ int code_of(uint32_t cw, int i, int C) {
  return min((int)((cw >> (8 * i)) & 0xffu), C - 1);
}

// the scores of the n <= 4 tokens [t, t + n) for every q head, from their
// code words cw[s] (byte i: token t + i); subvector 0 first, the others
// added in order. `vec`: n == 4 and every score row 16-byte aligned
template <int S>
__device__ __forceinline__ void word_scores(const uint32_t (&cw)[S], const float* s_lut,
                                            int g, int C, int R, int copy, float* out_h,
                                            int T, int t, int n, bool vec) {
  if ((g & 3) == 0) {
    const float4* rows = reinterpret_cast<const float4*>(s_lut);
    const int G4 = g / 4;
    for (int q = 0; q < G4; ++q) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = rows[(code_of(cw[0], i, C) * G4 + q) * R + copy];
#pragma unroll
        for (int s = 1; s < S; ++s) {
          const float4 b = rows[((s * C + code_of(cw[s], i, C)) * G4 + q) * R + copy];
          a[i].x += b.x;
          a[i].y += b.y;
          a[i].z += b.z;
          a[i].w += b.w;
        }
      }
      float* o = out_h + (size_t)(4 * q) * T + t;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(a[0].x, a[1].x, a[2].x, a[3].x);
        *reinterpret_cast<float4*>(o + T) = make_float4(a[0].y, a[1].y, a[2].y, a[3].y);
        *reinterpret_cast<float4*>(o + 2 * (size_t)T) =
            make_float4(a[0].z, a[1].z, a[2].z, a[3].z);
        *reinterpret_cast<float4*>(o + 3 * (size_t)T) =
            make_float4(a[0].w, a[1].w, a[2].w, a[3].w);
      } else {
        for (int i = 0; i < n; ++i) {
          o[i] = a[i].x;
          o[T + i] = a[i].y;
          o[2 * (size_t)T + i] = a[i].z;
          o[3 * (size_t)T + i] = a[i].w;
        }
      }
    }
  } else {
    for (int j = 0; j < g; ++j) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = s_lut[code_of(cw[0], i, C) * g + j];
#pragma unroll
        for (int s = 1; s < S; ++s) a[i] += s_lut[(s * C + code_of(cw[s], i, C)) * g + j];
      }
      float* o = out_h + (size_t)j * T + t;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
      } else {
        for (int i = 0; i < n; ++i) o[i] = a[i];
      }
    }
  }
}

// copy the codes of the unit at token u0 into a warp buffer [S][K5_UNIT]:
// lane l the 16 bytes at u0 + 16 l of each subvector
template <int S>
__device__ __forceinline__ void copy_unit(uint8_t* buf, const uint8_t* codes_h, int T, int u0,
                                          int lane) {
  const int t0 = u0 + 16 * lane;
  if (t0 < T)
#pragma unroll
    for (int s = 0; s < S; ++s)
      cp_async16(buf + s * K5_UNIT + 16 * lane, codes_h + (size_t)s * T + t0);
}

// K5: grid (CTAs per folded head, Hf), K5_THREADS threads. Dynamic shared
// memory: the staged LUT (R copies when g % 4 == 0), then with VEC each
// warp's two code buffers [2][S][K5_UNIT]. Warp w of CTA b takes units
// b * K5_WARPS + w, stepping by the grid's warps per head. VEC: T % 16 == 0
// and 16-byte aligned codes and scores
template <int S, bool ROUND, bool VEC>
__global__ void __launch_bounds__(K5_THREADS, K5_WAVE_CTAS)
adc_scores_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                  int g, int C, int T, int R, float* __restrict__ out) {
  extern __shared__ __align__(16) float s_lut[];
  const int h = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_units = (T + K5_UNIT - 1) / K5_UNIT;
  const int step = (int)gridDim.x * K5_WARPS;
  int u = (int)blockIdx.x * K5_WARPS + warp;
  const uint8_t* codes_h = codes + (size_t)h * S * T;
  float* out_h = out + (size_t)h * g * T;
  const int n_lut = ((g & 3) == 0 ? R : 1) * g * S * C;
  uint8_t* bufs = reinterpret_cast<uint8_t*>(s_lut + ((n_lut + 3) & ~3)) +
                  (size_t)warp * 2 * S * K5_UNIT;
  if constexpr (VEC) {
    if (u < n_units) copy_unit<S>(bufs, codes_h, T, u * K5_UNIT, lane);
    cp_async_commit();
  }
  stage_lut<S, ROUND>(s_lut, lut + (size_t)h * g * S * C, g, C, R);
  __syncthreads();
  const int copy = lane % R;
  for (int b = 0; u < n_units; u += step, b ^= 1) {
    const uint8_t* buf = bufs + b * S * K5_UNIT;
    if constexpr (VEC) {
      if (u + step < n_units)
        copy_unit<S>(bufs + (b ^ 1) * S * K5_UNIT, codes_h, T, (u + step) * K5_UNIT, lane);
      cp_async_commit();
      cp_async_wait_prior();
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = u * K5_UNIT + 128 * k + 4 * lane;
      if (t >= T) continue;
      uint32_t cw[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if constexpr (VEC) {
          cw[s] = *reinterpret_cast<const uint32_t*>(buf + s * K5_UNIT + 128 * k + 4 * lane);
        } else {
          const uint8_t* p = codes_h + (size_t)s * T + t;
          cw[s] = 0u;
          for (int i = 0; i < 4 && t + i < T; ++i) cw[s] |= (uint32_t)p[i] << (8 * i);
        }
      }
      word_scores<S>(cw, s_lut, g, C, R, copy, out_h, T, t, min(4, T - t), VEC);
    }
    // every lane has read the buffer before the next unit's copies refill it
    if constexpr (VEC) __syncwarp();
  }
}

// byte i of a 16-byte code load: token i of the chunk
__device__ __forceinline__ int code_at(const uint4& w, int i) {
  const uint32_t x = i < 4 ? w.x : i < 8 ? w.y : i < 12 ? w.z : w.w;
  return (x >> (8 * (i & 3))) & 0xff;
}

// the S codes of tokens [t, t + TOK), 16 bytes per subvector; tokens at or
// past `end` read 0. `vec`: the 16 bytes are in range and aligned
template <int S>
__device__ __forceinline__ void load_chunk(uint4 (&c)[S], const uint8_t* codes,
                                           int T, int t, int end, bool vec) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const uint8_t* p = codes + (size_t)s * T + t;
    if (vec) {
      c[s] = *reinterpret_cast<const uint4*>(p);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < TOK; ++i)
        if (t + i < end) w[i / 4] |= (uint32_t)p[i] << (8 * (i % 4));
      c[s] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// fold the first n_valid tokens of a chunk into the running (max, exp-sum)
// of each q head, four tokens (one 32-bit word of codes per subvector) at a
// time, so that only 4 * S lookup indices are live at once
template <int S>
__device__ __forceinline__ void chunk_stats(const uint4 (&c)[S], const float* s_lut,
                                            int g, int C, int n_valid, float scale,
                                            float (&m)[MAX_G], float (&u)[MAX_G]) {
#pragma unroll
  for (int w = 0; w < TOK / 4; ++w) {
    if (4 * w >= n_valid) break;
    int idx[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) idx[s][i] = s * C + min(code_at(c[s], 4 * w + i), C - 1);
#pragma unroll
    for (int j = 0; j < MAX_G; ++j) {
      if (j >= g) break;
      const float* lj = s_lut + j * S * C;
      float sc[4];
      float mx = m[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = lj[idx[0][i]];
#pragma unroll
        for (int s = 1; s < S; ++s) a += lj[idx[s][i]];
        sc[i] = a * scale;
        if (4 * w + i < n_valid) mx = fmaxf(mx, sc[i]);
      }
      float add = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * w + i < n_valid) add += __expf(sc[i] - mx);
      u[j] = u[j] * __expf(m[j] - mx) + add;
      m[j] = mx;
    }
  }
}

// merge (mo, uo) into the running (max, exp-sum) (m, u); symmetric, so two
// lanes that merge each other's hold bitwise the same result
__device__ __forceinline__ void merge_stats(float& m, float& u, float mo, float uo) {
  const float mx = fmaxf(m, mo);
  u = u * __expf(m - mx) + uo * __expf(mo - mx);
  m = mx;
}

// K3: grid (CTAS, H_kv, B), cluster (CTAS, 1, 1), K3_THREADS threads.
// Dynamic shared memory (floats): the LUT [g*S*C] (rounded up to 4), the
// round's chunk stats im, iu [g][K3_THREADS], its block stats bm, bw
// [g][K3_THREADS], and each round's max rM [g][max_rounds]. A block's
// chunks are folded in groups of fw lanes by shuffles (fw: the largest
// power of two <= 32 that divides the chunks per block), then in shared
// memory.
template <int S>
__global__ void __launch_bounds__(K3_THREADS)
block_scores_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                    const int* __restrict__ n_cand_vec, int n_cand_scalar, int H_kv,
                    int g, int C, int T, int bs, int tpi, int fw, int vec,
                    int max_rounds, float scale, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float c_M[MAX_G], c_Z[MAX_G];   // the CTA's max and normaliser
  __shared__ float r_M[K3_MAX_CTAS][MAX_G], r_Z[K3_MAX_CTAS][MAX_G];   // all CTAs'
  __shared__ float f_M[MAX_G], f_Z[MAX_G];   // the row's
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ncta = (int)cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t hf = (size_t)b * H_kv + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NB = T / bs, cpb = (bs + tpi - 1) / tpi, bpr = K3_THREADS / cpb;
  const int epb = cpb / fw;                  // entries per block after the shuffles
  const int k0 = (int)((long long)NB * rank / ncta);
  const int k1 = (int)((long long)NB * (rank + 1) / ncta);
  const int nblk = k1 - k0, rounds = (nblk + bpr - 1) / bpr;
  const int hi = max(0, min(T, n_cand_vec ? n_cand_vec[b] : n_cand_scalar));
  const int n_lut = g * S * C;
  float* s_lut = sm;
  float* im = s_lut + ((n_lut + 3) & ~3);
  float* iu = im + g * K3_THREADS;
  float* bm = iu + g * K3_THREADS;
  float* bw = bm + g * K3_THREADS;
  float* rM = bw + g * K3_THREADS;
  const uint8_t* codes_h = codes + hf * S * T;
  if (tid < MAX_G) {
    c_M[tid] = MASKED;
    c_Z[tid] = 0.f;
  }
  cluster_arrive_relaxed();   // waited on before the first remote store

  for (int r = 0; r < rounds; ++r) {
    // this thread's chunk: tokens [t0, t_end) of one block, valid below t_hi
    const int kr0 = k0 + r * bpr, nb_r = min(bpr, k1 - kr0);
    const bool active = tid < nb_r * cpb;
    const int blk = kr0 + tid / cpb;
    const int t0 = blk * bs + (tid % cpb) * tpi;
    const int t_end = min(t0 + tpi, (blk + 1) * bs);
    const int t_hi = min(t_end, hi);
    uint4 c[S];
    if (active && t0 < t_hi) load_chunk<S>(c, codes_h, T, t0, t_end, vec);
    if (r == 0) {   // the LUT, while the first codes are on their way
      const float* lut_h = lut + hf * n_lut;
      if ((n_lut & 3) == 0 && (reinterpret_cast<uintptr_t>(lut_h) & 15) == 0)
        for (int i = tid; i < n_lut / 4; i += K3_THREADS)
          reinterpret_cast<float4*>(s_lut)[i] = reinterpret_cast<const float4*>(lut_h)[i];
      else
        for (int i = tid; i < n_lut; i += K3_THREADS) s_lut[i] = lut_h[i];
      __syncthreads();
    }
    float m[MAX_G], u[MAX_G];
#pragma unroll
    for (int j = 0; j < MAX_G; ++j) {
      m[j] = MASKED;
      u[j] = 0.f;
    }
    if (active) {
      for (int t = t0; t < t_hi; t += TOK) {
        if (t != t0) load_chunk<S>(c, codes_h, T, t, t_end, vec);
        chunk_stats<S>(c, s_lut, g, C, min(TOK, t_hi - t), scale, m, u);
      }
    }
    // fold groups of fw neighbouring chunks (one block's) by shuffles
#pragma unroll
    for (int j = 0; j < MAX_G; ++j) {
      if (j >= g) break;
      for (int o = 1; o < fw; o <<= 1)
        merge_stats(m[j], u[j], __shfl_xor_sync(0xffffffffu, m[j], o),
                    __shfl_xor_sync(0xffffffffu, u[j], o));
      if (active && tid % fw == 0) {
        im[j * K3_THREADS + tid / fw] = m[j];
        iu[j * K3_THREADS + tid / fw] = u[j];
      }
    }
    __syncthreads();
    if (warp < g) {   // warp j: the round's blocks for q head j
      const int j = warp;
      const float* cm = im + j * K3_THREADS;
      const float* cu = iu + j * K3_THREADS;
      float* jm = bm + j * K3_THREADS;
      float* jw = bw + j * K3_THREADS;
      float Mr = MASKED;
      for (int bl = lane; bl < nb_r; bl += 32) {
        float mb = cm[bl * epb], ub = cu[bl * epb];
        for (int k = 1; k < epb; ++k) merge_stats(mb, ub, cm[bl * epb + k], cu[bl * epb + k]);
        jm[bl] = mb;
        jw[bl] = ub;
        Mr = fmaxf(Mr, mb);
      }
      Mr = warp_max(Mr);
      float Zr = 0.f;
      float* orow = out + (hf * g + j) * NB + kr0;
      for (int bl = lane; bl < nb_r; bl += 32) {
        const float w = jw[bl] * __expf(jm[bl] - Mr);
        jw[bl] = w;
        Zr += w;
        if (r + 1 < rounds) orow[bl] = w;   // waits in the output
      }
      Zr = warp_sum(Zr);
      if (lane == 0) {
        rM[j * max_rounds + r] = Mr;
        merge_stats(c_M[j], c_Z[j], Mr, Zr);
      }
    }
    __syncthreads();
  }

  // every CTA's (M, Z) into every CTA's shared memory (distributed shared
  // memory, plain stores through the mapped address); one cluster barrier;
  // then each CTA takes the row's (M, Z) from its own copy, in rank order
  cluster_wait();             // every CTA of the cluster has started
  if (tid < ncta * g) {
    const int p = tid / g, j = tid % g;
    *cluster.map_shared_rank(&r_M[rank][j], p) = c_M[j];
    *cluster.map_shared_rank(&r_Z[rank][j], p) = c_Z[j];
  }
  cluster_arrive();
  cluster_wait();
  if (tid < g) {
    float M = MASKED, Z = 0.f;
    for (int p = 0; p < ncta; ++p) M = fmaxf(M, r_M[p][tid]);
    for (int p = 0; p < ncta; ++p) Z += r_Z[p][tid] * __expf(r_M[p][tid] - M);
    f_M[tid] = M;
    f_Z[tid] = fmaxf(Z, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < g * nblk; e += K3_THREADS) {
    const int j = e / nblk, bl = e % nblk, r = bl / bpr;
    float* o = out + (hf * g + j) * NB + k0 + bl;
    const float w = r + 1 < rounds ? *o : bw[j * K3_THREADS + bl - r * bpr];
    *o = w * __expf(rM[j * max_rounds + r] - f_M[j]) / f_Z[j];
  }
}

template <int S, bool RND, bool VEC>
cudaError_t scores_launch_vec(const float* lut, const uint8_t* codes, int Hf, int g,
                              int C, int T, float* out, cudaStream_t st) {
  auto kernel = adc_scores_kernel<S, RND, VEC>;
  // the LUT may take all the shared memory a block can opt in to: allowed
  // once per process and instantiation, so that a launch inside a CUDA-graph
  // capture makes no attribute call
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  const int lut_bytes = g * S * C * (int)sizeof(float);
  int R = 1;
  if ((g & 3) == 0)
    while (R < K5_COPIES && 2 * R * lut_bytes <= K5_COPIES_SMEM) R *= 2;
  const int smem = ((R * lut_bytes + 15) & ~15) + (VEC ? K5_WARPS * 2 * S * K5_UNIT : 0);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // CTAs per folded head: K5_WAVE_CTAS per SM over the grid, and no more
  // than keep every warp on at least one whole unit (at 8 heads and T 33024
  // that is 16, 1 per SM: on an H100 17 took 3.5 us against 3.1 with 16;
  // at 64 heads 8)
  const int n_units = (T + K5_UNIT - 1) / K5_UNIT;
  const int ctas = max(1, min(n_units / K5_WARPS, sm_count() * K5_WAVE_CTAS / Hf));
  kernel<<<dim3(ctas, Hf), K5_THREADS, smem, st>>>(lut, codes, g, C, T, R, out);
  return cudaGetLastError();
}

template <int S>
cudaError_t scores_launch(const float* lut, const uint8_t* codes, int Hf, int g, int C,
                          int T, int round_bf16, float* out, cudaStream_t st) {
  const bool vec = T % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
#define PQ_ARGS lut, codes, Hf, g, C, T, out, st
  if (round_bf16)
    return vec ? scores_launch_vec<S, true, true>(PQ_ARGS)
               : scores_launch_vec<S, true, false>(PQ_ARGS);
  return vec ? scores_launch_vec<S, false, true>(PQ_ARGS)
             : scores_launch_vec<S, false, false>(PQ_ARGS);
#undef PQ_ARGS
}

int last_block_ctas = 0;   // K3: CTAs per (slot, kv head) of the last launch

template <int S>
cudaError_t block_launch(const float* lut, const uint8_t* codes, const int* n_cand_vec,
                         int n_cand_scalar, int B, int H_kv, int g, int C, int T, int bs,
                         float scale, float* out, cudaStream_t st) {
  auto kernel = block_scores_kernel<S>;
  // once per process, so that a launch inside a CUDA-graph capture makes no
  // attribute call
  static const cudaError_t attr = allow_big_clusters(kernel);
  if (attr != cudaSuccess) return attr;
  const int NB = T / bs;
  // tokens per chunk: 16, or a multiple of 16 so that a block has at most
  // K3_THREADS chunks
  const int tpi = TOK * (((bs + TOK - 1) / TOK + K3_THREADS - 1) / K3_THREADS);
  const int cpb = (bs + tpi - 1) / tpi, bpr = K3_THREADS / cpb;
  const int fw = min(cpb & -cpb, 32);
  const int ctas = max(1, min(min(K3_MAX_CTAS, sm_count() / (B * H_kv)), NB));
  last_block_ctas = ctas;
  const int max_rounds = ((NB + ctas - 1) / ctas + bpr - 1) / bpr;
  const size_t smem = sizeof(float) * (((g * S * C + 3) & ~3) +
                                       4 * g * K3_THREADS + g * max_rounds);
  if (smem > (size_t)optin_smem() - 1024) return cudaErrorInvalidValue;
  const int vec = T % TOK == 0 && bs % TOK == 0 &&
                  reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  return launch_cluster(kernel, dim3(ctas, H_kv, B), K3_THREADS, smem, st, lut,
                        codes, n_cand_vec, n_cand_scalar, H_kv, g, C, T, bs, tpi,
                        fw, vec, max_rounds, scale, out);
}

}  // namespace

// K5. lut [Hf, g, S, C] f32, codes [Hf, S, T] uint8, out [Hf, g, T] f32, all
// contiguous; S in {1, 2, 4, 8, 16}, 1 <= C <= 256, g*S*C*4 bytes of LUT per
// CTA within shared memory; Hf <= 65535. Returns a cudaError_t (0 = launched).
extern "C" int pq_adc_scores(const float* lut, const uint8_t* codes, int Hf, int g, int S,
                             int C, int T, int round_bf16, float* out, void* stream) {
  if (Hf < 1 || Hf > 65535 || g < 1 || C < 1 || C > 256 || T < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return scores_launch<1>(lut, codes, Hf, g, C, T, round_bf16, out, st);
    case 2: return scores_launch<2>(lut, codes, Hf, g, C, T, round_bf16, out, st);
    case 4: return scores_launch<4>(lut, codes, Hf, g, C, T, round_bf16, out, st);
    case 8: return scores_launch<8>(lut, codes, Hf, g, C, T, round_bf16, out, st);
    case 16: return scores_launch<16>(lut, codes, Hf, g, C, T, round_bf16, out, st);
    default: return cudaErrorInvalidValue;
  }
}

// K3. lut [B, H_kv, g, S, C] f32, codes [B, H_kv, S, T] uint8 with
// T % sel_block == 0; n_cand_vec [B] int32, or null and then n_cand_scalar
// for every b; out [B, H_kv*g, T/sel_block] f32; all contiguous. g <= 8.
// One launch, which writes out and nothing else. Returns a cudaError_t
// (0 = launched).
extern "C" int pq_adc_block_scores(const float* lut, const uint8_t* codes,
                                   const int* n_cand_vec, int n_cand_scalar, int B,
                                   int H_kv, int g, int S, int C, int T, int sel_block,
                                   int head_dim, float* out, void* stream) {
  if (B < 1 || H_kv < 1 || g < 1 || g > MAX_G || C < 1 || C > 256 || sel_block < 1 ||
      T < sel_block || T % sel_block || head_dim < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)head_dim);
#define PQ_ARGS lut, codes, n_cand_vec, n_cand_scalar, B, H_kv, g, C, T, sel_block, \
                scale, out, st
  switch (S) {
    case 1: return block_launch<1>(PQ_ARGS);
    case 2: return block_launch<2>(PQ_ARGS);
    case 4: return block_launch<4>(PQ_ARGS);
    case 8: return block_launch<8>(PQ_ARGS);
    case 16: return block_launch<16>(PQ_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PQ_ARGS
}

// CTAs per (slot, kv head) that the last pq_adc_block_scores launch chose
extern "C" int pq_adc_block_scores_ctas() { return last_block_ctas; }
