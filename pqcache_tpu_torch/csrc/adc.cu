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
// 4.23 MB of scores, 1.42 us at 3.35 TB/s.
//
// K5 design: the TPU kernel built a one-hot matrix and ran an MXU matmul, its
// way around a slow scalar gather. Here the lookup is direct: one CTA per
// (folded kv head, chunk of TOK_CTA tokens) stages that head's g*S*C LUT in
// shared memory (2 KB at the main shapes), and each thread takes tokens
// t = chunk + threadIdx.x + k*NTHREADS: it reads their S code bytes and writes
// g sums. Neighbouring threads take neighbouring t, so the code loads and the
// [.., g, T] score stores coalesce.
//
// K3 replaces pqcache_tpu/ops/adc_pallas.py::adc_block_scores_pallas and
// adc_block_scores_pallas_batched (_adc_block_call, body k2):
//   lut [B, H_kv, g, S, C] f32, codes [B, H_kv, S, T] uint8 (T % sel_block
//   == 0), n_cand [B] int32 or one scalar
//   -> per-q-head normalised block mass [B, H, T / sel_block] f32: ADC
//      scores x 1/sqrt(head_dim), tokens at or past n_cand masked, softmax
//      over the row, summed per sel_block block.
// What bounds K3: it reads the codes once (528 KB at the main shapes,
// ~0.16 us) and writes a few KB; bytes. Its two dependent launches cost more
// than that.
//
// K3 design: the TPU kernel carries a running max and per-block sums across
// its sequential grid. Hopper blocks run in no order, so the reduction takes
// two kernels. Pass 1: one CTA of NWARPS warps per (b, kv head, NWARPS
// blocks); a warp owns one sel_block block, computes its tokens' scores for
// the g q heads from the shared-memory LUT as K5 does, and writes the block's
// max m_b and sum u_b = sum exp(s - m_b) over its unmasked tokens (warp
// shuffles: deterministic). A block with no unmasked token writes m_b = -1e30,
// u_b = 0. Pass 2: one CTA per (b, q head) takes M = max m_b and writes
// u_b exp(m_b - M) / max(sum_b u_b exp(m_b - M), 1e-30), so a row with
// n_cand = 0 is all zeros. Everything is f32; the TPU kernel's bf16 rounding
// of p before its indicator matmul is not copied.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int TOK_CTA = 1024;          // K5 tokens per CTA
constexpr int NWARPS = 8;              // K3 pass 1: blocks per CTA
constexpr int MAX_G = 8;               // K3: q heads per kv head
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 227 * 1024;

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

// stage lut[0 : n] (one kv head's g*S*C entries) in shared memory
template <bool ROUND>
__device__ __forceinline__ void stage_lut(float* s_lut, const float* lut, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = lut[i];
    if (ROUND) v = __bfloat162float(__float2bfloat16_rn(v));
    s_lut[i] = v;
  }
  __syncthreads();
}

// the S codes of token t, clamped into the LUT
template <int S>
__device__ __forceinline__ void load_codes(int (&c)[S], const uint8_t* codes,
                                           int T, int t, int C) {
#pragma unroll
  for (int s = 0; s < S; ++s) c[s] = min((int)codes[(size_t)s * T + t], C - 1);
}

template <int S>
__device__ __forceinline__ float adc(const float* lj, const int (&c)[S], int C) {
  float acc = lj[c[0]];
#pragma unroll
  for (int s = 1; s < S; ++s) acc += lj[s * C + c[s]];
  return acc;
}

// grid (ceil(T / TOK_CTA), Hf), NTHREADS threads, g*S*C floats of shared memory
template <int S, bool ROUND>
__global__ void __launch_bounds__(NTHREADS)
adc_scores_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                  int g, int C, int T, float* __restrict__ out) {
  extern __shared__ float s_lut[];
  const int h = blockIdx.y;
  stage_lut<ROUND>(s_lut, lut + (size_t)h * g * S * C, g * S * C);
  const uint8_t* codes_h = codes + (size_t)h * S * T;
  float* out_h = out + (size_t)h * g * T;
  const int t0 = (int)blockIdx.x * TOK_CTA;
  const int t_end = min(T, t0 + TOK_CTA);
  for (int t = t0 + (int)threadIdx.x; t < t_end; t += NTHREADS) {
    int c[S];
    load_codes<S>(c, codes_h, T, t, C);
    for (int j = 0; j < g; ++j) out_h[(size_t)j * T + t] = adc<S>(s_lut + j * S * C, c, C);
  }
}

// K3 pass 1: grid (ceil(NB / NWARPS), H_kv, B), NTHREADS threads
template <int S>
__global__ void __launch_bounds__(NTHREADS)
block_pass1_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                   const int* __restrict__ n_cand_vec, int n_cand_scalar,
                   int H_kv, int g, int C, int T, int bs, int NB, float scale,
                   float* __restrict__ bm, float* __restrict__ bu) {
  extern __shared__ float s_lut[];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t hf = (size_t)b * H_kv + h;
  stage_lut<false>(s_lut, lut + hf * g * S * C, g * S * C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = (int)blockIdx.x * NWARPS + warp;
  if (blk >= NB) return;
  const int n_cand = n_cand_vec ? n_cand_vec[b] : n_cand_scalar;
  const int t_lo = blk * bs, t_hi = min(t_lo + bs, n_cand);
  const uint8_t* codes_h = codes + hf * S * T;

  float m[MAX_G], u[MAX_G];
#pragma unroll
  for (int j = 0; j < MAX_G; ++j) {
    m[j] = NEG_INF;
    u[j] = 0.f;
  }
  // sweep 1: the block's max per q head; sweep 2: sum of exp(s - max)
  for (int t = t_lo + lane; t < t_hi; t += 32) {
    int c[S];
    load_codes<S>(c, codes_h, T, t, C);
#pragma unroll
    for (int j = 0; j < MAX_G; ++j)
      if (j < g) m[j] = fmaxf(m[j], adc<S>(s_lut + j * S * C, c, C) * scale);
  }
#pragma unroll
  for (int j = 0; j < MAX_G; ++j) m[j] = warp_max(m[j]);
  for (int t = t_lo + lane; t < t_hi; t += 32) {
    int c[S];
    load_codes<S>(c, codes_h, T, t, C);
#pragma unroll
    for (int j = 0; j < MAX_G; ++j)
      if (j < g) u[j] += expf(adc<S>(s_lut + j * S * C, c, C) * scale - m[j]);
  }
#pragma unroll
  for (int j = 0; j < MAX_G; ++j) u[j] = warp_sum(u[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < MAX_G; ++j) {
      if (j >= g) break;
      const size_t o = (hf * g + j) * NB + blk;   // row b*H + h*g + j
      bm[o] = m[j];
      bu[o] = u[j];
    }
  }
}

// K3 pass 2: grid (H, B), NTHREADS threads; row = b*H + q head
__global__ void __launch_bounds__(NTHREADS)
block_pass2_kernel(const float* __restrict__ bm, const float* __restrict__ bu,
                   int H, int NB, float* __restrict__ out) {
  __shared__ float red[NTHREADS / 32];
  const size_t base = ((size_t)blockIdx.y * H + blockIdx.x) * NB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float mx = NEG_INF;
  for (int i = threadIdx.x; i < NB; i += NTHREADS) mx = fmaxf(mx, bm[base + i]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < NTHREADS / 32; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();

  float z = 0.f;
  for (int i = threadIdx.x; i < NB; i += NTHREADS)
    z += bu[base + i] * expf(bm[base + i] - mx);
  z = warp_sum(z);
  if (lane == 0) red[warp] = z;
  __syncthreads();
  z = 0.f;
#pragma unroll
  for (int w = 0; w < NTHREADS / 32; ++w) z += red[w];
  z = fmaxf(z, 1e-30f);
  for (int i = threadIdx.x; i < NB; i += NTHREADS)
    out[base + i] = bu[base + i] * expf(bm[base + i] - mx) / z;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return cudaSuccess;
}

template <int S>
cudaError_t scores_launch(const float* lut, const uint8_t* codes, int Hf, int g, int C,
                          int T, int round_bf16, float* out, cudaStream_t st) {
  const int smem = g * S * C * (int)sizeof(float);
  void (*kernel)(const float*, const uint8_t*, int, int, int, float*) =
      round_bf16 ? &adc_scores_kernel<S, true> : &adc_scores_kernel<S, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((T + TOK_CTA - 1) / TOK_CTA, Hf), NTHREADS, smem, st>>>(lut, codes, g, C, T, out);
  return cudaGetLastError();
}

template <int S>
cudaError_t block_launch(const float* lut, const uint8_t* codes, const int* n_cand_vec,
                         int n_cand_scalar, int B, int H_kv, int g, int C, int T, int bs,
                         float scale, float* bm, float* bu, float* out, cudaStream_t st) {
  const int NB = T / bs;
  const int smem = g * S * C * (int)sizeof(float);
  cudaError_t err = set_smem(block_pass1_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  block_pass1_kernel<S><<<dim3((NB + NWARPS - 1) / NWARPS, H_kv, B), NTHREADS, smem, st>>>(
      lut, codes, n_cand_vec, n_cand_scalar, H_kv, g, C, T, bs, NB, scale, bm, bu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  block_pass2_kernel<<<dim3(H_kv * g, B), NTHREADS, 0, st>>>(bm, bu, H_kv * g, NB, out);
  return cudaGetLastError();
}

}  // namespace

// K5. lut [Hf, g, S, C] f32, codes [Hf, S, T] uint8, out [Hf, g, T] f32, all
// contiguous; S in {1, 2, 4, 8, 16}, 1 <= C <= 256, g*S*C*4 bytes of LUT per
// CTA within shared memory. Returns a cudaError_t (0 = launched).
extern "C" int pq_adc_scores(const float* lut, const uint8_t* codes, int Hf, int g, int S,
                             int C, int T, int round_bf16, float* out, void* stream) {
  if (Hf < 1 || g < 1 || C < 1 || C > 256 || T < 1) return cudaErrorInvalidValue;
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
// for every b; scratch bm, bu and out [B, H_kv*g, T/sel_block] f32; all
// contiguous. g <= 8. Returns a cudaError_t (0 = launched).
extern "C" int pq_adc_block_scores(const float* lut, const uint8_t* codes,
                                   const int* n_cand_vec, int n_cand_scalar, int B,
                                   int H_kv, int g, int S, int C, int T, int sel_block,
                                   int head_dim, float* bm, float* bu, float* out,
                                   void* stream) {
  if (B < 1 || H_kv < 1 || g < 1 || g > MAX_G || C < 1 || C > 256 || sel_block < 1 ||
      T < sel_block || T % sel_block || head_dim < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)head_dim);
#define PQ_ARGS lut, codes, n_cand_vec, n_cand_scalar, B, H_kv, g, C, T, sel_block, \
                scale, bm, bu, out, st
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
