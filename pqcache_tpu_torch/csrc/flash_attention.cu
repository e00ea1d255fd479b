// K2: causal GQA flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces pqcache_tpu/ops/flash_attention.py::flash_attention (the Pallas
// TPU kernels _flash_kernel_tri, packed causal grid, and _flash_kernel,
// rectangular grid). Same function: q [H, Tq, D] and k/v [H_kv, Tk, D] in
// bf16, f32 accumulation, logits x 1/sqrt(D); keys outside
// [valid_lo, valid_hi) are masked (left-padded prompts) and, when causal, a
// key at index > q_offset + q row is masked. Output is bf16. A row that sees
// no valid key writes 0 (finite NEG_INF, masked p = 0, acc / max(l, 1e-30)),
// as the TPU kernel does: a NaN there would poison the next layer.
//
// What bounds it: at prefill lengths the work is 2 * H * Tq * Tk_causal * D
// * 2 FLOPs on bf16 tensor cores (about 8.8 TFLOP per layer at 32k, 8.9 ms at
// 989 TFLOP/s), against 2 * (H + 2 * H_kv) * T * D bytes of input: far above
// the card's ~295 FLOP/byte ridge, so it is bound by tensor-core operations.
//
// Design (FlashAttention-2 shape, simple and right first): one CTA of four
// warps per (q head, 64-row q tile); each warp owns 16 q rows. The CTA walks
// the 64-key tiles from valid_lo up to the causal frontier (the loop replaces
// the TPU's packed pair list: unreachable tiles get no iteration), with
// cp.async double buffering of the K and V tiles in shared memory. QK^T and PV
// run as mma.sync m16n8k16 bf16 products with f32 accumulators; the online
// softmax (m, l, corr) lives in registers, and the S accumulator is repacked
// in registers as the A operand of PV. Heavy (late) q tiles launch first.
// wgmma / TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BM = 64;        // q rows per CTA
constexpr int BN = 64;        // keys per tile
constexpr int NTHREADS = 128; // 4 warps x 16 q rows
constexpr float NEG_INF = -1e30f;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                 int group, int Tq, int Tk, int valid_lo, int valid_hi,
                 int q_offset, int causal, float scale) {
  constexpr int LD = D + 8;  // padded smem row: conflict-free fragment loads
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;               // [BM][LD]
  uint16_t* sK = sQ + BM * LD;       // [2][BN][LD]
  uint16_t* sV = sK + 2 * BN * LD;   // [2][BN][LD]

  const int nqb = (Tq + BM - 1) / BM;
  const int m0 = (nqb - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int hk = h / group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = lane >> 2;        // fragment row within 8
  const int c0 = (lane & 3) * 2;   // fragment column pair

  const uint16_t* qh = q + (size_t)h * Tq * D;
  const uint16_t* kh = k + (size_t)hk * Tk * D;
  const uint16_t* vh = v + (size_t)hk * Tk * D;

  // keys [key_lo, key_hi) can be valid for some row of this tile
  const int key_lo = valid_lo;
  int key_hi = valid_hi;
  if (causal) key_hi = min(key_hi, q_offset + m0 + BM);
  const int j_lo = key_lo / BN;
  const int j_hi = key_lo < key_hi ? (key_hi + BN - 1) / BN : j_lo;

  for (int c = tid; c < BM * CH; c += NTHREADS) {
    const int r = c / CH, cc = c % CH, gr = m0 + r;
    const bool ok = gr < Tq;
    cp_async16(sQ + r * LD + cc * 8, qh + (size_t)(ok ? gr : 0) * D + cc * 8,
               ok);
  }
  auto load_kv = [&](int j, int stage) {
    uint16_t* dk = sK + stage * BN * LD;
    uint16_t* dv = sV + stage * BN * LD;
    for (int c = tid; c < BN * CH; c += NTHREADS) {
      const int r = c / CH, cc = c % CH, gr = j * BN + r;
      const bool ok = gr < Tk;
      const size_t off = (size_t)(ok ? gr : 0) * D + cc * 8;
      cp_async16(dk + r * LD + cc * 8, kh + off, ok);
      cp_async16(dv + r * LD + cc * 8, vh + off, ok);
    }
  };
  if (j_lo < j_hi) load_kv(j_lo, 0);
  cp_async_commit();

  const int wr = warp * 16;                   // warp's first row in the tile
  const int qrow[2] = {m0 + wr + r0, m0 + wr + r0 + 8};
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums
  uint32_t qf[D / 16][4];

  for (int j = j_lo; j < j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    if (j + 1 < j_hi) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == j_lo) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ld_frag_a(qf[kc], sQ + (wr + r0) * LD + kc * 16 + c0, LD);
    }
    const uint16_t* cK = sK + stage * BN * LD;
    const uint16_t* cV = sV + stage * BN * LD;

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const uint16_t* kb = cK + (nt * 8 + r0) * LD + kc * 16 + c0;
        uint32_t b[2] = {ld_u32(kb), ld_u32(kb + 8)};
        mma_bf16(s[nt], qf[kc], b);
      }
    }

    // scale + mask, running max
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BN + nt * 8 + c0 + (e & 1);
        const int row = qrow[e >> 1];
        const bool ok = col >= valid_lo && col < valid_hi &&
                        (!causal || col <= q_offset + row);
        s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      corr[i] = __expf(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked logits sit at NEG_INF; real ones are far above NEG_INF / 2
        const float p = s[nt][e] > 0.5f * NEG_INF
                            ? __expf(s[nt][e] - m_r[e >> 1]) : 0.f;
        s[nt][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V: the S accumulators of two n8 tiles form one A fragment
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                       pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                       pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                       pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint16_t* vb = cV + (kc * 16 + c0) * LD + r0;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const uint16_t* vp = vb + dt * 8;
        uint32_t b[2] = {
            (uint32_t)vp[0] | ((uint32_t)vp[LD] << 16),
            (uint32_t)vp[8 * LD] | ((uint32_t)vp[9 * LD] << 16)};
        mma_bf16(o[dt], a, b);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] >= Tq) continue;
    uint16_t* orow = out + ((size_t)h * Tq + qrow[i]) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + c0) =
          pack_bf16(o[dt][2 * i] * inv[i], o[dt][2 * i + 1] * inv[i]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int H, int H_kv, int Tq, int Tk, int valid_lo,
                   int valid_hi, int q_offset, int causal,
                   cudaStream_t stream) {
  constexpr int LD = D + 8;
  const size_t smem = (size_t)(BM + 4 * BN) * LD * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BM - 1) / BM, H);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out),
      H / H_kv, Tq, Tk, valid_lo, valid_hi, q_offset, causal,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q [H, Tq, D], k/v [H_kv, Tk, D], out [H, Tq, D]: contiguous bf16.
// 0 <= valid_lo, valid_hi <= Tk. Returns a cudaError_t (0 = launched).
extern "C" int pq_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int H, int H_kv, int Tq, int Tk,
                                  int D, int valid_lo, int valid_hi,
                                  int q_offset, int causal, void* stream) {
  if (Tq <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, H, H_kv, Tq, Tk, valid_lo, valid_hi,
                        q_offset, causal, s);
    case 128:
      return launch<128>(q, k, v, out, H, H_kv, Tq, Tk, valid_lo, valid_hi,
                         q_offset, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
