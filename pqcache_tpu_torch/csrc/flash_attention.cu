// K2: causal GQA flash attention for prefill, hand-written for Hopper (sm_90a)
// with wgmma, TMA and warp specialisation.
//
// Replaces pqcache_tpu/ops/flash_attention.py::flash_attention (the Pallas
// TPU kernels _flash_kernel_tri, packed causal grid, and _flash_kernel,
// rectangular grid). Same function: q [H, Tq, D] and k/v [H_kv, Tk, D] in
// bf16, f32 accumulation, logits x 1/sqrt(D); keys outside
// [valid_lo, valid_hi) are masked (left-padded prompts) and, when causal, a
// key at index > q_offset + q row is masked. Output is bf16. A row that sees
// no valid key writes 0 (acc / max(l, 1e-30) with l = 0), as the TPU kernel
// does: a NaN there would poison the next layer.
//
// Row statistics (optional, m and l [H, Tq] f32): m is the row max of the
// scaled logit s / sqrt(D) in natural units, l = sum exp(s / sqrt(D) - m)
// over the row's valid keys; a row that sees no key, and every row whose
// position q_offset + row lies outside [valid_lo, valid_hi), is written as
// m = -1e30, l = 0. K4 (flash_scores.cu) reads them. Without v the kernel
// runs in stats-only mode: no P V, no output.
//
// What bounds it: the work is 2 * H * D * n (n + 1) / 2 * 2 FLOPs on bf16
// tensor cores for n valid causal rows (8.39 TFLOP per layer at H 32, D 128,
// n 32000: 8.48 ms at 989 TFLOP/s), against 2 * (2 H + 2 H_kv) * T * D bytes
// of input and output: far above the card's ~295 FLOP/byte ridge, so it is
// bound by tensor-core operations. Next come the exponentials, H n^2 / 2 =
// 1.6e10 per layer: about 4 ms at the ~3.9e12/s of the special-function
// units, so they must overlap the matrix products.
//
// Design (FlashAttention-3 shape):
//  * One CTA of three warpgroups per (q head, 128-row q tile); heavy (late)
//    tiles launch first, every head's at once. Warpgroups 0 and 1 are the
//    consumers, each owning 64 q rows; their work interleaves on the SM, so
//    one warpgroup's softmax overlaps the other's wgmma. Warpgroup 2 is the
//    producer: one thread issues the TMA loads, Q once, then the K and V
//    tiles of 128 keys through a ring of STAGES stages with full and empty
//    mbarriers (K and V separately, so Q K^T starts while V is in flight).
//    The producer drops to 40 registers (setmaxnreg.dec) and the consumers
//    ask for 232 (setmaxnreg.inc), but ptxas still allocates the consumer
//    code within the 168 a thread of a 12-warp CTA gets at launch (its
//    SASS names no register above R165), so a consumer holds one S tile
//    (64 f32), O (64 f32) and P (32 bf16 pairs) at a time:
//    FlashAttention-3's intra-warpgroup overlap (the next tile's Q K^T in
//    flight during this tile's softmax) needs more and spilled.
//  * S = Q K^T by wgmma m64n128k16 with both operands in shared memory
//    (128-byte swizzle, two 64-column boxes for D = 128).
//  * Online softmax in registers in base 2 (scale * log2 e folded into one
//    FFMA per element, MUFU.EX2). The element mask is applied only on tiles
//    that straddle valid_lo, valid_hi / Tk or the causal frontier; interior
//    tiles take no per-element test (the counterpart of the TPU kernel's
//    `msk` pairs).
//  * O += P V by wgmma with P packed to bf16 in registers as the A operand
//    and V read MN-major from its row-major [keys, D] tile through the
//    transpose-B immediate: no transpose copy.
//  * Epilogue: O / max(l, 1e-30) in bf16, stored from registers; optionally
//    (m, l).
// Window variant (flash_fwd_window_kernel, a sliding layer's prefill): a key
// at index <= q_offset + row - window is masked too. A CTA starts at the key
// tile that holds its first row's lowest key, so the tiles wholly below its
// band are never loaded, and masks by element only the tiles that straddle
// the band's lower edge (besides those of the bounds above). Both kernels
// are one body, flash_fwd<D, PV, WIN>: WIN false compiles to the kernel
// without the bound.
// The shared-memory attribute is set once per process, so a launch inside a
// CUDA-graph capture makes no attribute call. Tried on the H100 at T 32768
// and slower than this loop: ping-pong turns of the two consumers at the
// tensor cores (which K4 takes), P V of tile j - 1 issued with S of tile j,
// and a ring of 3 stages. A persistent tile scheduler is later work.

#include "mma_sm90.cuh"

namespace {

constexpr int BM = 128;        // q rows per CTA: two consumer warpgroups x 64
constexpr int BN = 128;        // keys per K / V tile
constexpr int NTHREADS = 384;  // two consumer warpgroups + the producer
constexpr float NO_KEY_M = -1e30f;

// D: the q and k width; DV: the v width (D but in the MLA variant)
template <int D, int DV = D>
struct Cfg {
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // a K tile
  static constexpr int V_BYTES = BN * DV * 2;     // a V tile
  // 1024 bytes of slack to align the base, Q, the K and V rings, barriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * (KV_BYTES + V_BYTES) + 256;
};

// Shared-memory layout of one CTA: Q, the K and V rings, the mbarriers.
template <int D, int DV = D>
struct Smem {
  using C = Cfg<D, DV>;
  static constexpr int S = C::STAGES;
  uint32_t q, k, v, bar;
  Smem() = default;
  __device__ explicit Smem(uint32_t base)
      : q(base), k(base + C::Q_BYTES),
        v(k + S * C::KV_BYTES), bar(v + S * C::V_BYTES) {}
  __device__ uint32_t k_tile(int s) const { return k + s * C::KV_BYTES; }
  __device__ uint32_t v_tile(int s) const { return v + s * C::V_BYTES; }
  __device__ uint32_t q_full() const { return bar; }
  __device__ uint32_t k_full(int s) const { return bar + 8 * (1 + s); }
  __device__ uint32_t k_empty(int s) const { return bar + 8 * (1 + S + s); }
  __device__ uint32_t v_full(int s) const { return bar + 8 * (1 + 2 * S + s); }
  __device__ uint32_t v_empty(int s) const {
    return bar + 8 * (1 + 3 * S + s);
  }
};

// One consumer warpgroup's state (64 q rows): the O accumulator, the S / P
// tile, P in bf16 as the register A operand of P V, and the online-softmax
// running max and sum. Thread (warp w, lane) holds rows r and r + 8.
template <int D, bool WIN, int DV = D>
struct Consumer {
  static constexpr int S = Cfg<D, DV>::STAGES;
  Smem<D, DV> sm;
  int cw, t, r, c0, pos_lo, j_lo, valid_lo, valid_hi, q_offset, causal,
      window;
  float sl2;
  float o[DV / 2];
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];
  float m_r[2], l_r[2], corr[2];

  // S = Q K^T of key tile `it` into sc (issued, not waited for)
  __device__ __forceinline__ void issue_s(int it) {
    const int s = it % S;
    mbar_wait(sm.k_full(s), (it / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(sc, desc_kmajor<BM>(sm.q, 64 * cw, kk),
                    desc_kmajor<BN>(sm.k_tile(s), 0, kk), kk > 0);
    wgmma_commit();
  }
  // O += P V of key tile `it` from pa (issued, not waited for)
  __device__ __forceinline__ void issue_pv(int it) {
    const int s = it % S;
    mbar_wait(sm.v_full(s), (it / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_tb<DV>(o, pa[kk], desc_mnmajor<BN>(sm.v_tile(s), kk));
    wgmma_commit();
  }
  // once S of key tile `it` has landed: release its K stage, mask, update
  // the running max and sum, and turn sc into P (f32)
  __device__ __forceinline__ void softmax(int it) {
    fence_regs(sc);
    if (t == 0) mbar_arrive(sm.k_empty(it % S));
    const int kb = (j_lo + it) * BN;
    // a row of these 64 sees keys down to pos - window + 1: the tile
    // straddles the band's lower edge if it holds a key at or below
    // pos_lo + 63 - window
    if (kb < valid_lo || kb + BN > valid_hi ||
        (causal && kb + BN - 1 > pos_lo) ||
        (WIN && kb <= pos_lo + 63 - window)) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kb + 8 * j + c0 + (e & 1);
          const int pos = q_offset + r + 8 * (e >> 1);
          if (col < valid_lo || col >= valid_hi || (causal && col > pos) ||
              (WIN && col <= pos - window))
            sc[4 * j + e] = NEG_INF;
        }
      }
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
    float ms[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row with no key so far keeps max -inf: subtract 0, p = 0
      ms[i] = mx[i] == NEG_INF ? 0.f : mx[i] * sl2;
      corr[i] = ex2(m_r[i] * sl2 - ms[i]);
      m_r[i] = mx[i];
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[4 * j + e], sl2, -ms[e >> 1]));
        sc[4 * j + e] = p;
        l_r[e >> 1] += p;
      }
    }
  }
  // rescale O by the new max, pack P to bf16
  __device__ __forceinline__ void rescale_pack() {
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      o[4 * i] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    // keys [16kk, 16kk + 16) are the accumulator's n8 blocks 2kk, 2kk + 1
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }
  // wait for P V of key tile `it`, then release its V stage
  __device__ __forceinline__ void pv_done(int it) {
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (t == 0) mbar_arrive(sm.v_empty(it % S));
  }
};

template <int D, bool PV, bool WIN, int DV = D>
__device__ __forceinline__ void flash_fwd(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    uint16_t* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int group, int Tq, int valid_lo, int valid_hi,
    int q_offset, int causal, float scale, int window) {
  using C = Cfg<D, DV>;
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Smem<D, DV> sm((smem_u32(smem_raw) + 1023) & ~1023u);

  const int h = blockIdx.x, hk = h / group;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  // keys [valid_lo, key_hi) can be valid for some row of this tile; in
  // stats-only mode a tile whose rows all lie outside [valid_lo, valid_hi)
  // has nothing to compute
  int key_hi = valid_hi;
  if (causal) key_hi = min(key_hi, q_offset + m0 + BM);
  // with a window, no row of the tile sees a key below its first row's
  // band
  const int key_lo = WIN ? max(valid_lo, q_offset + m0 - window + 1)
                         : valid_lo;
  const bool rows =
      PV || (q_offset + m0 + BM > valid_lo && q_offset + m0 < valid_hi);
  const int j_lo = key_lo / BN;
  const int n = rows && key_lo < key_hi ? (key_hi + BN - 1) / BN - j_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(sm.k_full(s), 1);
      mbar_init(sm.k_empty(s), 2);   // one arrival per consumer warpgroup
      mbar_init(sm.v_full(s), 1);
      mbar_init(sm.v_empty(s), 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer
  const int t = threadIdx.x % 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (t == 0 && n > 0) {
      mbar_expect_tx(sm.q_full(), C::Q_BYTES);
      tma_tile<D, BM>(sm.q, tm_q, sm.q_full(), m0, h);
      for (int it = 0; it < n; ++it) {
        const int s = it % S;
        const uint32_t ph = (it / S) & 1;
        const int row = (j_lo + it) * BN;
        mbar_wait(sm.k_empty(s), ph ^ 1);
        mbar_expect_tx(sm.k_full(s), C::KV_BYTES);
        tma_tile<D, BN>(sm.k_tile(s), tm_k, sm.k_full(s), row, hk);
        if constexpr (PV) {
          mbar_wait(sm.v_empty(s), ph ^ 1);
          mbar_expect_tx(sm.v_full(s), C::V_BYTES);
          tma_tile<DV, BN>(sm.v_tile(s), tm_v, sm.v_full(s), row, hk);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int lane = t % 32;
    Consumer<D, WIN, DV> c;
    c.sm = sm;
    c.cw = wg;                               // which 64 rows of the tile
    c.t = t;
    c.r = m0 + 64 * c.cw + 16 * (t / 32) + lane / 4;
    c.c0 = 2 * (lane % 4);
    c.pos_lo = q_offset + m0 + 64 * c.cw;        // first row position here
    c.j_lo = j_lo;
    c.valid_lo = valid_lo;
    c.valid_hi = valid_hi;
    c.q_offset = q_offset;
    c.causal = causal;
    c.window = window;
    c.sl2 = scale * LOG2E;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) c.o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      c.m_r[i] = NEG_INF;   // running max of raw logits
      c.l_r[i] = 0.f;       // per-thread partial row sums
    }
    if (n > 0) mbar_wait(sm.q_full(), 0);

    for (int it = 0; it < n; ++it) {
      c.issue_s(it);
      wgmma_wait<0>();
      c.softmax(it);
      if constexpr (PV) {
        c.rescale_pack();
        c.issue_pv(it);
        c.pv_done(it);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      c.l_r[i] += __shfl_xor_sync(0xffffffffu, c.l_r[i], 1);
      c.l_r[i] += __shfl_xor_sync(0xffffffffu, c.l_r[i], 2);
    }
    if constexpr (PV) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = c.r + 8 * i;
        if (row >= Tq) continue;
        const float inv = 1.f / fmaxf(c.l_r[i], 1e-30f);
        uint16_t* orow = out + ((size_t)h * Tq + row) * DV + c.c0;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(
              c.o[4 * j + 2 * i] * inv, c.o[4 * j + 2 * i + 1] * inv);
      }
    }
    if (m_out != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = c.r + 8 * i, pos = q_offset + row;
        if (row >= Tq) continue;
        const bool seen =
            pos >= valid_lo && pos < valid_hi && c.m_r[i] != NEG_INF;
        m_out[(size_t)h * Tq + row] = seen ? c.m_r[i] * scale : NO_KEY_M;
        l_out[(size_t)h * Tq + row] = seen ? c.l_r[i] : 0.f;
      }
    }
  }
}

template <int D, bool PV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 uint16_t* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int group, int Tq, int valid_lo,
                 int valid_hi, int q_offset, int causal, float scale) {
  flash_fwd<D, PV, false>(&tm_q, &tm_k, &tm_v, out, m_out, l_out, group, Tq,
                          valid_lo, valid_hi, q_offset, causal, scale, 0);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_window_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        uint16_t* __restrict__ out, int group, int Tq,
                        int valid_lo, int valid_hi, int q_offset, float scale,
                        int window) {
  flash_fwd<D, true, true>(&tm_q, &tm_k, &tm_v, out, nullptr, nullptr, group,
                           Tq, valid_lo, valid_hi, q_offset, 1, scale,
                           window);
}

// The MLA variant (MLA's expanded prefill heads): q and k D wide, v DV,
// logits times `scale`, causal or not, no statistics
template <int D, int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_dv_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    uint16_t* __restrict__ out, int group, int Tq, int valid_lo,
                    int valid_hi, int q_offset, int causal, float scale) {
  flash_fwd<D, true, false, DV>(&tm_q, &tm_k, &tm_v, out, nullptr, nullptr,
                                group, Tq, valid_lo, valid_hi, q_offset,
                                causal, scale, 0);
}

template <int D, int DV>
cudaError_t launch_dv(const void* q, const void* k, const void* v, void* out,
                      int H, int H_kv, int Tq, int Tk, int valid_lo,
                      int valid_hi, int q_offset, int causal, float scale,
                      cudaStream_t stream) {
  using C = Cfg<D, DV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_dv_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  cudaError_t e = make_tmap(&tq, q, H, Tq, D, BM);
  if (e == cudaSuccess) e = make_tmap(&tk, k, H_kv, Tk, D, BN);
  if (e == cudaSuccess) e = make_tmap(&tv, v, H_kv, Tk, DV, BN);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, (Tq + BM - 1) / BM);
  flash_fwd_dv_kernel<D, DV><<<grid, NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(out), H / H_kv, Tq, valid_lo,
      valid_hi, q_offset, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_window(const void* q, const void* k, const void* v,
                          void* out, int H, int H_kv, int Tq, int Tk,
                          int valid_lo, int valid_hi, int q_offset,
                          int window, cudaStream_t stream) {
  using C = Cfg<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_window_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  cudaError_t e = make_tmap(&tq, q, H, Tq, D, BM);
  if (e == cudaSuccess) e = make_tmap(&tk, k, H_kv, Tk, D, BN);
  if (e == cudaSuccess) e = make_tmap(&tv, v, H_kv, Tk, D, BN);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, (Tq + BM - 1) / BM);
  flash_fwd_window_kernel<D><<<grid, NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(out), H / H_kv, Tq, valid_lo,
      valid_hi, q_offset, 1.0f / sqrtf((float)D), window);
  return cudaGetLastError();
}

template <int D, bool PV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* m, float* l, int H, int H_kv, int Tq, int Tk,
                   int valid_lo, int valid_hi, int q_offset, int causal,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  // once per process, so that a launch inside a CUDA-graph capture makes
  // no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D, PV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  cudaError_t e = make_tmap(&tq, q, H, Tq, D, BM);
  if (e == cudaSuccess) e = make_tmap(&tk, k, H_kv, Tk, D, BN);
  if (e == cudaSuccess) e = PV ? make_tmap(&tv, v, H_kv, Tk, D, BN) : e;
  if (e != cudaSuccess) return e;
  if (!PV) tv = tk;  // not read
  const dim3 grid(H, (Tq + BM - 1) / BM);
  flash_fwd_kernel<D, PV><<<grid, NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(out), m, l, H / H_kv, Tq, valid_lo,
      valid_hi, q_offset, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* m, float* l, int H, int H_kv, int Tq, int Tk,
                     int valid_lo, int valid_hi, int q_offset, int causal,
                     cudaStream_t s) {
  return v ? launch<D, true>(q, k, v, out, m, l, H, H_kv, Tq, Tk, valid_lo,
                             valid_hi, q_offset, causal, s)
           : launch<D, false>(q, k, v, out, m, l, H, H_kv, Tq, Tk, valid_lo,
                              valid_hi, q_offset, causal, s);
}

}  // namespace

// q [H, Tq, D], k/v [H_kv, Tk, D], out [H, Tq, D]: contiguous bf16, 16-byte
// aligned; m, l [H, Tq] f32 or both null. v = null runs the stats-only mode
// (out unused, m and l required). 0 <= valid_lo, valid_hi <= Tk, Tk >= 1.
// Returns a cudaError_t (0 = launched).
extern "C" int pq_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, void* m, void* l, int H, int H_kv,
                                  int Tq, int Tk, int D, int valid_lo,
                                  int valid_hi, int q_offset, int causal,
                                  void* stream) {
  if (Tq <= 0) return cudaSuccess;
  if (Tk <= 0 || (m == nullptr) != (l == nullptr) || (!v && !m))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  switch (D) {
    case 64:
      return dispatch<64>(q, k, v, out, mf, lf, H, H_kv, Tq, Tk, valid_lo,
                          valid_hi, q_offset, causal, s);
    case 128:
      return dispatch<128>(q, k, v, out, mf, lf, H, H_kv, Tq, Tk, valid_lo,
                           valid_hi, q_offset, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The window variant of pq_flash_attention (causal, no row statistics): a
// key at index <= q_offset + row - window is masked too; window >= 1.
extern "C" int pq_flash_attention_window(const void* q, const void* k,
                                         const void* v, void* out, int H,
                                         int H_kv, int Tq, int Tk, int D,
                                         int valid_lo, int valid_hi,
                                         int q_offset, int window,
                                         void* stream) {
  if (Tq <= 0) return cudaSuccess;
  if (Tk <= 0 || window < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_window<64>(q, k, v, out, H, H_kv, Tq, Tk, valid_lo,
                               valid_hi, q_offset, window, s);
    case 128:
      return launch_window<128>(q, k, v, out, H, H_kv, Tq, Tk, valid_lo,
                                valid_hi, q_offset, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The MLA variant of pq_flash_attention (no row statistics): q, k [., D]
// and v, out [., Dv] with (D, Dv) = (192, 128), logits times `scale`.
extern "C" int pq_flash_attention_dv(const void* q, const void* k,
                                     const void* v, void* out, int H,
                                     int H_kv, int Tq, int Tk, int D, int Dv,
                                     int valid_lo, int valid_hi, int q_offset,
                                     int causal, float scale, void* stream) {
  if (Tq <= 0) return cudaSuccess;
  if (Tk <= 0 || !v) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 192 && Dv == 128)
    return launch_dv<192, 128>(q, k, v, out, H, H_kv, Tq, Tk, valid_lo,
                               valid_hi, q_offset, causal, scale, s);
  return cudaErrorInvalidValue;
}
