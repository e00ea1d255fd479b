// K4: per-key columns of the causal softmax for prefill, hand-written for
// Hopper (sm_90a) with wgmma, TMA and warp specialisation.
//
// Replaces pqcache_tpu/ops/flash_attention.py::flash_scores (the Pallas TPU
// kernel _score_kernel). Same function: q [H, T, D] and k [H_kv, T, D] in
// bf16, logits q.k / sqrt(D) accumulated in f32. A pair (q row, key) counts
// when both lie in [valid_lo, valid_hi) and key <= q row; p = exp(s - m_q) /
// max(l_q, 1e-30) with (m_q, l_q) the row's softmax max and sum. "sum" writes
// F[h, t] = sum over q of p(q, t); "max" writes max_q p(q, t) over pairs with
// t <= q - recent_cnt. F is [H, T] f32; a column that no pair reaches is 0.
//
// This file is the column pass. The row statistics (m, l) [H, T] come from
// K2 (flash_attention.cu): on the score-reading prefill path K2 writes them
// at the end of the same layer's attention, and a standalone call runs K2's
// stats-only mode first. A row's pairs are only evaluated where the row is
// valid, so a row written as one that sees no key (m = -1e30, l = 0) never
// reaches F.
//
// What bounds it: one causal K Q^T sweep, 2 * H * D * n (n + 1) / 2 FLOPs on
// bf16 tensor cores for n valid rows (4.19 TFLOP at H 32, D 128, n 32000:
// 4.24 ms at 989 TFLOP/s), and one exponential per pair, H n^2 / 2 = 1.6e10
// (about 4.2 ms at the special-function units' ~3.9e12/s): two co-bounds of
// the same size, so the exponentials of one warpgroup must run while the
// other's wgmma does, and nothing else may take the special-function units:
// a prep kernel folds each row's (m, l) into one base-2 log-sum-exp,
// lse2 = m log2 e + log2 max(l, 1e-30), so p = 2^(s log2 e / sqrt(D) -
// lse2) is one FFMA and one MUFU.EX2 per pair (no division, no second
// multiply). Bytes (q and k read, F written) are negligible.
//
// Design: the TPU grid turned around, deterministic, no atomics. One CTA
// of three warpgroups (two consumers and a producer, as in K2) owns one
// (q head, 128-key tile) and writes its F columns once; early key tiles see
// the most q tiles and launch first.
//  * The producer warpgroup (setmaxnreg.dec) has one thread load the K
//    tile once by TMA, then stream the q tiles of 128 rows, from the key
//    tile's diagonal to valid_hi, through a ring of STAGES stages with full
//    and empty mbarriers.
//  * The two consumer warpgroups each own 64 keys: the K tile is
//    the A operand, so S^T = K Q^T (wgmma m64n128k16, both operands in
//    shared memory) makes each key an accumulator row, and each key's
//    running column sum (or max) stays in two registers per thread across
//    the q tiles; one quad shuffle at the end finishes it. The q tile's
//    lse2 row (512 bytes) comes with it by a bulk copy on the same barrier.
//    The two warpgroups take turns at the tensor cores (ping-pong on two
//    named barriers), so one's exponentials run while the other's wgmma
//    does. (Two q tiles in flight within a warpgroup measured slower.)
//  * Masks (both ends in [valid_lo, valid_hi), key <= q, key <= q -
//    recent_cnt for "max") apply only on tiles that straddle a boundary.
// One template parameter selects "sum" or "max".

#include "mma_sm90.cuh"

namespace {

constexpr int BKEY = 128;      // keys per CTA: two consumer warpgroups x 64
constexpr int BQ = 128;        // q rows per streamed tile
constexpr int NTHREADS = 384;  // two consumer warpgroups + the producer

template <int D>
struct Cfg {
  static constexpr int STAGES = 4;
  static constexpr int K_BYTES = BKEY * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int L_BYTES = BQ * 4;   // the q tile's lse2
  static constexpr int SMEM =
      1024 + K_BYTES + STAGES * (Q_BYTES + L_BYTES) + 256;
};

// lse2[h, i] = m log2 e + log2 max(l, 1e-30) for i < T, 0 up to the padded
// row length ld (a multiple of BQ, so a q tile's reads stay in the row)
__global__ void lse2_kernel(const float* __restrict__ m,
                            const float* __restrict__ l,
                            float* __restrict__ lse2, int T, int ld) {
  const int h = blockIdx.y;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < ld;
       i += gridDim.x * blockDim.x) {
    const size_t r = (size_t)h * T + i;
    lse2[(size_t)h * ld + i] =
        i < T ? m[r] * LOG2E + log2f(fmaxf(l[r], 1e-30f)) : 0.f;
  }
}

// One consumer warpgroup's state (64 keys): thread (warp w, lane) holds the
// running column sums (or maxima) of keys key[0] and key[1] = key[0] + 8.
template <int D, bool MAX>
struct Consumer {
  static constexpr int S = Cfg<D>::STAGES;
  uint32_t sK, sQ, sL, bar;   // K tile, q ring, lse2 ring, mbarriers
  const float* lse;           // the lse2 ring (generic address)
  int cw, t, c0, kw0, i_lo, shift, valid_lo, valid_hi;
  int key[2];
  bool kok[2], key_edge;
  float sl2;
  float acc[2];

  __device__ uint32_t q_full(int s) const { return bar + 8 * (1 + s); }
  __device__ uint32_t q_empty(int s) const { return bar + 8 * (1 + S + s); }

  // S^T of q tile `it` into d (issued, not waited for)
  __device__ __forceinline__ void issue(float (&d)[BQ / 2], int it) {
    const int s = it % S;
    mbar_wait(q_full(s), (it / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(d, desc_kmajor<BKEY>(sK, 64 * cw, kk),
                    desc_kmajor<BQ>(sQ + s * Cfg<D>::Q_BYTES, 0, kk), kk > 0);
    wgmma_commit();
  }
  // once S^T of q tile `it` has landed: add its probabilities to the
  // running column sums (or maxima), then release its stage
  __device__ __forceinline__ void consume(float (&d)[BQ / 2], int it) {
    fence_regs(d);
    const int q0 = (i_lo + it) * BQ;
    const float* lq = lse + (it % S) * BQ + c0;
    // a pair fails a test only where the tile straddles valid_lo,
    // valid_hi, or key + shift > q
    const bool edge = key_edge || q0 < valid_lo || q0 + BQ > valid_hi ||
                      kw0 + 63 + shift > q0;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = ex2(fmaf(d[4 * j + e], sl2, -lq[8 * j + (e & 1)]));
        if (edge) {
          const int q = q0 + 8 * j + c0 + (e & 1);
          const bool ok = kok[i] && q >= valid_lo && q < valid_hi &&
                          key[i] + shift <= q;
          p = ok ? p : 0.f;
        }
        acc[i] = MAX ? fmaxf(acc[i], p) : acc[i] + p;
      }
    }
    __syncwarp();
    if (t % 32 == 0) mbar_arrive(q_empty(it % S));
  }
};

template <int D, bool MAX>
__global__ void __launch_bounds__(NTHREADS, 1)
column_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const float* __restrict__ lse2, float* __restrict__ f_out,
              int group, int T, int ld, int valid_lo, int valid_hi,
              int recent_cnt, float scale) {
  using C = Cfg<D>;
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Consumer<D, MAX> c;     // the consumers fill in the rest
  c.sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  c.sQ = c.sK + C::K_BYTES;                    // S tiles
  c.sL = c.sQ + S * C::Q_BYTES;                // S x BQ floats
  c.bar = c.sL + S * C::L_BYTES;               // k_full, then the ring's
  c.lse = reinterpret_cast<const float*>(smem_raw + c.sL -
                                         smem_u32(smem_raw));
  const uint32_t k_full = c.bar;

  const int h = blockIdx.x, hk = h / group;
  const int k0 = blockIdx.y * BKEY;
  c.shift = MAX ? recent_cnt : 0;
  // q rows that can pair with a key of this tile: [q_first, valid_hi)
  const bool keys = k0 + BKEY > valid_lo && k0 < valid_hi;
  const int q_first = max(k0 + c.shift, valid_lo);
  c.i_lo = q_first / BQ;
  const int n =
      keys && q_first < valid_hi ? (valid_hi + BQ - 1) / BQ - c.i_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(k_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(c.q_full(s), 1);
      mbar_init(c.q_empty(s), 8);  // one arrival per consumer warp
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
      mbar_expect_tx(k_full, C::K_BYTES);
      tma_tile<D, BKEY>(c.sK, &tm_k, k_full, k0, hk);
      for (int it = 0; it < n; ++it) {
        const int s = it % S;
        const uint32_t ph = (it / S) & 1;
        const int q0 = (c.i_lo + it) * BQ;
        mbar_wait(c.q_empty(s), ph ^ 1);
        mbar_expect_tx(c.q_full(s), C::Q_BYTES + C::L_BYTES);
        tma_tile<D, BQ>(c.sQ + s * C::Q_BYTES, &tm_q, c.q_full(s), q0, h);
        bulk_load(c.sL + s * C::L_BYTES, lse2 + (size_t)h * ld + q0,
                  C::L_BYTES, c.q_full(s));
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int lane = t % 32;
    c.cw = wg;                               // which 64 keys of the tile
    c.t = t;
    c.c0 = 2 * (lane % 4);
    c.kw0 = k0 + 64 * c.cw;                      // first key here
    c.valid_lo = valid_lo;
    c.valid_hi = valid_hi;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      c.key[i] = c.kw0 + 16 * (t / 32) + lane / 4 + 8 * i;
      c.kok[i] = c.key[i] >= valid_lo && c.key[i] < valid_hi;
      c.acc[i] = 0.f;
    }
    c.key_edge = c.kw0 < valid_lo || c.kw0 + 64 > valid_hi;
    c.sl2 = scale * LOG2E;
    if (n > 0) mbar_wait(k_full, 0);

    // Ping-pong, as in K2: the warpgroups take turns to issue their
    // products (named barriers 1 and 2), so one's exponentials run while
    // the other's wgmma does; every bar.sync meets exactly one arrival.
    float sc[BQ / 2];
    if (n > 0 && c.cw == 1) named_bar_arrive(1, 256);
    for (int it = 0; it < n; ++it) {
      named_bar_sync(1 + c.cw, 256);
      c.issue(sc, it);
      if (!(it == n - 1 && c.cw == 1)) named_bar_arrive(2 - c.cw, 256);
      wgmma_wait<0>();
      c.consume(sc, it);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float a = c.acc[i];
      const float a1 = __shfl_xor_sync(0xffffffffu, a, 1);
      a = MAX ? fmaxf(a, a1) : a + a1;
      const float a2 = __shfl_xor_sync(0xffffffffu, a, 2);
      a = MAX ? fmaxf(a, a2) : a + a2;
      if ((lane & 3) == 0 && c.key[i] < T)
        f_out[(size_t)h * T + c.key[i]] = a;
    }
  }
}

template <int D, bool MAX>
cudaError_t launch(const void* q, const void* k, const float* m,
                   const float* l, float* lse2, float* f, int H, int H_kv,
                   int T, int valid_lo, int valid_hi, int recent_cnt,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  // once per process, so that a launch inside a CUDA-graph capture makes
  // no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      column_kernel<D, MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk;
  cudaError_t e = make_tmap(&tq, q, H, T, D, BQ);
  if (e == cudaSuccess) e = make_tmap(&tk, k, H_kv, T, D, BKEY);
  if (e != cudaSuccess) return e;
  const int ld = (T + BQ - 1) / BQ * BQ;
  lse2_kernel<<<dim3((ld + 255) / 256, H), 256, 0, stream>>>(m, l, lse2, T,
                                                              ld);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(H, (T + BKEY - 1) / BKEY);
  column_kernel<D, MAX><<<grid, NTHREADS, C::SMEM, stream>>>(
      tq, tk, lse2, f, H / H_kv, T, ld, valid_lo, valid_hi, recent_cnt,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const float* m,
                     const float* l, float* lse2, float* f, int H, int H_kv,
                     int T, int valid_lo, int valid_hi, int max_mode,
                     int recent_cnt, cudaStream_t s) {
  return max_mode ? launch<D, true>(q, k, m, l, lse2, f, H, H_kv, T,
                                    valid_lo, valid_hi, recent_cnt, s)
                  : launch<D, false>(q, k, m, l, lse2, f, H, H_kv, T,
                                     valid_lo, valid_hi, recent_cnt, s);
}

}  // namespace

// q [H, T, D], k [H_kv, T, D]: contiguous bf16, 16-byte aligned; the row
// statistics m, l [H, T] f32 (K2's contract); lse2, scratch of H *
// round_up(T, 128) f32, 8-byte aligned; f, the output, [H, T] f32.
// 0 <= valid_lo, valid_hi <= T; max_mode 0 = "sum", 1 = "max". Returns a
// cudaError_t (0 = launched).
extern "C" int pq_flash_scores(const void* q, const void* k, const void* m,
                               const void* l, void* lse2, void* f, int H,
                               int H_kv, int T, int D, int valid_lo,
                               int valid_hi, int max_mode, int recent_cnt,
                               void* stream) {
  if (T <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* sf = static_cast<float*>(lse2);
  float* ff = static_cast<float*>(f);
  switch (D) {
    case 64:
      return dispatch<64>(q, k, mf, lf, sf, ff, H, H_kv, T, valid_lo,
                          valid_hi, max_mode, recent_cnt, s);
    case 128:
      return dispatch<128>(q, k, mf, lf, sf, ff, H, H_kv, T, valid_lo,
                           valid_hi, max_mode, recent_cnt, s);
    default:
      return cudaErrorInvalidValue;
  }
}
