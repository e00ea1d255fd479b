// K4: per-key columns of the causal softmax for prefill, hand-written for
// Hopper (sm_90a).
//
// Replaces pqcache_tpu/ops/flash_attention.py::flash_scores (the Pallas TPU
// kernel _score_kernel). Same function: q [H, T, D] and k [H_kv, T, D] in
// bf16, logits q.k / sqrt(D) accumulated in f32. A pair (q row, key) counts
// when both lie in [valid_lo, valid_hi) and key <= q row; p = exp(s - m_q) /
// max(l_q, 1e-30) with (m_q, l_q) the row's softmax max and sum. "sum" writes
// F[h, t] = sum over q of p(q, t); "max" writes max_q p(q, t) over pairs with
// t <= q - recent_cnt. F is [H, T] f32; a column that no pair reaches is 0.
// Rows that see no key keep m = NEG_INF and l = 0, and none of their pairs is
// evaluated, so no NaN can reach F.
//
// What bounds it: two causal QK^T sweeps, 2 * (2 * H * n^2 / 2 * D) FLOPs on
// bf16 tensor cores for n valid rows (8.4 TFLOP at H 32, D 128, n 32000:
// 8.5 ms at 989 TFLOP/s), and one exponential per pair and sweep, H * n^2
// in all (3.3e10 at those shapes). Bytes (q and k read, F written) are
// negligible, so it is bound by operations.
//
// Design: two kernels, deterministic, no atomics.
//  * Pass 1 (row stats) is K2's loop without PV: one CTA of four warps per
//    (q head, 64-row q tile), each warp owning 16 rows, walks the 64-key
//    tiles from valid_lo to the causal frontier with mma.sync m16n8k16 and
//    keeps the online (m, l) in registers; it writes m and l [H, T] f32.
//    Heavy (late) q tiles launch first.
//  * Pass 2 (columns) turns the TPU grid around: on the TPU, F[h, key
//    block] was carried across the q blocks of a sequential grid in the
//    output block (and revisited non-consecutively, which Pallas does not
//    read back on a TPU). Here one CTA owns one (q head, 64-key tile) and
//    writes its F columns once. It computes S^T = K Q^T: each warp holds the
//    A fragments of its 16 keys in registers for the whole walk and takes
//    the q tiles, from the key tile's diagonal to valid_hi, as B operands
//    from shared memory (cp.async double buffering, the tile's m and 1/l
//    staged beside it). A key is then an accumulator row, so the running
//    column sum (or max) stays in two registers per thread across q tiles;
//    one quad shuffle at the end finishes it. Early key tiles see the most
//    q tiles and launch first. A pass 2 per q tile would need atomicAdd
//    into F (nondeterministic) and a float atomic max.
// One template parameter selects "sum" or "max". wgmma/TMA, and fusing pass
// 1 into K2 by having K2 emit its row log-sum-exp, are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BM = 64;        // q rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int NTHREADS = 128; // 4 warps x 16 rows (pass 1) or keys (pass 2)
constexpr float NEG_INF = -1e30f;

// Copy rows [r0, r0 + 64) of a [T, D] bf16 matrix into a [64][LD] shared
// tile with cp.async; rows at or past T are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          int r0, int T, int tid) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int c = tid; c < 64 * CH; c += NTHREADS) {
    const int r = c / CH, cc = c % CH, gr = r0 + r;
    const bool ok = gr < T;
    cp_async16(dst + r * LD + cc * 8, src + (size_t)(ok ? gr : 0) * D + cc * 8,
               ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
row_stats_kernel(const uint16_t* __restrict__ q,
                 const uint16_t* __restrict__ k, float* __restrict__ m_out,
                 float* __restrict__ l_out, int group, int T, int valid_lo,
                 int valid_hi, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;               // [BM][LD]
  uint16_t* sK = sQ + BM * LD;       // [2][BN][LD]

  const int nqb = (T + BM - 1) / BM;
  const int m0 = (nqb - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
  const uint16_t* qh = q + (size_t)h * T * D;
  const uint16_t* kh = k + (size_t)(h / group) * T * D;

  // keys [valid_lo, key_hi) can pair with a valid row of this tile
  const int key_hi = min(valid_hi, m0 + BM);
  const bool rows = m0 + BM > valid_lo && m0 < valid_hi;
  const int j_lo = valid_lo / BN;
  const int j_hi = rows && valid_lo < key_hi ? (key_hi + BN - 1) / BN : j_lo;

  load_tile<D>(sQ, qh, m0, T, tid);
  if (j_lo < j_hi) load_tile<D>(sK, kh, j_lo * BN, T, tid);
  cp_async_commit();

  const int wr = warp * 16;
  const int qrow[2] = {m0 + wr + r0, m0 + wr + r0 + 8};
  const bool qok[2] = {qrow[0] >= valid_lo && qrow[0] < valid_hi,
                       qrow[1] >= valid_lo && qrow[1] < valid_hi};
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums
  uint32_t qf[D / 16][4];

  for (int j = j_lo; j < j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    if (j + 1 < j_hi) load_tile<D>(sK + (stage ^ 1) * BN * LD, kh,
                                   (j + 1) * BN, T, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == j_lo) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ld_frag_a(qf[kc], sQ + (wr + r0) * LD + kc * 16 + c0, LD);
    }
    const uint16_t* cK = sK + stage * BN * LD;

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

    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BN + nt * 8 + c0 + (e & 1);
        const bool ok = qok[e >> 1] && col >= valid_lo && col < valid_hi &&
                        col <= qrow[e >> 1];
        s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      l_r[i] *= __expf(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked logits sit at NEG_INF; real ones are far above NEG_INF / 2
        if (s[nt][e] > 0.5f * NEG_INF) l_r[e >> 1] += __expf(s[nt][e] - m_r[e >> 1]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if ((lane & 3) == 0 && qrow[i] < T) {
      m_out[(size_t)h * T + qrow[i]] = m_r[i];
      l_out[(size_t)h * T + qrow[i]] = l;
    }
  }
}

template <int D, bool MAX>
__global__ void __launch_bounds__(NTHREADS)
column_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const float* __restrict__ m_in, const float* __restrict__ l_in,
              float* __restrict__ f_out, int group, int T, int valid_lo,
              int valid_hi, int recent_cnt, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sK = smem;                        // [BN][LD]
  uint16_t* sQ = sK + BN * LD;                // [2][BM][LD]
  float* sM = reinterpret_cast<float*>(sQ + 2 * BM * LD);  // [2][BM]
  float* sI = sM + 2 * BM;                    // [2][BM]: 1 / max(l, 1e-30)

  const int k0 = blockIdx.x * BN;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
  const uint16_t* qh = q + (size_t)h * T * D;
  const uint16_t* kh = k + (size_t)(h / group) * T * D;
  const float* mh = m_in + (size_t)h * T;
  const float* lh = l_in + (size_t)h * T;

  // q rows that can pair with a key of this tile: [q_first, valid_hi)
  const bool keys = k0 + BN > valid_lo && k0 < valid_hi;
  const int q_first = max(MAX ? k0 + recent_cnt : k0, valid_lo);
  const int i_lo = q_first / BM;
  const int i_hi = keys && q_first < valid_hi ? (valid_hi + BM - 1) / BM : i_lo;

  auto load_q = [&](int i, int stage) {
    load_tile<D>(sQ + stage * BM * LD, qh, i * BM, T, tid);
    if (tid < BM) {
      const int row = i * BM + tid;
      sM[stage * BM + tid] = row < T ? mh[row] : NEG_INF;
      sI[stage * BM + tid] = row < T ? 1.f / fmaxf(lh[row], 1e-30f) : 0.f;
    }
  };
  if (i_lo < i_hi) {
    load_tile<D>(sK, kh, k0, T, tid);
    load_q(i_lo, 0);
  }
  cp_async_commit();

  const int wr = warp * 16;                   // warp's first key in the tile
  const int key[2] = {k0 + wr + r0, k0 + wr + r0 + 8};
  const bool kok[2] = {key[0] >= valid_lo && key[0] < valid_hi,
                       key[1] >= valid_lo && key[1] < valid_hi};
  const int reach[2] = {MAX ? key[0] + recent_cnt : key[0],
                        MAX ? key[1] + recent_cnt : key[1]};
  float acc[2] = {0.f, 0.f};
  uint32_t kf[D / 16][4];

  for (int i = i_lo; i < i_hi; ++i) {
    const int stage = (i - i_lo) & 1;
    if (i + 1 < i_hi) load_q(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i == i_lo) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ld_frag_a(kf[kc], sK + (wr + r0) * LD + kc * 16 + c0, LD);
    }
    const uint16_t* cQ = sQ + stage * BM * LD;
    const float* cM = sM + stage * BM;
    const float* cI = sI + stage * BM;

    // S^T tile: rows = this warp's 16 keys, columns = the 64 q rows
    float s[BM / 8][4];
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
        const uint16_t* qb = cQ + (nt * 8 + r0) * LD + kc * 16 + c0;
        uint32_t b[2] = {ld_u32(qb), ld_u32(qb + 8)};
        mma_bf16(s[nt], kf[kc], b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + c0 + (e & 1);
        const int qr = i * BM + ql;
        const int r = e >> 1;
        // a pair counts with both ends in [valid_lo, valid_hi) and
        // key <= q (key <= q - recent_cnt for "max")
        if (kok[r] && qr < valid_hi && qr >= valid_lo && reach[r] <= qr) {
          const float p = __expf(s[nt][e] * scale - cM[ql]) * cI[ql];
          acc[r] = MAX ? fmaxf(acc[r], p) : acc[r] + p;
        }
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float a = acc[r];
    const float a1 = __shfl_xor_sync(0xffffffffu, a, 1);
    a = MAX ? fmaxf(a, a1) : a + a1;
    const float a2 = __shfl_xor_sync(0xffffffffu, a, 2);
    a = MAX ? fmaxf(a, a2) : a + a2;
    if ((lane & 3) == 0 && key[r] < T) f_out[(size_t)h * T + key[r]] = a;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, void* f, void* m, void* l,
                   int H, int H_kv, int T, int valid_lo, int valid_hi,
                   int max_mode, int recent_cnt, cudaStream_t stream) {
  constexpr int LD = D + 8;
  const size_t smem1 = (size_t)(BM + 2 * BN) * LD * sizeof(uint16_t);
  const size_t smem2 = (size_t)(BN + 2 * BM) * LD * sizeof(uint16_t) +
                       4 * BM * sizeof(float);
  auto col = max_mode ? &column_kernel<D, true> : &column_kernel<D, false>;
  // once per process, so that a launch inside a CUDA-graph capture makes
  // no attribute call
  static const cudaError_t attr = [&] {
    const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t e = cudaFuncSetAttribute(row_stats_kernel<D>, a, (int)smem1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(column_kernel<D, false>, a, (int)smem2);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(column_kernel<D, true>, a, (int)smem2);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int group = H / H_kv;
  const float scale = 1.0f / sqrtf((float)D);
  const uint16_t* qp = static_cast<const uint16_t*>(q);
  const uint16_t* kp = static_cast<const uint16_t*>(k);
  row_stats_kernel<D><<<dim3((T + BM - 1) / BM, H), NTHREADS, smem1, stream>>>(
      qp, kp, static_cast<float*>(m), static_cast<float*>(l), group, T,
      valid_lo, valid_hi, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  col<<<dim3((T + BN - 1) / BN, H), NTHREADS, smem2, stream>>>(
      qp, kp, static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<float*>(f), group, T, valid_lo, valid_hi, recent_cnt, scale);
  return cudaGetLastError();
}

}  // namespace

// q [H, T, D], k [H_kv, T, D]: contiguous bf16; f (the output) and the
// row-stat scratch m, l: [H, T] f32. 0 <= valid_lo, valid_hi <= T;
// max_mode 0 = "sum", 1 = "max". Returns a cudaError_t (0 = launched).
extern "C" int pq_flash_scores(const void* q, const void* k, void* f, void* m,
                               void* l, int H, int H_kv, int T, int D,
                               int valid_lo, int valid_hi, int max_mode,
                               int recent_cnt, void* stream) {
  if (T <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, f, m, l, H, H_kv, T, valid_lo, valid_hi,
                        max_mode, recent_cnt, s);
    case 128:
      return launch<128>(q, k, f, m, l, H, H_kv, T, valid_lo, valid_hi,
                         max_mode, recent_cnt, s);
    default:
      return cudaErrorInvalidValue;
  }
}
