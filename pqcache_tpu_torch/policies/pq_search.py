"""`pq_search` policy: PQCache retrieval, single sequence.

Counterpart of the single-sequence part of ``pqcache_tpu/policies/pq_search.py``:

  prefill  flash attention (K2) over the left-padded prompt; then, per layer,
           Lloyd k-means codebooks over the non-sink keys, the sink / tail /
           code writes (bf16 tail, or int8 with frozen per-channel scales)
           and, where the joint-histogram scorer applies, the uint8 joint
           code histogram.
  decode   select_block = 1 (the default): per-token ADC scores (K5, or the
           gather-sum with adc_mode="xla") -> GQA softmax-mass top-k ->
           ascending sort -> row gather from the stacked tail (K6 with
           gather_mode="pallas", else advanced indexing).
           select_block > 1: block mass from the joint histogram (S = 2,
           select_block <= 256, scorer "auto") or from the fused ADC block
           scorer (K3), or block mass of the gather-sum scores on the plain
           route -> block top-k -> the block-retrieval kernel (K1).
           Either way the retrieved tokens are merged with the
           [sink | local | new] segments by online softmax. After all layers,
           ``commit_appends`` encodes and appends every layer's new token and
           joins one token into the histogram, where there is one.

Kernel selection follows the JAX policy with the Mosaic alignment gates
dropped: ``RuntimeConfig.kernels`` "auto"/"pallas" take the kernel wrappers,
"xla" the plain versions of the same functions. ``adc_mode`` "v2" rounds the
LUT to bf16 as the v2 TPU kernel does, on both routes, so a kernels-vs-plain
run selects the same tokens; JAX's XLA route ignores adc_mode and sums the
f32 LUT, which is adc_mode "v1" here.

The state is written in place (the JAX package returns new pytrees).
Configurations outside this path raise NotImplementedError naming the slice
that ports them.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core import pq, quant
from pqcache_tpu_torch.core.budget import Budget
from pqcache_tpu_torch.ops.adc import (adc_block_scores, adc_scores,
                                       adc_scores_ref)
from pqcache_tpu_torch.ops.attention_ref import decode_window_attention_segments
from pqcache_tpu_torch.ops.block_attn import (block_topk_attention,
                                              block_topk_attention_ref)
from pqcache_tpu_torch.ops.dispatch import dense_prefill_attention
from pqcache_tpu_torch.ops.gather import gather_rows
from pqcache_tpu_torch.policies.base import register_policy, use_kernels
from pqcache_tpu_torch.runtime.state import PQState, make_pq_state


def _later(what: str, slice_: str):
    raise NotImplementedError(
        f"pq_search: {what} is not ported yet (later slice: {slice_})")


@register_policy("pq_search")
class PQSearchPolicy:
    deferred_appends = True

    def __init__(self, cfg: EngineConfig, budget: Budget, device=None):
        self.cfg = cfg
        self.budget = budget
        self.device = resolve_device(device)
        m = cfg.model
        self.S = cfg.pq.n_subvec_per_head
        self.C = cfg.pq.n_centroids
        self.d_sub = m.head_dim // self.S
        self.group = m.num_groups
        self.H_kv = m.num_kv_heads
        self.D = m.head_dim
        self.select_block = max(cfg.pq.select_block, 1)
        self.use_kernel = use_kernels(cfg)
        self.adc_mode = cfg.pq.adc_mode
        self.gather_mode = cfg.pq.gather_mode
        self.approx_topk = cfg.pq.approx_topk
        self.check_recall = cfg.pq.check_recall
        if cfg.pq.metric != "euc":
            _later("metric='ip'", "non-default pq_search branches")
        if not cfg.runtime.gqa:
            _later("gqa=False", "non-default pq_search branches")
        if cfg.pq.fetch_mode != "gather":
            _later("fetch_mode='masked'", "non-default pq_search branches")
        if cfg.pq.fetch_pair:
            _later("fetch_pair", "batched path")
        if budget.n_tail_max % self.select_block:
            raise ValueError("n_tail_max must be divisible by select_block")
        self.kv_int8 = cfg.cache.kv_dtype == "int8"
        # the joint-histogram scorer (pq_search.py:117-120; the port's
        # appends are always deferred) and the fused ADC block scorer K3
        # where it does not apply (:315-318)
        self.use_jhist = (cfg.pq.scorer == "auto" and self.S == 2
                          and 1 < self.select_block <= 256)
        self.fused_blockscore = (self.use_kernel and self.adc_mode != "xla"
                                 and not self.use_jhist
                                 and self.select_block > 1)

    # -- helpers ----------------------------------------------------------

    def _to_groups(self, x: torch.Tensor) -> torch.Tensor:
        """[H_kv, T, D] -> [H_kv*S, T, d_sub] subvector groups."""
        H_kv, T, _ = x.shape
        return (x.reshape(H_kv, T, self.S, self.d_sub).transpose(1, 2)
                .reshape(H_kv * self.S, T, self.d_sub))

    def _split_rows(self, kv_rows, state: PQState, idx: int):
        """Split (and dequantize) tail rows [H_kv, T, 2D] -> (k, v) in the
        engine dtype."""
        if not self.kv_int8:
            return kv_rows[..., :self.D], kv_rows[..., self.D:]
        return quant.dequant_kv(kv_rows, state.k_scale[idx],
                                state.v_scale[idx], dtype=state.k_sink.dtype)

    def _tail_kv(self, k, v, state: PQState, idx=None):
        """Interleave (and quantize) K/V rows into tail storage. k, v
        [..., T, D] with the scales' leading axes ([H_kv] for a layer idx,
        [L, H_kv] when idx is None)."""
        if not self.kv_int8:
            return torch.cat([k, v], -1).to(state.kv_tail.dtype)
        ks = state.k_scale if idx is None else state.k_scale[idx]
        vs = state.v_scale if idx is None else state.v_scale[idx]
        return quant.quantize_kv(k, v, ks, vs)

    def _q_for_tail(self, q_flat, state: PQState, idx: int):
        """Fold the per-channel K scale into q for an int8 tail:
        q . (s * K_int8) = (q * s) . K_int8. [H, D] -> [H, 1, D] (f32 when
        int8, else unchanged)."""
        H = q_flat.shape[0]
        if not self.kv_int8:
            return q_flat.reshape(H, 1, self.D)
        qs = (q_flat.float().reshape(self.H_kv, self.group, self.D)
              * state.k_scale[idx])
        return qs.reshape(H, 1, self.D)

    # -- prefill ----------------------------------------------------------

    def init_state(self, dtype=torch.bfloat16) -> PQState:
        # the histogram only where its scorer reads it: at select_block 1
        # it would be [L, H_kv, N_tail, C^2], 34.6 GB at 32k and 32 layers
        return make_pq_state(
            self.cfg, self.budget, dtype=dtype, device=self.device,
            jhist_blocks=(self.budget.n_tail_max // self.select_block
                          if self.use_jhist else 0))

    def prefill_attn(self, state: PQState, idx: int, q, k, v, pad_len: int,
                     true_len: int):
        out, _ = dense_prefill_attention(q, k, v, pad_len,
                                         use_kernel=self.use_kernel)
        self.prefill_tail(state, idx, k, v, pad_len, true_len)
        return out

    def prefill_tail(self, state: PQState, idx: int, k, v, pad_len: int,
                     true_len: int) -> None:
        """Codebook training and layer-state writes from this layer's full
        K/V [H_kv, P, D]."""
        b = self.budget
        P = k.shape[1]
        # left-padded prompt -> roll so real tokens start at index 0; the
        # rolled-around padding lands after the valid region, masked there
        k_r = torch.roll(k, -int(pad_len), dims=1)
        v_r = torch.roll(v, -int(pad_len), dims=1)
        k_tail_src, v_tail_src = k_r[:, b.sink:], v_r[:, b.sink:]
        n_valid_tail = int(true_len) - b.sink

        xb = self._to_groups(k_tail_src)                     # [G, P-sink, d]
        gen = torch.Generator(device=k.device).manual_seed(
            self.cfg.pq.kmeans_seed)
        iters = (int(min(3 + P // 4096, 25)) if self.cfg.pq.adaptive_iters
                 else self.cfg.pq.kmeans_iters)
        res = pq.kmeans(xb, self.C, iters=iters, valid_len=n_valid_tail,
                        generator=gen)
        n_src = P - b.sink

        dt = state.k_sink.dtype
        state.k_sink[idx] = k_r[:, :b.sink].to(dt)
        state.v_sink[idx] = v_r[:, :b.sink].to(dt)
        if self.kv_int8:
            ks, vs = quant.kv_channel_scales(k_tail_src, v_tail_src,
                                             n_valid_tail)
            state.k_scale[idx], state.v_scale[idx] = ks, vs
        state.kv_tail[idx, :, :n_src] = self._tail_kv(k_tail_src, v_tail_src,
                                                      state, idx)
        codes_src = res.codes.reshape(self.H_kv, self.S, n_src)
        state.codes[idx, :, :, :n_src] = codes_src.to(torch.uint8)
        state.centroids[idx] = res.centroids.reshape(self.H_kv, self.S,
                                                     self.C, -1)
        state.phi[idx] = 0.0
        n_cand0 = max(n_valid_tail - b.local, 0)
        state.n_cand, state.pos = n_cand0, int(true_len)
        if self.use_jhist:
            state.jhist[idx] = pq.build_joint_hist(
                state.codes[idx], n_cand0, n_centroids=self.C,
                block=self.select_block)

    # -- decode -----------------------------------------------------------

    def _adc(self, lut, codes):
        """Per-token ADC scores [H, N_tail] of the LUT [H, S, C] over one
        layer's codes [H_kv, S, N_tail]: K5 (or its plain version) with the
        LUT rounded to bf16 for adc_mode "v2", the gather-sum for "xla"."""
        if self.adc_mode == "xla":
            return pq.adc_gather_scores(lut, codes)
        H = lut.shape[0]
        fn = adc_scores if self.use_kernel else adc_scores_ref
        return fn(lut.reshape(self.H_kv, self.group, self.S, -1), codes,
                  round_lut_bf16=self.adc_mode == "v2").reshape(H, -1)

    def decode_attn(self, state: PQState, idx: int, q, k_new, v_new, shared):
        """q [H, 1, D]; k/v_new [H_kv, 1, D]. Returns (out [H, 1, D],
        (k_new, v_new) payload for commit_appends)."""
        n_cand = shared["n_cand"]
        H = q.shape[0]
        lut = pq.adc_lut_euc(q.reshape(H, self.S, self.d_sub),
                             state.centroids[idx])
        if self.select_block == 1:
            return self._decode_tokens(state, idx, q, k_new, v_new, n_cand,
                                       lut)
        b, bs = self.budget, self.select_block
        if self.use_jhist:
            blk_mass = pq.joint_block_mass(lut, state.jhist[idx],
                                           head_dim=self.D)
        elif self.fused_blockscore:
            blk_mass = adc_block_scores(
                lut.reshape(self.H_kv, self.group, self.S, -1),
                state.codes[idx], n_cand, sel_block=bs, head_dim=self.D)
        else:
            blk_mass = None
        if blk_mass is not None:
            blk_idx = pq.topk_from_block_mass(
                blk_mass, n_cand, b.topk, group=self.group, block=bs,
                approx=self.approx_topk)
        else:
            # the plain route of the block scorers (pq_search.py:409-417)
            blk_idx, _ = pq.mips_topk_blocks(
                pq.adc_gather_scores(lut, state.codes[idx]), n_cand, b.topk,
                group=self.group, head_dim=self.D, block=bs,
                approx=self.approx_topk)
        blk_idx = torch.sort(blk_idx, -1).values
        attn = block_topk_attention if self.use_kernel else \
            block_topk_attention_ref
        m_p, l_p, acc_p = attn(
            self._q_for_tail(q.reshape(H, self.D), state, idx),
            state.kv_tail, idx, blk_idx, n_cand, block=bs)
        if self.kv_int8:
            acc_p = acc_p * state.v_scale[idx]   # acc is linear in V
        return self._finish_decode(state, idx, q, k_new, v_new, n_cand,
                                   partials=[(m_p, l_p, acc_p)])

    def _decode_tokens(self, state: PQState, idx: int, q, k_new, v_new,
                       n_cand: int, lut):
        """select_block = 1 (pq_search.py:444-483): per-token top-k over the
        candidates, rows gathered in ascending order (attention does not
        depend on their order; the gather reads memory in order)."""
        topk_idx, _ = pq.mips_topk(
            self._adc(lut, state.codes[idx]), n_cand, self.budget.topk,
            group=self.group, head_dim=self.D, approx=self.approx_topk)
        topk_idx = torch.sort(topk_idx, -1).values          # [H_kv, topk]
        if self.use_kernel and self.gather_mode == "pallas":
            # the stacked tail as [L * H_kv, N, 2D] (a view): the layer is a
            # head offset, nothing is copied
            L, _, N, D2 = state.kv_tail.shape
            kv_top = gather_rows(state.kv_tail.view(L * self.H_kv, N, D2),
                                 topk_idx, idx * self.H_kv)
        else:
            heads = torch.arange(self.H_kv, device=topk_idx.device)
            kv_top = state.kv_tail[idx][heads[:, None], topk_idx]
        if self.check_recall:
            # the recall oracle (pq_search.py:469-479): exact top-k over the
            # candidate keys against the PQ selection. Debug only: it reads
            # and dequantises the whole tail.
            k_cand, _ = self._split_rows(state.kv_tail[idx], state, idx)
            exact = pq.exact_topk(q.reshape(-1, self.D), k_cand, n_cand,
                                  self.budget.topk, group=self.group)
            rec = pq.topk_recall(topk_idx, exact, group=self.group)
            print(f"pq recall layer={idx}: {rec:.3f}", flush=True)
        k_top, v_top = self._split_rows(kv_top, state, idx)
        return self._finish_decode(state, idx, q, k_new, v_new, n_cand,
                                   top=(k_top, v_top, topk_idx < n_cand))

    def _finish_decode(self, state: PQState, idx: int, q, k_new, v_new,
                       n_cand: int, partials=(), top=None):
        """[sink | local | top-k | new] segmented attention; the top-k
        tokens come as kernel partials or as a gathered (k, v, mask)
        segment."""
        b = self.budget
        kv_local = state.kv_tail[idx, :, n_cand:n_cand + b.local]
        k_local, v_local = self._split_rows(kv_local, state, idx)
        dt = state.k_sink.dtype
        segs = [(state.k_sink[idx], state.v_sink[idx], None),
                (k_local, v_local, None)]
        if top is not None:
            segs.append(top)
        segs.append((k_new.to(dt), v_new.to(dt), None))
        out = decode_window_attention_segments(q, segs, partials=partials)
        return out, (k_new[:, 0], v_new[:, 0])

    def commit_appends(self, state: PQState, payloads, shared) -> None:
        """Append all layers' new tokens at once: payloads = (k_new
        [L, H_kv, D], v_new [L, H_kv, D]). Encodes them, writes tail and
        codes at slot n_cand + local, and joins the token at n_cand (which
        becomes a candidate this step) into the histogram, where the state
        has one."""
        k_new, v_new = payloads
        n_cand = shared["n_cand"]
        slot = n_cand + self.budget.local
        L, H_kv, D = k_new.shape
        xg = self._to_groups(k_new.reshape(L * H_kv, 1, D))
        cent = state.centroids.reshape(L * H_kv * self.S, self.C, -1)
        codes = pq.pq_encode(xg, cent).reshape(L, H_kv, self.S)
        # [L, H_kv, S], read before the code write (slot == n_cand when
        # local is 0)
        join = (state.codes[:, :, :, n_cand].clone()
                if state.jhist is not None else None)
        state.kv_tail[:, :, slot] = self._tail_kv(
            k_new[:, :, None], v_new[:, :, None], state)[:, :, 0]
        state.codes[:, :, :, slot] = codes.to(torch.uint8)
        if state.jhist is not None:
            pq.jhist_add_tokens(state.jhist, join, n_cand,
                                n_centroids=self.C, block=self.select_block)

    def shared_pre(self, state: PQState):
        return {"n_cand": state.n_cand}

    def shared_post(self, state: PQState, shared) -> None:
        # one token appended per step: the oldest local token becomes a
        # retrieval candidate
        state.n_cand += 1
        state.pos += 1
