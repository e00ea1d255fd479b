"""`pq_search` policy: PQCache retrieval, single sequence and batch-as-heads.

Counterpart of ``pqcache_tpu/policies/pq_search.py``:

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

The non-default branches (pq_search.py:92-120, 339-398, 565-615):

  metric="ip"   keys lifted by sqrt(phi - |k|^2) before k-means (phi kept in
                the state, new keys lifted with it), queries by a zero
                column; the LUT holds squared L2 distances and the top-k
                takes the smallest summed distance. The joint histogram and
                K3 are euclidean only, so the block path scores per token
                (K5) and ranks blocks by mean distance before K1.
  gqa=False     each q head takes its own top-k over its own ADC scores and
                gathers its own rows (per-token gather fetch only).
  fetch_mode="masked"  a thresholded mask over attention to the whole tail:
                candidates at or above the k-th group score, the local window
                and the new token, written into the tail first (its k/v
                attended raw with an int8 tail). select_block 1 only.
  The last two write their new token inside ``decode_attn``
  (``deferred_appends`` False) and have no batched route.

Batch-as-heads (``init_batched_state``, ``insert_slot``,
``decode_attn_batched``, ``commit_appends_batched``, ``flush_ring_batched``):
B sequence slots folded into the kv-head axis, per-slot counters on the
device. Every layer's new token goes to one column of the write-combining
ring, attended raw from there until the chunk's flush encodes (and, for an
int8 tail, quantizes) the ring into the per-slot tails. The local window
rides K1 on the block paths (win_len = local - ring_r rows from n_cand, the
rest of the window being in the ring); on the per-token path it is a masked
segment. The joint histogram joins one token per step, or, deferred
(``jhist_defer``), the chunk's tokens at the flush, the scorer adding their
exact pending mass meanwhile. Nothing on this path reads a count on the
host, so a decode step can be captured into a CUDA graph
(``runtime/decode_graph.py``).

Kernel selection follows the JAX policy with the Mosaic alignment gates
dropped: ``RuntimeConfig.kernels`` "auto"/"pallas" take the kernel wrappers,
"xla" the plain versions of the same functions. ``adc_mode`` "v2" rounds the
LUT to bf16 as the v2 TPU kernel does, on both routes, so a kernels-vs-plain
run selects the same tokens; JAX's XLA route ignores adc_mode and sums the
f32 LUT, which is adc_mode "v1" here.

A model with a latent cache (``config.DeepseekV2Config``, MLA): one kv
head of width D (576) per layer whose rows are the keys and whose first Dv
(512) columns are the values, for every query head of the layer. The tail,
the sink and the ring hold each row once (``runtime/state.py``), the
codebooks and the histogram are over the rows, the LUT comes from the
model's absorbed query, and the block path's K1 is its latent variant
(``block_topk_latent_attention``), which reads each selected row once for
all the heads; the merge takes values narrower than the keys.

A model with sliding-window layers (``config.AfmoeConfig``): the PQ state
above exists for its full-attention layers only, stacked over
``ModelConfig.full_layers``; each window layer keeps a ring of its last
``window`` keys and values beside it, K | V per row as in the tail, which
K1 attends outside the ``pq_fetch`` scope (``policies/window.py``).
``prefill_tail``, ``insert_slot`` and ``decode_attn_batched`` take the
model's layer index and dispatch on its kind; a window layer writes its
new token into its ring inside ``decode_attn_batched`` and returns no
payload, so ``commit_appends_batched`` and ``flush_ring_batched`` see the
full layers alone.

The state is written in place (the JAX package returns new pytrees).
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core import pq, quant
from pqcache_tpu_torch.core.budget import Budget
from pqcache_tpu_torch.ops.adc import (adc_block_scores, adc_scores,
                                       adc_scores_ref)
from pqcache_tpu_torch.ops.attention_ref import (
    decode_window_attention, decode_window_attention_segments,
    segment_partial)
from pqcache_tpu_torch.ops.block_attn import (
    block_topk_attention, block_topk_attention_ref,
    block_topk_latent_attention, block_topk_latent_attention_ref)
from pqcache_tpu_torch.ops.dispatch import dense_prefill_attention
from pqcache_tpu_torch.ops.gather import gather_rows
from pqcache_tpu_torch.policies.base import register_policy, use_kernels
from pqcache_tpu_torch.policies.window import WindowLayers
from pqcache_tpu_torch.runtime.stages import scope, span, stage
from pqcache_tpu_torch.runtime.state import PQState, make_pq_state, per_head


@register_policy("pq_search")
class PQSearchPolicy:
    def __init__(self, cfg: EngineConfig, budget: Budget, device=None):
        self.cfg = cfg
        self.budget = budget
        self.device = resolve_device(device)
        m = cfg.model
        self.S = cfg.pq.n_subvec_per_head
        self.C = cfg.pq.n_centroids
        self.group = m.num_groups
        self.H_kv = m.num_kv_heads
        self.D = m.head_dim
        # a latent cache's values are its rows' first Dv columns
        self.Dv = m.value_dim
        self.latent = m.latent_kv
        self.select_block = max(cfg.pq.select_block, 1)
        self.use_kernel = use_kernels(cfg)
        self.adc_mode = cfg.pq.adc_mode
        self.gather_mode = cfg.pq.gather_mode
        self.check_recall = cfg.pq.check_recall
        self.metric = cfg.pq.metric
        self.fetch_mode = cfg.pq.fetch_mode
        self.gqa = cfg.runtime.gqa
        if not self.gqa and (self.select_block > 1
                             or self.fetch_mode != "gather"):
            raise ValueError("gqa=False supports only per-token gather fetch")
        # the masked and per-q-head branches append inside decode_attn (the
        # masked mode's block path too: pq_search.py:108, 339)
        self.deferred_appends = self.gqa and self.fetch_mode != "masked"
        # the pair fetch needs a 2·block-aligned tail (pq_search.py:72-81);
        # K1 computes the same function with it
        if cfg.pq.fetch_pair and (not 1 < self.select_block <= 128
                                  or 256 % (2 * self.select_block)):
            raise ValueError(
                f"fetch_pair requires 1 < select_block <= 128 with "
                f"2*select_block dividing the 256-aligned tail (got "
                f"select_block={self.select_block})")
        self.fetch_pair = cfg.pq.fetch_pair
        if budget.n_tail_max % self.select_block:
            raise ValueError("n_tail_max must be divisible by select_block")
        self.kv_int8 = cfg.cache.kv_dtype == "int8"
        # the joint-histogram scorer (pq_search.py:117-120) and the fused
        # ADC block scorer K3 where it does not apply (:315-318): euclidean
        # only, and only with deferred appends
        self.use_jhist = (self.select_block > 1 and self.deferred_appends
                          and pq.jhist_applies(cfg.pq, self.select_block))
        self.fused_blockscore = (self.use_kernel and self.adc_mode != "xla"
                                 and not self.use_jhist
                                 and self.select_block > 1
                                 and self.metric == "euc"
                                 and self.deferred_appends)
        # the batched write-combining ring (pq_search.py:121-132): at most
        # `local` columns, so every ring token is still in the local window
        self.ring_k = (min(cfg.pq.ring_cap, budget.local)
                       if budget.local >= 1 else 0)
        # (rank, size) of the tensor-parallel group whose kv-head shard
        # this policy holds (set by the parallel engines): k-means++ seeds
        # each group by its global index
        self.shard = (0, 1)
        self.kinds = WindowLayers(m)

    # -- helpers ----------------------------------------------------------

    def _kv_view(self, rows):
        """(k, v) views of raw rows: K | V halves, or a latent row and its
        first Dv columns."""
        if self.latent:
            return rows, rows[..., :self.Dv]
        return rows[..., :self.D], rows[..., self.D:]

    def _split_rows(self, kv_rows, state: PQState, idx: int):
        """Split (and dequantize) tail rows [H_kv, T, 2D] (a latent tail's
        [H_kv, T, D]) -> (k, v) in the engine dtype."""
        if not self.kv_int8:
            return self._kv_view(kv_rows)
        return quant.dequant_kv(kv_rows, state.k_scale[idx],
                                state.v_scale[idx], dtype=state.k_sink.dtype)

    def _tail_kv(self, k, v, state: PQState, idx=None):
        """Interleave (and quantize) K/V rows into tail storage. k, v
        [..., T, D] with the scales' leading axes ([H_kv] for a layer idx,
        [L, H_kv] when idx is None); a latent tail stores k alone, v
        being its first Dv columns."""
        if self.latent:
            return k.to(state.kv_tail.dtype)
        if not self.kv_int8:
            return torch.cat([k, v], -1).to(state.kv_tail.dtype)
        ks = state.k_scale if idx is None else state.k_scale[idx]
        vs = state.v_scale if idx is None else state.v_scale[idx]
        return quant.quantize_kv(k, v, ks, vs)

    def _q_for_tail(self, q_flat, state: PQState, idx: int):
        """Fold the per-channel K scale into q for an int8 tail:
        q . (s * K_int8) = (q * s) . K_int8. [H, D] -> [H, 1, D] (f32 when
        int8, else unchanged); H may be a folded B·H."""
        H = q_flat.shape[0]
        if not self.kv_int8:
            return q_flat.reshape(H, 1, self.D)
        qs = (q_flat.float().reshape(H // self.group, self.group, self.D)
              * state.k_scale[idx])
        return qs.reshape(H, 1, self.D)

    def _retrieve_blocks(self, state: PQState, idx: int, q_flat, blk_idx,
                         n_cand, win_len=None, win_max: int = 0):
        """K1 (or its plain version) over the selected blocks and, with
        win_max > 0, each head's local window; the V scale of an int8 tail
        applied to acc (acc is linear in V). A latent tail takes K1's
        latent variant."""
        if self.latent:
            attn = (block_topk_latent_attention if self.use_kernel
                    else block_topk_latent_attention_ref)
            return attn(q_flat.reshape(-1, 1, self.D), state.kv_tail, idx,
                        blk_idx, n_cand, block=self.select_block,
                        v_dim=self.Dv, win_len=win_len, win_max=win_max)
        attn = (block_topk_attention if self.use_kernel
                else block_topk_attention_ref)
        m_p, l_p, acc_p = attn(
            self._q_for_tail(q_flat, state, idx), state.kv_tail, idx,
            blk_idx, n_cand, block=self.select_block, pair=self.fetch_pair,
            win_len=win_len, win_max=win_max)
        if self.kv_int8:
            acc_p = acc_p * state.v_scale[idx]
        return m_p, l_p, acc_p

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
        K/V [H_kv, P, D], in a ``prefill_tail`` span (``runtime/stages``);
        a window layer's ring instead."""
        if idx in self.kinds.ring:
            self.kinds.prefill(state, idx, k, v, pad_len, true_len)
            return
        with span("prefill_tail", layer=idx):
            idx = self.kinds.full[idx]
            b = self.budget
            P = k.shape[1]
            pc = self.cfg.pq
            t = pq.train_layer(
                k, v, pad_len, true_len, sink=b.sink, S=self.S, C=self.C,
                metric=self.metric, iters=(int(min(3 + P // 4096, 25))
                                           if pc.adaptive_iters
                                           else pc.kmeans_iters),
                seed=pc.kmeans_seed, shard=self.shard,
                int8_scales=self.kv_int8)
            n_src = P - b.sink
            dt = state.k_sink.dtype
            state.k_sink[idx] = t.k_sink.to(dt)
            if not self.latent:        # a latent sink's v is a view of k
                state.v_sink[idx] = t.v_sink.to(dt)
            if self.kv_int8:
                state.k_scale[idx], state.v_scale[idx] = t.k_scale, t.v_scale
            state.kv_tail[idx, :, :n_src] = self._tail_kv(
                t.k_tail, t.v_tail, state, idx)
            state.codes[idx, :, :, :n_src] = t.codes.to(torch.uint8)
            state.centroids[idx] = t.centroids
            state.phi[idx] = 0.0 if t.phi is None else t.phi
            n_cand0 = max(t.n_valid - b.local, 0)
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
        return fn(lut.reshape(H // self.group, self.group, self.S, -1), codes,
                  round_lut_bf16=self.adc_mode == "v2").reshape(H, -1)

    def _select_blocks(self, state: PQState, idx: int, lut, n_cand,
                       slot_counts=None, pending=None):
        """Sorted block top-k [H_kv (or B·H_kv), kb] from the joint
        histogram (with the deferred joins' ``pending`` span,
        ``_pending_span``, whose exact mass the scorer adds), the fused
        ADC block scorer K3, or per-token scores: the gather-sum on the
        euclidean plain route, K5 (``_adc``) for the "ip" metric, which has
        no block scorer (pq_search.py:330-336, 409-417).
        n_cand: per-kv-head count (int, or [B·H_kv]); slot_counts: a
        batched state's per-slot counts [B], which K3 reads."""
        b, bs = self.budget, self.select_block
        codes = state.codes[idx]
        if self.use_jhist:
            blk_mass = pq.joint_block_mass(
                lut, state.jhist[idx], head_dim=self.D, pending=pending,
                block=bs, kernel=self.use_kernel)
        elif self.fused_blockscore:
            lead = () if slot_counts is None else (slot_counts.shape[0],)
            blk_mass = adc_block_scores(
                lut.reshape(*lead, self.H_kv, self.group, self.S, -1),
                codes.reshape(*lead, self.H_kv, self.S, -1),
                n_cand if slot_counts is None else slot_counts,
                sel_block=bs, head_dim=self.D).reshape(lut.shape[0], -1)
        else:
            blk_mass = None
        if blk_mass is not None:
            blk_idx = pq.topk_from_block_mass(
                blk_mass, n_cand, b.topk, group=self.group, block=bs)
        else:
            scores = (self._adc(lut, codes) if self.metric == "ip"
                      else pq.adc_gather_scores(lut, codes))
            blk_idx, _ = pq.mips_topk_blocks(
                scores, n_cand, b.topk, group=self.group, head_dim=self.D,
                block=bs, metric=self.metric)
        return torch.sort(blk_idx, -1).values

    def _gather_tail_rows(self, state: PQState, idx: int, rows):
        """Tail rows [H_kv', k, 2D] of layer idx at per-head positions
        rows [H_kv', k]: K6 with gather_mode "pallas", else advanced
        indexing."""
        L, Hf, N, D2 = state.kv_tail.shape
        if self.use_kernel and self.gather_mode == "pallas":
            # the stacked tail as [L * Hf, N, 2D] (a view): the layer is a
            # head offset, nothing is copied
            return gather_rows(state.kv_tail.view(L * Hf, N, D2), rows,
                               idx * Hf)
        heads = torch.arange(Hf, device=rows.device)
        return state.kv_tail[idx][heads[:, None], rows]

    def decode_attn(self, state: PQState, idx: int, q, k_new, v_new, shared):
        """q [H, 1, D]; k/v_new [H_kv, 1, D]. Returns (out [H, 1, D],
        (k_new, v_new) payload for commit_appends, or None where the branch
        appended the token itself)."""
        n_cand = shared["n_cand"]
        H = q.shape[0]
        lut = pq.adc_lut(q.reshape(H, self.D), state.centroids[idx], self.S,
                         self.metric)
        if self.select_block == 1:
            scores = self._adc(lut, state.codes[idx])
            if self.fetch_mode == "masked":
                return self._decode_masked(state, idx, q, k_new, v_new,
                                           n_cand, scores)
            if not self.gqa:
                return self._decode_nogqa(state, idx, q, k_new, v_new,
                                          n_cand, scores)
            return self._decode_tokens(state, idx, q, k_new, v_new, n_cand,
                                       scores)
        blk_idx = self._select_blocks(state, idx, lut, n_cand)
        part = self._retrieve_blocks(state, idx, q.reshape(H, self.D),
                                     blk_idx, n_cand)
        return self._finish_decode(state, idx, q, k_new, v_new, n_cand,
                                   partials=[part])

    def _decode_tokens(self, state: PQState, idx: int, q, k_new, v_new,
                       n_cand: int, scores):
        """select_block = 1 (pq_search.py:444-483): per-token top-k over the
        candidates, rows gathered in ascending order (attention does not
        depend on their order; the gather reads memory in order)."""
        topk_idx, _ = pq.mips_topk(
            scores, n_cand, self.budget.topk, group=self.group,
            head_dim=self.D, metric=self.metric)
        topk_idx = torch.sort(topk_idx, -1).values          # [H_kv, topk]
        kv_top = self._gather_tail_rows(state, idx, topk_idx)
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

    def _decode_masked(self, state: PQState, idx: int, q, k_new, v_new,
                       n_cand: int, scores):
        """fetch_mode="masked" (pq_search.py:339-398): attention over
        [sink | the whole tail] under a mask that keeps the candidates
        whose group score reaches the k-th largest (the exact k-th value:
        a tie at the threshold attends), the local window and the new
        token, written into the tail at n_cand + local first. An int8 tail
        attends the new token's own k/v, not their quantized copy. Reads
        (and dequantizes) the whole tail each layer-step."""
        b = self.budget
        sel = pq.group_scores(scores, n_cand, group=self.group,
                              head_dim=self.D, metric=self.metric)
        N = sel.shape[-1]
        cand_pos = torch.arange(N, device=sel.device)[None, :]
        kth = torch.topk(sel, b.topk).values[:, -1:]
        slot = n_cand + b.local
        tail_mask = (((sel >= kth) & (cand_pos < n_cand))
                     | ((cand_pos >= n_cand) & (cand_pos <= slot)))
        self._append_layer(state, idx, k_new, v_new, slot)
        k_tail, v_tail = self._split_rows(state.kv_tail[idx], state, idx)
        if self.kv_int8:
            k_tail[:, slot] = k_new[:, 0].to(k_tail.dtype)
            v_tail[:, slot] = v_new[:, 0].to(v_tail.dtype)
        k_win = torch.cat([state.k_sink[idx], k_tail], 1)
        v_win = torch.cat([state.v_sink[idx], v_tail], 1)
        win_mask = torch.cat([torch.ones((self.H_kv, b.sink),
                                         dtype=torch.bool,
                                         device=sel.device), tail_mask], 1)
        return decode_window_attention(q, k_win, v_win, win_mask), None

    def _decode_nogqa(self, state: PQState, idx: int, q, k_new, v_new,
                      n_cand: int, scores):
        """gqa=False (pq_search.py:565-615): every q head ranks the
        candidates by its own ADC scores and gathers its own top-k rows
        from its kv head's tail; the window is assembled per q head."""
        b = self.budget
        H = q.shape[0]
        topk_idx, _ = pq.mips_topk(
            scores, n_cand, b.topk, group=1, head_dim=self.D,
            metric=self.metric)
        topk_idx = torch.sort(topk_idx, -1).values           # [H, topk]
        kv_head = torch.arange(H, device=q.device) // self.group
        kv_top = state.kv_tail[idx][kv_head[:, None], topk_idx]  # [H, k, 2D]
        rep = lambda x: x.repeat_interleave(self.group, 0)  # noqa: E731
        if self.kv_int8:
            k_top, v_top = quant.dequant_kv(
                kv_top, rep(state.k_scale[idx]), rep(state.v_scale[idx]),
                dtype=state.k_sink.dtype)
        else:
            k_top, v_top = kv_top[..., :self.D], kv_top[..., self.D:]
        k_loc, v_loc = self._split_rows(
            state.kv_tail[idx, :, n_cand:n_cand + b.local], state, idx)
        dt = state.k_sink.dtype
        out = decode_window_attention_segments(q, [
            (rep(state.k_sink[idx]), rep(state.v_sink[idx]), None),
            (rep(k_loc), rep(v_loc), None),
            (k_top, v_top, topk_idx < n_cand),
            (rep(k_new.to(dt)), rep(v_new.to(dt)), None)])
        self._append_layer(state, idx, k_new, v_new, n_cand + b.local)
        return out, None

    def _finish_decode(self, state: PQState, idx: int, q, k_new, v_new,
                       n_cand: int, partials=(), top=None):
        """[sink | local | top-k | new] segmented attention; the top-k
        tokens come as kernel partials or as a gathered (k, v, mask)
        segment. Returns the payload for commit_appends, or appends the
        token itself where appends are not deferred."""
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
        if not self.deferred_appends:
            self._append_layer(state, idx, k_new, v_new, n_cand + b.local)
            return out, None
        return out, (k_new[:, 0], v_new[:, 0])

    def _append_layer(self, state: PQState, idx: int, k_new, v_new,
                      slot: int) -> None:
        """Encode and write one layer's new token (k/v_new [H_kv, 1, D]) at
        tail position slot (the in-layer append of the non-deferred
        branches)."""
        state.codes[idx, :, :, slot] = pq.encode(
            pq.to_groups(k_new, self.S),
            state.centroids[idx].reshape(self.H_kv * self.S, self.C, -1),
            state.phi[idx], self.metric).reshape(self.H_kv, self.S).to(
                torch.uint8)
        state.kv_tail[idx, :, slot] = self._tail_kv(
            k_new, v_new, state, idx)[:, 0]

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
        codes = self._encode(state, k_new[:, :, None])[..., 0]
        # [L, H_kv, S], read before the code write (slot == n_cand when
        # local is 0)
        join = (state.codes[:, :, :, n_cand].clone()
                if state.jhist is not None else None)
        state.kv_tail[:, :, slot] = self._tail_kv(
            k_new[:, :, None], v_new[:, :, None], state)[:, :, 0]
        state.codes[:, :, :, slot] = codes
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

    # -- batch-as-heads ---------------------------------------------------
    #
    # B sequence slots folded into the kv-head axis: state [L, B·H_kv, ...],
    # counters int32 [B] on the device (pq_search.py:626-1094). Every count
    # the step needs is read on the card, so the step can be captured.

    def _batched_alloc(self) -> dict:
        """Allocation kwargs of the batched state. The tail is padded by
        ring_k rounded up to 256 (so every select_block <= 256 still
        divides it): the flush writes ring_k rows from the tail's valid
        end minus ring_r, which then never runs past the buffer. The JAX
        package pads a fixed 256 (pq_search.py:641), which a ring_cap above
        256 overruns; the two agree whenever ring_k <= 256."""
        pad = -(-self.ring_k // 256) * 256
        return dict(
            jhist_blocks=((self.budget.n_tail_max + pad) // self.select_block
                          if self.use_jhist else 0),
            ring_k=self.ring_k, tail_pad=pad)

    def init_batched_state(self, B: int, dtype=torch.bfloat16) -> PQState:
        if not self.deferred_appends:
            # JAX's batched decode has no masked or per-q-head branch
            raise ValueError(
                "batch-as-heads pq_search needs gqa=True and the gather "
                "fetch; serve fetch_mode='masked' or gqa=False through the "
                "single-sequence Engine")
        return make_pq_state(self.cfg, self.budget, dtype=dtype,
                             device=self.device, batch=B,
                             **self._batched_alloc())

    def insert_slot(self, bstate: PQState, state: PQState, slot: int) -> None:
        """Write a prefilled single-sequence state into slot ``slot`` of a
        batched state, in place. The batched buffers are wider on the token
        and block axes (the tail pad): the state fills their leading part.
        An ``insert_slot`` span (``runtime/stages``)."""
        with span("insert_slot", slot=slot):
            Hk, S = self.H_kv, self.S
            h = slice(slot * Hk, (slot + 1) * Hk)
            N = state.kv_tail.shape[2]
            bstate.k_sink[:, h] = state.k_sink
            if not self.latent:
                bstate.v_sink[:, h] = state.v_sink
            bstate.kv_tail[:, h, :N] = state.kv_tail
            bstate.codes[:, h, :, :N] = state.codes
            bstate.centroids[:, h] = state.centroids
            bstate.phi[:, slot * Hk * S:(slot + 1) * Hk * S] = state.phi
            bstate.n_cand[slot] = state.n_cand
            bstate.pos[slot] = state.pos
            if self.use_jhist:
                bstate.jhist[:, h, :state.jhist.shape[2]] = state.jhist
            if self.kv_int8:
                bstate.k_scale[:, h] = state.k_scale
                bstate.v_scale[:, h] = state.v_scale
            self.kinds.insert_slot(bstate, state, slot)

    def _local_window(self, state: PQState, idx: int, q_flat, n_cand_h, r):
        """The per-token path's local window as a partial: the contiguous
        span [n_cand, n_cand + local) of each slot's tail (its start held
        inside the tail as JAX's dynamic slice holds it), rows at or past
        local - ring_r masked: those tokens are still in the ring."""
        local = self.budget.local
        N = state.kv_tail.shape[2]
        start = torch.clamp(n_cand_h.long(), max=N - local)
        rows = start[:, None] + torch.arange(local, device=start.device)
        Hf = rows.shape[0]
        kv = state.kv_tail[idx][torch.arange(Hf, device=rows.device)[:, None],
                                rows]
        k, v = self._split_rows(kv, state, idx)
        mask = (None if r is None else
                torch.arange(local, device=rows.device) < local - r)
        return segment_partial(q_flat.reshape(Hf, self.group, self.D), k, v,
                               mask)

    def decode_attn_batched(self, state: PQState, idx: int, q, k_new, v_new,
                            shared):
        """q [B, H, D]; k/v_new [B, H_kv, D]. Returns (out [B, H, D],
        (k_new, v_new) [B·H_kv, D] payload for commit_appends_batched); a
        window layer writes its ring and returns the payload None."""
        if idx in self.kinds.ring:
            return self.kinds.decode_batched(state, idx, q, k_new, v_new,
                                             shared), None
        idx = self.kinds.full[idx]
        b = self.budget
        n_cand_h = shared["n_cand_h"]                        # [B·H_kv]
        qf = q.reshape(-1, self.D)                           # [B·H, D]
        ring = state.ring_kv is not None
        r = state.ring_r if ring else None
        partials, top = [], None
        if self.select_block > 1:
            with stage("scorer+topk"):
                lut = pq.adc_lut(qf, state.centroids[idx], self.S,
                                 self.metric)                # [B·H, S, C]
                pending = None
                if self._jhist_defer(state):
                    with scope("pq_score"):
                        pos, codes = self._pending_span(state, n_cand_h, idx)
                    pending = (pos, codes, state.ring_r)
                blk_idx = self._select_blocks(state, idx, lut, n_cand_h,
                                              slot_counts=shared["n_cand"],
                                              pending=pending)
            # the local window rides K1: its tail-resident part is
            # [n_cand, n_cand + local - ring_r)
            with stage("k1"):
                partials.append(self._retrieve_blocks(
                    state, idx, qf, blk_idx, n_cand_h,
                    win_len=b.local - r if ring else b.local,
                    win_max=b.local))
        else:
            with stage("scorer+topk"):
                lut = pq.adc_lut(qf, state.centroids[idx], self.S,
                                 self.metric)
                topk_idx, _ = pq.mips_topk(
                    self._adc(lut, state.codes[idx]), n_cand_h, b.topk,
                    group=self.group, head_dim=self.D, metric=self.metric)
                topk_idx = torch.sort(topk_idx, -1).values   # [B·H_kv, k]
            with stage("gather"):
                partials.append(self._local_window(state, idx, qf, n_cand_h,
                                                   r))
                k_top, v_top = self._split_rows(
                    self._gather_tail_rows(state, idx, topk_idx), state, idx)
                top = (k_top, v_top, topk_idx < n_cand_h[:, None])
        return self._merge_batched(state, idx, qf, k_new, v_new, partials,
                                   top, r)

    def _merge_batched(self, state: PQState, idx: int, qf, k_new, v_new,
                       partials, top, r):
        """[sink | ring | top-k | new] segments merged with the partials by
        online softmax. Returns (out [B, H, D], (k_new, v_new)
        [B·H_kv, D])."""
        B, Hk, _ = k_new.shape
        Hf = B * Hk
        with stage("merge"):
            dt = state.k_sink.dtype
            segs = [(state.k_sink[idx], state.v_sink[idx], None)]
            if r is not None:
                # the chunk's tokens, raw in the ring's dtype until the flush
                rkv = state.ring_kv[idx]                   # [B·H_kv, K, 2D]
                rmask = torch.arange(self.ring_k, device=rkv.device) < r
                segs.append((*self._kv_view(rkv),
                             rmask[None].expand(Hf, -1)))
            if top is not None:
                segs.append(top)
            k_new_f = k_new.reshape(Hf, 1, self.D).to(dt)
            v_new_f = v_new.reshape(Hf, 1, self.Dv).to(dt)
            out = decode_window_attention_segments(
                qf.reshape(qf.shape[0], 1, self.D),
                segs + [(k_new_f, v_new_f, None)], partials=partials)
        return (out.reshape(B, -1, self.Dv), (k_new_f[:, 0], v_new_f[:, 0]))

    def _jhist_defer(self, state: PQState) -> bool:
        """Defer the per-step histogram join to the chunk's flush
        (pq_search.py:869-882): "on"/"off", or "auto", which defers once the
        histogram holds 480 MB or more."""
        if not (self.use_jhist and state.ring_kv is not None
                and state.jhist is not None):
            return False
        mode = self.cfg.pq.jhist_defer
        if mode != "auto":
            return mode == "on"
        return state.jhist.numel() * state.jhist.element_size() \
            >= 480_000_000

    def _pending_span(self, state: PQState, n_cand_h, layer=None):
        """The chunk's pending joins (pq_search.py:884-922): positions
        n_cand - ring_r + t of each folded head for t < ring_k, of which
        t < ring_r are live, and their codes [(L,) B·H_kv, S, ring_k]
        (layer idx, or all layers). The scorer adds the live ones' exact
        mass, which the lagging histogram misses."""
        K = self.ring_k
        t = torch.arange(K, device=n_cand_h.device)
        pos = (n_cand_h.long() - state.ring_r)[:, None] + t     # [Hf, K]
        codes = state.codes if layer is None else state.codes[layer]
        N = codes.shape[-1]
        idx = pos.clamp(0, N - 1)[:, None, :].expand(-1, self.S, -1)
        cp = codes.gather(-1, idx.expand(*codes.shape[:-1], K)).long()
        return pos, cp

    def _jhist_flush_join(self, state: PQState) -> None:
        """Commit the chunk's deferred joins at once (pq_search.py:924-969):
        a small per-(layer, head) histogram of the pending code pairs over
        the W block columns a ring_k span touches, saturating-added into
        the histogram."""
        J = state.jhist
        L, Hf, NB, CC = J.shape
        bs = self.select_block
        W = (self.ring_k - 1) // bs + 2
        n_cand_h = per_head(state.n_cand, self.H_kv)
        pos, cp = self._pending_span(state, n_cand_h)      # cp [L, Hf, S, K]
        ok = torch.arange(self.ring_k, device=pos.device) < state.ring_r
        pair = cp[:, :, 0] * self.C + cp[:, :, 1]          # [L, Hf, K]
        # the region's first column, held inside the histogram as JAX's
        # dynamic slice holds it. Only a finished slot that decodes on past
        # its reservation (a serving pool's) gets clamped; its joins past
        # the region are dropped, as JAX's segment_sum drops them
        c0 = torch.clamp(torch.div(pos[:, 0], bs, rounding_mode="floor"),
                         max=NB - W)
        rel = torch.div(pos, bs, rounding_mode="floor") - c0[:, None]
        ok = ok & (rel < W)
        cell = rel.clamp(max=W - 1)[None] * CC + pair      # [L, Hf, K]
        add = torch.zeros((L, Hf, W * CC), device=J.device).scatter_add_(
            2, cell, ok.float().expand_as(cell))           # exact counts
        cols = c0[:, None] + torch.arange(W, device=J.device)   # [Hf, W]
        heads = torch.arange(Hf, device=J.device)[:, None]
        region = J[:, heads, cols].int() + add.reshape(L, Hf, W, CC).int()
        J[:, heads, cols] = torch.clamp(region, max=255).to(J.dtype)

    def _jhist_join_batched(self, state: PQState, n_cand_h) -> None:
        """Count each slot's joining token (tail position n_cand) into its
        block's histogram, saturating (pq_search.py:971-990)."""
        L, Hf = state.jhist.shape[:2]
        N = state.codes.shape[-1]
        heads = torch.arange(Hf, device=n_cand_h.device)
        pos = n_cand_h.long().clamp(max=N - 1)
        joins = state.codes[:, heads, :, pos].long()       # [Hf, L, S]
        pair = (joins[..., 0] * self.C + joins[..., 1]).T  # [L, Hf]
        blk = torch.div(pos, self.select_block, rounding_mode="floor")
        pq.jhist_increment(state.jhist, (
            torch.arange(L, device=heads.device)[:, None], heads[None],
            blk[None], pair))

    def _encode(self, state: PQState, keys):
        """PQ codes [L, Hf, S, T] uint8 of keys [L, Hf, T, D] under each
        (layer, head)'s codebooks."""
        L, Hf, T, D = keys.shape
        G = L * Hf * self.S
        return pq.encode(
            pq.to_groups(keys.reshape(L * Hf, T, D), self.S),
            state.centroids.reshape(G, self.C, -1),
            state.phi.reshape(G, 1, 1), self.metric).reshape(
                L, Hf, self.S, T).to(torch.uint8)

    def commit_appends_batched(self, state: PQState, payloads,
                               shared) -> None:
        """Per-step append of every layer's new token: payloads = (k_new,
        v_new) [L, B·H_kv, D]. With the ring (the default) every slot's
        token lands at ring column ring_r, and the histogram joins one token
        per slot unless the joins are deferred; without it the tokens are
        encoded and written at n_cand + local of each slot."""
        k_new, v_new = payloads
        n_cand_h = shared["n_cand_h"]
        if state.ring_kv is not None:
            kv = (k_new if self.latent else torch.cat([k_new, v_new], -1)
                  ).to(state.ring_kv.dtype)
            state.ring_kv.index_copy_(2, state.ring_r.reshape(1).long(),
                                      kv[:, :, None])
            if self.use_jhist and not self._jhist_defer(state):
                self._jhist_join_batched(state, n_cand_h)
            state.ring_r += 1
            return
        L, Hf, D = k_new.shape
        if self.use_jhist:        # reads the codes before this step's write
            self._jhist_join_batched(state, n_cand_h)
        N = state.kv_tail.shape[2]
        pos = (n_cand_h.long() + self.budget.local).clamp(max=N - 1)
        heads = torch.arange(Hf, device=pos.device)
        state.kv_tail[:, heads, pos] = self._tail_kv(
            k_new[:, :, None], v_new[:, :, None], state)[:, :, 0]
        state.codes.transpose(2, 3)[:, heads, pos] = self._encode(
            state, k_new[:, :, None])[..., 0]

    def flush_ring_batched(self, state: PQState) -> None:
        """Commit the ring into the per-slot tails once per decode chunk
        (pq_search.py:1051-1088): encode the ring's keys, quantize for an
        int8 tail, and write ring_k rows per slot from n_cand + local -
        ring_r; rows past ring_r are overwritten by the next flush before
        they become valid. The deferred joins commit first."""
        if state.ring_kv is None:
            return
        if self._jhist_defer(state):
            self._jhist_flush_join(state)
        L, Hf, K, _ = state.ring_kv.shape
        keys, vals = self._kv_view(state.ring_kv)
        src = (self._tail_kv(keys, vals, state) if self.kv_int8
               else state.ring_kv.to(state.kv_tail.dtype))
        N = state.kv_tail.shape[2]
        start = (per_head(state.n_cand, self.H_kv).long() + self.budget.local
                 - state.ring_r).clamp(0, N - K)
        rows = start[:, None] + torch.arange(K, device=start.device)
        heads = torch.arange(Hf, device=rows.device)[:, None]
        state.kv_tail[:, heads, rows] = src
        state.codes.transpose(2, 3)[:, heads, rows] = self._encode(
            state, keys).transpose(2, 3)
        state.ring_r.zero_()

    def shared_pre_batched(self, state: PQState):
        return {"n_cand": state.n_cand,
                "n_cand_h": per_head(state.n_cand, self.H_kv),
                **self.kinds.shared(state)}

    def shared_post_batched(self, state: PQState, shared) -> None:
        state.n_cand += 1
        state.pos += 1
