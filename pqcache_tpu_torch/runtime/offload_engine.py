"""Offload-tier PQ engine: the KV in pinned host memory, decode driven one
layer at a time.

Counterpart of ``pqcache_tpu/runtime/offload_engine.py`` (``OffloadPQState``,
``OffloadEngine``). For contexts whose KV does not fit in device memory it
mirrors the reference's execution (pq_search.py decode path): per layer the
device scores the device-resident PQ codes (the joint-histogram block
scorer, or ADC gather-sum scores with block masses) and takes a block
top-k; the host classifies the selected blocks as hits of the device block
cache or misses, stages the misses from pinned memory on the store's copy
stream, and the device assembles the window and runs the rest of the
layer. Sink and local window stay on the device (a ring, cache_manager.py
:212-228); the growing candidate tail block lives on the device inside the
store and is always attended, so a generated token is reachable before its
block completes.

Selection is exact (``cache.stale_select`` off: each layer's block ids come
to the host once, a sync per layer) or one step stale (on: step t fetches
the blocks that step t-1's queries selected, so every layer runs without a
host sync and one ``.cpu()`` per step brings back the next selections and
the token; the first step runs exact and seeds them). The store's int8
mode (``cache.kv_dtype="int8"``) quantizes rows with per-channel scales
frozen at prefill before they reach the store and dequantizes the fetched
rows: host memory, PCIe bytes and the cache are halved.

Prefill is one pass (K2 through ``dense_prefill_attention``) or chunked
(``RuntimeConfig.prefill_chunk``: K2 at q_offset through
``llama.attn_mlp_chunk``), as a generator of bounded units that the batched
tier (``runtime/offload_batch.py``) advances one per decode step.

Sampling takes its Gumbel noise from a source with ``fill_`` (a
``core/sampling.GumbelNoise`` seeded with ``sample_seed`` unless the caller
passes one): one draw for the first token, one per decode step.
With ``metric="ip"`` the codebooks cluster keys lifted by sqrt(phi -
|k|^2) (phi kept per layer and group, evicted keys lifted with it) and the
blocks are ranked by mean lifted distance of ADC gather-sum scores: the
joint histogram is euclidean only (offload_engine.py:131, 170, 324-338).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core import pq, quant
from pqcache_tpu_torch.core.budget import Budget, compute_budget
from pqcache_tpu_torch.core.sampling import GumbelNoise, make_sampler
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.ops.attention_ref import \
    decode_window_attention_segments
from pqcache_tpu_torch.ops.dispatch import dense_prefill_attention
from pqcache_tpu_torch.policies.base import use_kernels
from pqcache_tpu_torch.runtime.generate import (bucket_length,
                                                chunk_plan_capped, params_to)
from pqcache_tpu_torch.runtime.host_offload import (HostKVStore,
                                                    assemble_blocks)

# a staged miss stack of at least this many blocks drains its layer before
# the next is staged (stale mode): the cache is far below the working set
BACKPRESSURE_BLOCKS = 256


@dataclasses.dataclass
class OffloadPQState:
    """Device state of the offload tier (layer-stacked; B·H_kv rows for the
    batched tier). The counters are host ints (single sequence) or host
    int64 arrays [B] (batched): nothing on the card reads them."""
    k_sink: torch.Tensor        # [L, H_kv, sink, D]
    v_sink: torch.Tensor
    k_local: torch.Tensor       # [L, H_kv, local, D] ring
    v_local: torch.Tensor
    codes: torch.Tensor         # [L, H_kv, S, N_tail] uint8
    centroids: torch.Tensor     # [L, H_kv, S, C, d(+1 for "ip")] f32
    phi: torch.Tensor           # [L, H_kv*S, 1, 1] f32 ("ip"; else zeros)
    n_cand: object
    ring_ptr: object
    pos: object
    jhist: Optional[torch.Tensor] = None    # [L, H_kv, NB, C^2] uint8
    # int8 store: per-(layer, head, channel) scales frozen at prefill
    k_scale: Optional[torch.Tensor] = None  # [L, H_kv, 1, D] f32
    v_scale: Optional[torch.Tensor] = None
    # batched tier: per-slot growing tail blocks [L, B·H_kv, bs, 2D]
    tail: Optional[torch.Tensor] = None


class OffloadEngine:
    """Single-sequence pq_search generation with host-offloaded KV.

    device: cuda unless given; params are moved there in ``dtype``.
    Tensor parallelism (``parallel/offload_tp.py``): ``comm``, the group of
    the row-parallel all-reduces, and ``shard``, this kv-head shard's
    (rank, size), by which k-means++ seeds each group's global index;
    params and cfg are then the shard's."""

    def __init__(self, cfg: EngineConfig, params: dict, dtype=torch.bfloat16,
                 device=None, *, comm=None, shard=(0, 1)):
        self.device = resolve_device(device)
        if cfg.runtime.policy != "pq_search":
            raise ValueError(f"the offload tier runs pq_search, not "
                             f"{cfg.runtime.policy!r}")
        if cfg.cache.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unsupported kv_dtype {cfg.cache.kv_dtype}")
        self.metric = cfg.pq.metric
        self.use_kernel = use_kernels(cfg)
        self.kv_int8 = cfg.cache.kv_dtype == "int8"
        self.cfg = cfg
        self.dtype = dtype
        self.params = params_to(params, self.device, dtype)
        m = cfg.model
        self.S = cfg.pq.n_subvec_per_head
        self.C = cfg.pq.n_centroids
        self.d_sub = m.head_dim // self.S
        self.bs = cfg.cache.block_size
        self.prefill_chunk = cfg.runtime.prefill_chunk
        # the joint-histogram block scorer where it applies (S = 2, block
        # at most 256, the euclidean metric), else ADC gather-sum scores
        self.use_jhist = (cfg.pq.scorer == "auto" and self.S == 2
                          and self.metric == "euc" and self.bs <= 256)
        self.sampler = make_sampler(cfg.runtime.temperature,
                                    cfg.runtime.top_k, cfg.runtime.top_p)
        self.stale = cfg.cache.stale_select
        # diagnostics: set to [] before generate() to record each decode
        # step's per-layer block selections (exact mode) / the logits [V]
        # of the prefill and of every decode step
        self.selection_log: Optional[list] = None
        self.logits_log: Optional[list] = None
        self.store: Optional[HostKVStore] = None
        self.timings: dict = {}
        self.budget: Optional[Budget] = None
        self.comm = comm
        self.shard = shard

    # -- state -------------------------------------------------------------

    def _budget(self, P: int, max_new: int) -> Budget:
        return compute_budget(self.cfg.budget, P, max_new)

    def _init_state(self, b: Budget, rows: int = 0) -> OffloadPQState:
        """Zero state of ``rows`` kv-head rows (H_kv unless given)."""
        m = self.cfg.model
        L, Hr, D = m.num_layers, rows or m.num_kv_heads, m.head_dim
        dev = self.device
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=dev)  # noqa
        return OffloadPQState(
            k_sink=z(L, Hr, b.sink, D), v_sink=z(L, Hr, b.sink, D),
            k_local=z(L, Hr, b.local, D), v_local=z(L, Hr, b.local, D),
            codes=torch.zeros((L, Hr, self.S, b.n_tail_max),
                              dtype=torch.uint8, device=dev),
            centroids=torch.zeros(
                (L, Hr, self.S, self.C,
                 self.d_sub + (self.metric == "ip")), device=dev),
            phi=torch.zeros((L, Hr * self.S, 1, 1), device=dev),
            n_cand=0, ring_ptr=0, pos=0,
            jhist=(torch.zeros((L, Hr, b.n_tail_max // self.bs,
                                self.C * self.C), dtype=pq.jhist_dtype(
                                    self.bs), device=dev)
                   if self.use_jhist else None),
            k_scale=(torch.ones((L, Hr, 1, D), device=dev)
                     if self.kv_int8 else None),
            v_scale=(torch.ones((L, Hr, 1, D), device=dev)
                     if self.kv_int8 else None))

    def _to_groups(self, x: torch.Tensor) -> torch.Tensor:
        """[H_kv, T, D] -> [H_kv*S, T, d_sub] subvector groups."""
        H_kv, T, _ = x.shape
        return (x.reshape(H_kv, T, self.S, self.d_sub).transpose(1, 2)
                .reshape(H_kv * self.S, T, self.d_sub))

    # -- prefill -----------------------------------------------------------

    def _tail_update(self, st: OffloadPQState, idx: int, k, v, pad_len: int,
                     true_len: int) -> None:
        """Codebooks and the layer's state from its full K/V [H_kv, P, D]
        (pad rows first): roll out the pad, split sink / local ring /
        candidates, train the PQ codebooks. The store takes the candidate
        rows straight from k/v."""
        b = self.budget
        P = k.shape[1]
        k_r = torch.roll(k, -int(pad_len), dims=1)
        v_r = torch.roll(v, -int(pad_len), dims=1)
        k_tail, v_tail = k_r[:, b.sink:], v_r[:, b.sink:]
        n_valid_tail = int(true_len) - b.sink
        xb = self._to_groups(k_tail)
        if self.metric == "ip":
            xb, st.phi[idx] = pq.ip2l2_lift(xb, n_valid_tail)
        gen = torch.Generator(device=k.device).manual_seed(
            self.cfg.pq.kmeans_seed)
        G = xb.shape[0]
        res = pq.kmeans(xb, self.C,
                        iters=self.cfg.pq.kmeans_iters,
                        valid_len=n_valid_tail, generator=gen,
                        group_offset=self.shard[0] * G,
                        total_groups=self.shard[1] * G)
        H_kv = k.shape[0]
        n_src = P - b.sink
        codes_src = res.codes.reshape(H_kv, self.S, n_src).to(torch.uint8)
        # the `local` most recent real tokens, in order (JAX's dynamic
        # slice clamps its start into range)
        s0 = min(max(n_valid_tail - b.local, 0), n_src - b.local)
        dt = st.k_sink.dtype
        if self.kv_int8:
            ks, vs = quant.kv_channel_scales(k_tail, v_tail, n_valid_tail)
            st.k_scale[idx], st.v_scale[idx] = ks, vs
        st.k_sink[idx] = k_r[:, :b.sink].to(dt)
        st.v_sink[idx] = v_r[:, :b.sink].to(dt)
        st.k_local[idx] = k_tail[:, s0:s0 + b.local].to(dt)
        st.v_local[idx] = v_tail[:, s0:s0 + b.local].to(dt)
        st.codes[idx, :, :, :n_src] = codes_src
        st.centroids[idx] = res.centroids.reshape(H_kv, self.S, self.C, -1)
        n_cand0 = max(n_valid_tail - b.local, 0)
        st.n_cand, st.ring_ptr, st.pos = n_cand0, 0, int(true_len)
        if self.use_jhist:
            st.jhist[idx] = pq.build_joint_hist(
                st.codes[idx], n_cand0, n_centroids=self.C, block=self.bs)

    @torch.no_grad()
    def _prefill_pass_steps(self, st: OffloadPQState, ids, P: int, pad: int,
                            true_len: int, chunked: bool, ch: int,
                            offload_fn, sync_fn):
        """The layer-by-layer prefill as a generator: it yields after each
        bounded unit (a layer; chunked: a layer's K/V, each chunk slab, the
        tail and offload). StopIteration.value is (last-token logits [V]
        f32, state). offload_fn(layer, k, v, state) stores a layer's K/V;
        sync_fn(layer) bounds the writes in flight. Needs self.budget."""
        m = self.cfg.model
        tokens = np.zeros((P,), np.int64)
        tokens[pad:] = np.asarray(ids, np.int64)
        tokens = torch.from_numpy(tokens).to(self.device)
        hidden = llama.embed_lookup(self.params, tokens)
        positions = torch.clamp(
            torch.arange(P, device=self.device) - pad, min=0)
        cos, sin = llama.rope_cos_sin(m, positions)
        for idx in range(m.num_layers):
            lp = llama._layer_params(self.params, idx)
            if chunked:
                k, v = llama.kv_full_chunked(m, lp, hidden, cos, sin, ch)
                yield
                for c0 in range(0, P, ch):
                    c1 = c0 + ch
                    hidden[c0:c1] = llama.attn_mlp_chunk(
                        m, lp, hidden[c0:c1], cos[c0:c1], sin[c0:c1], k,
                        v, pad, c0, use_kernel=self.use_kernel,
                        comm=self.comm)
                    yield
            else:
                kv = {}

                def attn_fn(q, k, v):
                    kv["k"], kv["v"] = k, v
                    return dense_prefill_attention(
                        q, k, v, pad, use_kernel=self.use_kernel)[0], None
                hidden, _ = llama._layer_fwd(m, lp, hidden, attn_fn, cos,
                                             sin, self.comm)
                k, v = kv["k"], kv["v"]
            self._tail_update(st, idx, k, v, pad, true_len)
            offload_fn(idx, k, v, st)
            del k, v
            sync_fn(idx)
            yield
        logits = llama._logits(m, self.params, hidden[P - 1:P])
        return logits, st

    def _prefill_pass(self, st, ids, P, pad, true_len, chunked, ch,
                      offload_fn, sync_fn):
        """The prefill generator drained in one go: (logits, state)."""
        gen = self._prefill_pass_steps(st, ids, P, pad, true_len, chunked,
                                       ch, offload_fn, sync_fn)
        while True:
            try:
                next(gen)
            except StopIteration as e:
                return e.value

    def quant_layer_kv(self, st: OffloadPQState, idx: int, k, v):
        """A layer's K/V quantized with its fresh scales for the int8
        store (unchanged for bf16)."""
        if not self.kv_int8:
            return k, v
        return (quant.quantize_channels(k, st.k_scale[idx]),
                quant.quantize_channels(v, st.v_scale[idx]))

    # -- decode ------------------------------------------------------------

    def _score_topk(self, st: OffloadPQState, idx: int, hidden, cos, sin,
                    n_sel: int):
        """Q/K/V of layer idx and its block top-k, ascending. hidden [1, E].
        Returns (q [H, 1, D], k_new, v_new [H_kv, 1, D], blk [H_kv, kb])."""
        m = self.cfg.model
        b = self.budget
        lp = llama._layer_params(self.params, idx)
        h_norm = llama.rms_norm(hidden, lp["ln1"], m.rms_norm_eps)
        yq, yk, yv = llama._products(h_norm, lp, ("wq", "wk", "wv"))
        k_new, v_new = llama._rope_kv(m, yk, yv, cos, sin)
        q = llama._rope_q(m, yq, cos, sin)
        return q, k_new, v_new, self._select(st, idx, q.reshape(
            q.shape[0], -1), n_sel)

    def _select(self, st: OffloadPQState, idx: int, q_flat, n_sel):
        """Block top-k of layer idx, ascending: [Hr, kb] for queries q_flat
        [Hr·g, D] (Hr a folded B·H_kv in the batched tier) and n_sel, the
        retrievable candidates (int, or [Hr])."""
        m = self.cfg.model
        b = self.budget
        q_sub = q_flat.reshape(q_flat.shape[0], self.S, self.d_sub)
        if self.metric == "ip":
            lut = pq.adc_lut_ip(pq.lift_query(q_sub), st.centroids[idx])
        else:
            lut = pq.adc_lut_euc(q_sub, st.centroids[idx])
        if self.use_jhist:
            mass = pq.joint_block_mass(lut, st.jhist[idx],
                                       head_dim=m.head_dim,
                                       kernel=self.use_kernel)
            blk = pq.topk_from_block_mass(mass, n_sel, b.topk,
                                          group=m.num_groups, block=self.bs)
        else:
            blk, _ = pq.mips_topk_blocks(
                pq.adc_gather_scores(lut, st.codes[idx]), n_sel, b.topk,
                group=m.num_groups, head_dim=m.head_dim, block=self.bs,
                metric=self.metric)
        return torch.sort(blk, -1).values

    def _window_rows(self, st, idx, blocks, blk_idx, slots, miss_pos,
                     n_sel):
        """The fetched rows as (k, v [Hr, kb·bs, D], mask [Hr, kb·bs]):
        rows of valid blocks below each row's n_sel (int or [Hr])."""
        Hr, kb, bs, D2 = blocks.shape
        D = D2 // 2
        rows = blocks.reshape(Hr, kb * bs, D2)
        tok = (blk_idx[:, :, None] * bs + torch.arange(
            bs, device=rows.device)).reshape(Hr, kb * bs)
        ok = ((slots >= 0) | (miss_pos >= 0))[:, :, None].expand(
            Hr, kb, bs).reshape(Hr, kb * bs)
        n = n_sel[:, None] if isinstance(n_sel, torch.Tensor) else n_sel
        dt = st.k_local.dtype
        if self.kv_int8:
            k, v = quant.dequant_kv(rows, st.k_scale[idx], st.v_scale[idx],
                                    dtype=dt)
        else:
            k, v = rows[..., :D].to(dt), rows[..., D:].to(dt)
        return k, v, (tok < n) & ok

    def _tail_kv(self, st, idx, tail):
        """The store-tail rows [Hr, bs, 2D] as (k, v) in the engine dtype."""
        D = tail.shape[-1] // 2
        dt = st.k_local.dtype
        if self.kv_int8:
            return quant.dequant_kv(tail, st.k_scale[idx], st.v_scale[idx],
                                    dtype=dt)
        return tail[..., :D].to(dt), tail[..., D:].to(dt)

    def _encode_evicted(self, st, idx, ev_k):
        """PQ codes [Hr, S] of evicted keys ev_k [Hr, 1, D]."""
        Hr = ev_k.shape[0]
        cent = st.centroids[idx].reshape(Hr * self.S, self.C, -1)
        xg = self._to_groups(ev_k)
        if self.metric == "ip":
            xg = pq.ip2l2_lift_with_phi(xg, st.phi[idx])
        return pq.pq_encode(xg, cent).reshape(Hr, self.S).to(torch.uint8)

    def _evicted_row(self, st, idx, ev_k, ev_v):
        """The store row [Hr, 2D] of evicted k/v [Hr, 1, D]."""
        if self.kv_int8:
            return quant.quantize_kv(ev_k, ev_v, st.k_scale[idx],
                                     st.v_scale[idx])[:, 0]
        return torch.cat([ev_k[:, 0], ev_v[:, 0]], -1)

    def _attn_and_tail(self, st: OffloadPQState, idx: int, hidden, q, k_new,
                       v_new, blk_idx, sel, tail, n_sel: int,
                       n_tail_att: int):
        """Window assembly, attention and the layer's MLP, then the ring
        evict: the oldest local token becomes candidate n_cand (its codes,
        its histogram count). The window is [sink | local ring | selected
        blocks | store tail (first n_tail_att rows) | new]. Returns (hidden,
        the evicted row for the store)."""
        m = self.cfg.model
        b = self.budget
        slots, miss_pos, staged, cache = sel
        blocks = assemble_blocks(cache, staged, slots, miss_pos)
        self.store.admit(idx)
        k_rows, v_rows, row_mask = self._window_rows(
            st, idx, blocks, blk_idx, slots, miss_pos, n_sel)
        k_tl, v_tl = self._tail_kv(st, idx, tail)
        H_kv = tail.shape[0]
        tail_mask = (torch.arange(self.bs, device=self.device)[None]
                     < n_tail_att).expand(H_kv, self.bs)
        dt = st.k_local.dtype
        out = decode_window_attention_segments(q, [
            (st.k_sink[idx], st.v_sink[idx], None),
            (st.k_local[idx], st.v_local[idx], None),
            (k_rows, v_rows, row_mask),
            (k_tl, v_tl, tail_mask),
            (k_new.to(dt), v_new.to(dt), None)])
        lp = llama._layer_params(self.params, idx)
        hidden = llama._finish_layer(m, lp, hidden,
                                     out.transpose(0, 1).reshape(1, -1),
                                     self.comm)
        ptr, n_cand = st.ring_ptr, st.n_cand
        ev_k = st.k_local[idx, :, ptr:ptr + 1].clone()
        ev_v = st.v_local[idx, :, ptr:ptr + 1].clone()
        ev_codes = self._encode_evicted(st, idx, ev_k)
        st.k_local[idx, :, ptr] = k_new[:, 0].to(dt)
        st.v_local[idx, :, ptr] = v_new[:, 0].to(dt)
        N_tail = st.codes.shape[-1]
        st.codes[idx, :, :, min(n_cand, N_tail - 1)] = ev_codes
        if self.use_jhist and n_cand // self.bs < st.jhist.shape[2]:
            pair = ev_codes[:, 0].long() * self.C + ev_codes[:, 1].long()
            pq.jhist_increment(st.jhist, (
                idx, torch.arange(H_kv, device=self.device),
                n_cand // self.bs, pair))
        return hidden, self._evicted_row(st, idx, ev_k, ev_v)

    def _next_token(self, logits, noise):
        """Greedy argmax, or one draw of the sampler from ``noise``."""
        if self.logits_log is not None:
            self.logits_log.append(logits.detach().float().cpu())
        if self.sampler is None:
            return torch.argmax(logits, -1)
        return self.sampler(logits, noise.fill_(torch.empty(
            logits.shape, dtype=torch.float32, device=logits.device)))

    # -- public API --------------------------------------------------------

    def generate(self, prompt_ids, max_new_tokens: int, eos_ids=(), *,
                 noise=None, forced=None) -> list:
        return list(self.stream(prompt_ids, max_new_tokens, eos_ids,
                                noise=noise, forced=forced))

    def _plan(self, true_len: int, max_new: int):
        """(P, pad, chunked, ch) of a prompt of true_len tokens; sets the
        budget."""
        rt = self.cfg.runtime
        P = min(bucket_length(true_len, rt.prefill_bucket), rt.max_seq_len)
        if true_len > P:
            raise ValueError(f"prompt {true_len} exceeds max_seq_len {P}")
        ch = self.prefill_chunk
        chunked = bool(ch) and P > ch
        if chunked:
            P, ch = chunk_plan_capped(P, ch, rt.max_seq_len)
            chunked = ch > 0
        self.budget = self._budget(P, max_new)
        return P, P - true_len, chunked, ch

    @torch.no_grad()
    def stream(self, prompt_ids, max_new_tokens: int, eos_ids=(), *,
               noise=None, forced=None):
        """Generate, yielding each token as its step completes.

        noise: the sampler's noise source (``fill_``); a GumbelNoise of
        sample_seed when None. forced: teacher forcing for accuracy checks
        — after step i the next step is fed forced[i] instead of the
        token the step produced (which is still yielded)."""
        cfg = self.cfg
        m = cfg.model
        self.timings = {"host_s": 0.0, "wait_s": 0.0, "decode_s": 0.0,
                        "steps": 0}
        ids = np.asarray(prompt_ids, np.int64)
        true_len = int(ids.shape[0])
        P, pad, chunked, ch = self._plan(true_len, max_new_tokens)
        b = self.budget
        # the previous generation's store goes first: two stores' pinned
        # memory and device caches need not coexist
        self.store = None
        st = self._init_state(b)
        store = HostKVStore(
            m.num_layers, m.num_kv_heads, b.n_tail_max, m.head_dim,
            block_size=self.bs, hbm_cache_tokens=cfg.cache.hbm_cache_tokens,
            cache_topk_blocks=cfg.cache.cache_topk_blocks,
            dtype=torch.int8 if self.kv_int8 else self.dtype,
            device=self.device)
        self.store = store
        stored = true_len - b.sink          # tail rows the prefill stores

        def offload_fn(idx, k, v, st_):
            k, v = self.quant_layer_kv(st_, idx, k, v)
            store.offload_layer_device(idx, k, v, stored, off=pad + b.sink)

        logits, st = self._prefill_pass(st, ids, P, pad, true_len, chunked,
                                        ch, offload_fn, store.sync_transfers)
        if self.sampler is not None and noise is None:
            noise = GumbelNoise(cfg.runtime.sample_seed, self.device)
        next_tok = int(self._next_token(logits, noise))
        yield next_tok
        fed = next_tok if forced is None else int(forced[0])

        L = m.num_layers
        pos = true_len
        n_cand_py = max(true_len - b.sink - b.local, 0)
        blk_prev = None
        tm = self.timings
        for step in range(max_new_tokens - 1):
            if fed in eos_ids:
                break
            t_step = time.perf_counter()
            hidden = llama.embed_lookup(
                self.params, torch.full((1,), fed, device=self.device))
            cos, sin = llama.rope_cos_sin(
                m, torch.full((1,), pos, device=self.device))
            # retrievable candidates: the scored region within complete
            # host blocks; evicted candidates past them are in the tail
            valid = int(store.valid[0])
            n_sel = min(n_cand_py, valid)
            n_tail_att = max(n_cand_py - valid, 0)
            q, k_new, v_new, blk = self._score_topk(st, 0, hidden, cos, sin,
                                                    n_sel)
            kv_evs, rec = [], []
            stale = self.stale and blk_prev is not None
            new_blks = [blk]
            for idx in range(L):
                t0 = time.perf_counter()
                if stale:
                    blk_np = blk_prev[idx]
                else:
                    blk_np = blk.cpu().numpy()        # sync: ids to host
                    rec.append(blk_np)
                t1 = time.perf_counter()
                tm["wait_s"] += t1 - t0
                slots, miss_pos, staged, cache = store.classify_blocks(
                    idx, blk_np)
                sel = (store.device_index(slots),
                       store.device_index(miss_pos), staged,
                       cache)
                blk_t = (blk if not stale else store.device_index(blk_np))
                tm["host_s"] += time.perf_counter() - t1
                hidden, kv_ev = self._attn_and_tail(
                    st, idx, hidden, q, k_new, v_new, blk_t, sel,
                    store.tail[idx], n_sel, n_tail_att)
                kv_evs.append(kv_ev)
                if idx < L - 1:
                    q, k_new, v_new, blk = self._score_topk(
                        st, idx + 1, hidden, cos, sin, n_sel)
                    new_blks.append(blk)
                    if (stale and store.cuda
                            and staged.shape[0] >= BACKPRESSURE_BLOCKS):
                        t0 = time.perf_counter()
                        torch.cuda.current_stream(self.device).synchronize()
                        tm["wait_s"] += time.perf_counter() - t0
            logits = llama._logits(m, self.params, hidden)
            nxt = self._next_token(logits, noise)
            st.n_cand += 1
            st.ring_ptr = (st.ring_ptr + 1) % b.local
            st.pos += 1
            t0 = time.perf_counter()
            if self.stale:
                # one pull: every layer's next selections and the token
                flat = torch.cat([torch.stack(new_blks).reshape(-1),
                                  nxt.reshape(1).to(new_blks[0].dtype)])
                flat = flat.cpu().numpy()
                blk_prev = list(flat[:-1].reshape(L, *new_blks[0].shape))
                nxt = int(flat[-1])
            else:
                nxt = int(nxt)
            tm["wait_s"] += time.perf_counter() - t0
            if self.selection_log is not None and rec:
                self.selection_log.append([x.copy() for x in rec])
            # evictions past the prefilled region extend the store (the
            # first `local` evictions re-evict stored prompt rows)
            if n_cand_py >= stored:
                for idx, kv_ev in enumerate(kv_evs):
                    store.append_row_device(idx, kv_ev)
            n_cand_py += 1
            pos += 1
            tm["decode_s"] += time.perf_counter() - t_step
            tm["steps"] += 1
            yield nxt
            fed = nxt if forced is None else int(forced[step + 1])
        store.flush()

