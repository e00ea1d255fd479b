"""The host-offload tier: PQ retrieval with the KV in pinned host memory,
decode driven one layer at a time, over B sequence slots that share one
host store and one device block cache.

Counterpart of ``pqcache_tpu/runtime/offload_engine.py`` (``OffloadPQState``,
``OffloadEngine``) and ``pqcache_tpu/runtime/offload_batch.py``
(``BatchOffloadEngine``). For contexts whose KV does not fit in device memory
it mirrors the reference's execution (pq_search.py decode path): per layer
the device scores the device-resident PQ codes (the joint-histogram block
scorer, or ADC gather-sum scores with block masses) and takes a block top-k;
the host classifies the selected blocks as hits of the device block cache or
misses, stages the misses from pinned memory on the store's copy stream, and
the device assembles the window and runs the rest of the layer. Sink and
local window stay on the device (a ring, cache_manager.py:212-228); each
slot's growing candidate tail block lives on the device and is always
attended, so a generated token is reachable before its block completes.

``BatchOffloadEngine`` is the one core, and ``OffloadEngine``
(``runtime/offload_engine.py``) is it at one slot. The B slots fold into
the kv-head axis, as ``policies/pq_search.py``'s batch-as-heads layout
does:

  * state tensors [L, B·H_kv, ...], per-slot counters [B] on the host;
  * block ids carry a per-slot prefix (slot · blocks_per_slot + block), so
    one ``HostKVStore`` holds every slot's blocks, one LFU and device cache
    serve them all, and each layer's misses of the whole batch stage at
    once, with an explicit ``ok`` mask of the valid ids;
  * per-slot tail blocks [L, B·H_kv, bs, 2D] with per-slot fill cursors; a
    filled tail goes to the host between steps.

Selection is exact (``cache.stale_select`` off: each layer's block ids come
to the host once, a sync per layer) or one step stale (on: step t fetches
the blocks that step t-1's queries selected, so every layer runs without a
host sync and one ``.cpu()`` per step brings back the next selections and
the tokens; the first step after an admission runs exact and seeds them).
The store's int8 mode (``cache.kv_dtype="int8"``) quantizes rows with
per-channel scales frozen at prefill before they reach the store and
dequantizes the fetched rows: host memory, PCIe bytes and the cache are
halved.

Prefill is one pass (K2 through ``dense_prefill_attention``) or chunked
(``RuntimeConfig.prefill_chunk``: K2 at q_offset through
``llama.attn_mlp_chunk``), as a generator of bounded units into a
one-sequence state that is folded into its slot at the end. ``serve``
admits FIFO into free slots, one prefill unit per decode step; a finished
slot retires: its id range is invalidated in the store and the LFU
(``invalidate_blocks``), so the next occupant's ids never hit the old rows.
``admit_prefilled`` takes a prompt's K/V prefilled elsewhere (the sharded
tier's ring prefill). Decode per layer mirrors the JAX program: every
slot's selection and window, the ring evict of every slot (a slot that is
not live evicts too, into its own rows, and its tokens are dropped), the
tail append of the slots whose eviction enters the store.

Sampling takes its Gumbel noise from a source with ``fill_`` (a
``core/sampling.GumbelNoise`` seeded with ``sample_seed`` unless the caller
passes one): one draw for each first token, one per decode step. With
``metric="ip"`` the codebooks cluster keys lifted by sqrt(phi - |k|^2) (phi
kept per layer and group, evicted keys lifted with it) and the blocks are
ranked by mean lifted distance of ADC gather-sum scores: the joint
histogram is euclidean only (offload_engine.py:131, 170, 324-338).
Tensor parallelism (``parallel/offload_tp.py``): ``comm``, the group of the
row-parallel all-reduces, and ``shard``, this kv-head shard's (rank, size),
by which k-means++ seeds each group's global index; params and cfg are
then the shard's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core import pq, quant
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.core.sampling import GumbelNoise, make_sampler
from pqcache_tpu_torch.models import llama, require_llama
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
    """Device state of the offload tier, layer-stacked over R kv-head rows
    (H_kv for a prefill, B·H_kv for the slots). The slots' counters are
    host int64 arrays [B]: nothing on the card reads them."""
    k_sink: torch.Tensor        # [L, R, sink, D]
    v_sink: torch.Tensor
    k_local: torch.Tensor       # [L, R, local, D] ring
    v_local: torch.Tensor
    codes: torch.Tensor         # [L, R, S, N_tail] uint8
    centroids: torch.Tensor     # [L, R, S, C, d(+1 for "ip")] f32
    phi: torch.Tensor           # [L, R*S, 1, 1] f32 ("ip"; else zeros)
    jhist: Optional[torch.Tensor] = None    # [L, R, NB, C^2] uint8
    # int8 store: per-(layer, head, channel) scales frozen at prefill
    k_scale: Optional[torch.Tensor] = None  # [L, R, 1, D] f32
    v_scale: Optional[torch.Tensor] = None
    # the slots': tail blocks [L, B·H_kv, bs, 2D] and counters [B]
    tail: Optional[torch.Tensor] = None
    n_cand: Optional[np.ndarray] = None
    ring_ptr: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None


@dataclasses.dataclass
class _OSlot:
    seq_id: Optional[int] = None
    tokens: Optional[list] = None
    done: bool = True


@dataclasses.dataclass
class _OAdmission:
    """An admission in flight: its prefill advanced one bounded unit at a
    time (``_prefill_steps``)."""
    slot: int
    seq_id: int
    gen: object                 # the prefill's step generator
    st: OffloadPQState          # the one-sequence state it fills
    rems: list                  # per layer: the remainder rows [H_kv, bs, 2D]
    true_len: int


class BatchOffloadEngine:
    """pq_search decode with host-offloaded KV over B slots.

    ``generate_batch`` serves a fixed batch, all slots prefilled first;
    ``serve`` is continuous: requests admit into free slots one prefill
    unit per decode step, finished slots retire. device: cuda unless
    given; params are moved there in ``dtype``."""

    def __init__(self, cfg: EngineConfig, params: dict, *, batch_size: int,
                 dtype=torch.bfloat16, device=None, comm=None, shard=(0, 1)):
        require_llama(cfg.model, type(self).__name__)
        if cfg.runtime.policy != "pq_search":
            raise ValueError(f"the offload tier runs pq_search, not "
                             f"{cfg.runtime.policy!r}")
        if cfg.cache.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unsupported kv_dtype {cfg.cache.kv_dtype}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.B = batch_size
        self.dtype = dtype
        self.params = params_to(params, self.device, dtype)
        m = cfg.model
        self.H_kv, self.D = m.num_kv_heads, m.head_dim
        self.S = cfg.pq.n_subvec_per_head
        self.C = cfg.pq.n_centroids
        self.bs = cfg.cache.block_size
        self.metric = cfg.pq.metric
        self.use_kernel = use_kernels(cfg)
        self.kv_int8 = cfg.cache.kv_dtype == "int8"
        # the joint-histogram block scorer where it applies, else ADC
        # gather-sum scores
        self.use_jhist = pq.jhist_applies(cfg.pq, self.bs)
        self.sampler = make_sampler(cfg.runtime.temperature,
                                    cfg.runtime.top_k, cfg.runtime.top_p)
        self.stale = cfg.cache.stale_select
        self.comm = comm
        self.shard = shard
        # diagnostics: set to [] before a run to record each exact decode
        # step's per-layer block selections [B·H_kv, kb] / the logits of
        # each admission's prefill [V] and of every decode step [B, V]
        self.selection_log: Optional[list] = None
        self.logits_log: Optional[list] = None
        self.store: Optional[HostKVStore] = None
        self.timings: dict = {}
        self.budget = None
        self.noise = None
        self._blk_stale: Optional[np.ndarray] = None   # [L, B·H_kv, kb]

    # -- run setup ------------------------------------------------------------

    def setup(self, max_prompt_len: int, max_new_tokens: int,
              noise=None) -> None:
        """Pool-wide run state: one prefill length ``P`` (one budget) for
        every slot, ``chunked`` whether it prefills in chunks, the shared
        store sized to B id ranges (the previous run's goes first: two
        stores' pinned memory and device caches need not coexist), the
        zero state and the per-slot host counters."""
        cfg, B = self.cfg, self.B
        m, rt = cfg.model, cfg.runtime
        P = min(bucket_length(max_prompt_len, rt.prefill_bucket),
                rt.max_seq_len)
        if max_prompt_len > P:
            raise ValueError(f"prompt {max_prompt_len} exceeds max_seq_len "
                             f"{P}")
        ch = rt.prefill_chunk
        chunked = bool(ch) and P > ch
        if chunked:
            P, ch = chunk_plan_capped(P, ch, rt.max_seq_len)
            chunked = ch > 0
        self.P, self.chunked, self._ch = P, chunked, ch
        self.budget = b = compute_budget(cfg.budget, P, max_new_tokens)
        self._blocks_per_slot = -(-b.n_tail_max // self.bs)
        self.timings = {"host_s": 0.0, "wait_s": 0.0, "decode_s": 0.0,
                        "steps": 0}
        self.store = None
        self.store = HostKVStore(
            m.num_layers, self.H_kv, B * self._blocks_per_slot * self.bs,
            self.D, block_size=self.bs,
            hbm_cache_tokens=cfg.cache.hbm_cache_tokens,
            cache_topk_blocks=cfg.cache.cache_topk_blocks,
            dtype=torch.int8 if self.kv_int8 else self.dtype,
            device=self.device)
        bst = self._zero_state(B * self.H_kv)
        bst.tail = torch.zeros((m.num_layers, B * self.H_kv, self.bs,
                                2 * self.D), dtype=self.store.dtype,
                               device=self.device)
        bst.n_cand, bst.ring_ptr, bst.pos = (np.zeros((B,), np.int64)
                                             for _ in range(3))
        self.bstate = bst
        self._stored = np.zeros((B,), np.int64)   # prefill rows per slot
        self._valid = np.zeros((B,), np.int64)    # complete-block rows
        self._fill = np.zeros((B,), np.int64)     # tail cursor
        self._ncand = np.zeros((B,), np.int64)
        self.noise = noise
        if self.sampler is not None and noise is None:
            self.noise = GumbelNoise(rt.sample_seed, self.device)
        self.slots: List[_OSlot] = [_OSlot() for _ in range(B)]
        self._head_slot = np.repeat(np.arange(B), self.H_kv)
        self._blk_stale = None

    def _zero_state(self, rows: int) -> OffloadPQState:
        """Zero state of ``rows`` kv-head rows."""
        L, D, S, C = self.cfg.model.num_layers, self.D, self.S, self.C
        b, dev = self.budget, self.device
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=dev)  # noqa
        one = lambda: (torch.ones((L, rows, 1, D), device=dev)  # noqa: E731
                       if self.kv_int8 else None)
        return OffloadPQState(
            k_sink=z(L, rows, b.sink, D), v_sink=z(L, rows, b.sink, D),
            k_local=z(L, rows, b.local, D), v_local=z(L, rows, b.local, D),
            codes=torch.zeros((L, rows, S, b.n_tail_max), dtype=torch.uint8,
                              device=dev),
            centroids=torch.zeros(
                (L, rows, S, C, D // S + (self.metric == "ip")), device=dev),
            phi=torch.zeros((L, rows * S, 1, 1), device=dev),
            jhist=(torch.zeros((L, rows, b.n_tail_max // self.bs, C * C),
                               dtype=pq.jhist_dtype(self.bs), device=dev)
                   if self.use_jhist else None),
            k_scale=one(), v_scale=one())

    # -- prefill and admission ------------------------------------------------

    def _tail_update(self, st: OffloadPQState, idx: int, k, v, pad: int,
                     true_len: int) -> None:
        """Layer idx of a one-sequence state from its full K/V [H_kv, P, D]
        (pad rows first): codebooks, sink, the local ring (the ``local``
        most recent real tokens, in order), codes, histogram and int8
        scales. The store takes the candidate rows straight from k/v."""
        b = self.budget
        t = pq.train_layer(k, v, pad, true_len, sink=b.sink, S=self.S,
                           C=self.C, metric=self.metric,
                           iters=self.cfg.pq.kmeans_iters,
                           seed=self.cfg.pq.kmeans_seed, shard=self.shard,
                           int8_scales=self.kv_int8)
        n_src = k.shape[1] - b.sink
        # JAX's dynamic slice clamps the ring's start into range
        s0 = min(max(t.n_valid - b.local, 0), n_src - b.local)
        dt = st.k_sink.dtype
        if self.kv_int8:
            st.k_scale[idx], st.v_scale[idx] = t.k_scale, t.v_scale
        st.k_sink[idx], st.v_sink[idx] = t.k_sink.to(dt), t.v_sink.to(dt)
        st.k_local[idx] = t.k_tail[:, s0:s0 + b.local].to(dt)
        st.v_local[idx] = t.v_tail[:, s0:s0 + b.local].to(dt)
        st.codes[idx, :, :, :n_src] = t.codes.to(torch.uint8)
        st.centroids[idx] = t.centroids
        if t.phi is not None:
            st.phi[idx] = t.phi
        if self.use_jhist:
            st.jhist[idx] = pq.build_joint_hist(
                st.codes[idx], max(t.n_valid - b.local, 0),
                n_centroids=self.C, block=self.bs)

    def _offload_layer(self, slot: int, st: OffloadPQState, idx: int, k, v,
                       pad: int, true_len: int) -> torch.Tensor:
        """Layer idx's prompt rows past the sink (quantized for an int8
        store) into the slot's id range of the store: complete blocks to
        the host; returns the remainder rows zero-padded to a block [H_kv,
        bs, 2D] (rows past the fill cursor are never read)."""
        if self.kv_int8:
            k = quant.quantize_channels(k, st.k_scale[idx])
            v = quant.quantize_channels(v, st.v_scale[idx])
        b = self.budget
        part = self.store.offload_blocks_device(
            idx, k, v, true_len - b.sink, pad + b.sink,
            id_base=slot * self._blocks_per_slot)
        if part is None:
            return torch.zeros((self.H_kv, self.bs, 2 * self.D),
                               dtype=self.store.dtype, device=self.device)
        return F.pad(part, (0, 0, 0, self.bs - part.shape[1]))

    @torch.no_grad()
    def _prefill_steps(self, st: OffloadPQState, ids, pad: int,
                       true_len: int, offload_fn):
        """The layer-by-layer prefill of ``ids`` into ``st`` as a generator:
        it yields after each bounded unit (a layer; chunked: a layer's K/V,
        each chunk slab, the tail and offload). StopIteration.value is the
        last token's logits [V] f32. offload_fn(layer, k, v) stores a
        layer's K/V."""
        m, P, ch = self.cfg.model, self.P, self._ch
        tokens = np.zeros((P,), np.int64)
        tokens[pad:] = ids
        tokens = torch.from_numpy(tokens).to(self.device)
        hidden = llama.embed_lookup(self.params, tokens)
        positions = torch.clamp(
            torch.arange(P, device=self.device) - pad, min=0)
        cos, sin = llama.rope_cos_sin(m, positions)
        for idx in range(m.num_layers):
            lp = llama._layer_params(self.params, idx)
            if self.chunked:
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
            offload_fn(idx, k, v)
            del k, v
            self.store.sync_transfers(idx)
            yield
        return llama._logits(m, self.params, hidden[P - 1:P])

    def _admission_start(self, slot: int, seq_id: int,
                         ids: np.ndarray) -> _OAdmission:
        """Open slot ``slot`` for ``ids``; the admission advances one unit
        per ``_admission_step``."""
        ids = np.asarray(ids, np.int64)
        true_len = int(ids.shape[0])
        pad = self.P - true_len
        if pad < 0:
            raise ValueError(f"prompt {true_len} > pool prefill {self.P}")
        st = self._zero_state(self.H_kv)
        rems: list = []
        gen = self._prefill_steps(
            st, ids, pad, true_len, lambda idx, k, v: rems.append(
                self._offload_layer(slot, st, idx, k, v, pad, true_len)))
        return _OAdmission(slot=slot, seq_id=seq_id, gen=gen, st=st,
                           rems=rems, true_len=true_len)

    def _admission_step(self, adm: _OAdmission) -> bool:
        """Advance one prefill unit; True once the admission is done (first
        token taken, state folded in, slot live)."""
        try:
            next(adm.gen)
            return False
        except StopIteration as e:
            self._admit(adm.slot, adm.seq_id, adm.st, adm.rems, e.value,
                        adm.true_len)
        return True

    @torch.no_grad()
    def admit_prefilled(self, slot: int, kv: torch.Tensor, logits,
                        pad: int, true_len: int) -> None:
        """Admit a prompt prefilled elsewhere into slot ``slot`` (after
        ``setup``): kv [L, H_kv, P, 2D] its per-layer K‖V (pad rows
        first), logits [V] its last token's. Each layer's state and
        codebooks are built and its rows offloaded as a prefill's are."""
        st = self._zero_state(self.H_kv)
        rems = []
        for idx in range(kv.shape[0]):
            k, v = kv[idx, ..., :self.D], kv[idx, ..., self.D:]
            self._tail_update(st, idx, k, v, pad, true_len)
            rems.append(self._offload_layer(slot, st, idx, k, v, pad,
                                            true_len))
            self.store.sync_transfers(idx)
        self._admit(slot, slot, st, rems, logits, true_len)

    @torch.no_grad()
    def _admit(self, slot: int, seq_id: int, st: OffloadPQState, rems,
               logits, true_len: int) -> None:
        """Take the first token from the prefill's logits, fold the
        prefilled state and its remainder rows into slot ``slot``, set its
        counters and make it live."""
        first = int(self._next_token(logits, self.noise))
        bst, b = self.bstate, self.budget
        hs = slice(slot * self.H_kv, (slot + 1) * self.H_kv)
        for name in ("k_sink", "v_sink", "k_local", "v_local", "codes",
                     "centroids", "jhist", "k_scale", "v_scale"):
            dst = getattr(bst, name)
            if dst is not None:
                dst[:, hs] = getattr(st, name)
        bst.phi[:, hs.start * self.S:hs.stop * self.S] = st.phi
        bst.tail[:, hs] = torch.stack(rems)
        bst.n_cand[slot] = max(true_len - b.sink - b.local, 0)
        bst.ring_ptr[slot] = 0
        bst.pos[slot] = true_len
        # stale selections of this slot's rows came from the previous
        # occupant: the next step runs exact and reseeds them
        self._blk_stale = None
        n_store = true_len - b.sink
        self._stored[slot] = n_store
        self._valid[slot] = n_store // self.bs * self.bs
        self._fill[slot] = n_store - self._valid[slot]
        self._ncand[slot] = bst.n_cand[slot]
        self.slots[slot] = _OSlot(seq_id=seq_id, tokens=[first], done=False)

    def _retire(self, slot: int) -> None:
        """Free a finished slot: invalidate its id range in the shared store
        (LFU entries erased, cache slots recycled) and zero its host
        counters, so the decode step masks it out."""
        base = slot * self._blocks_per_slot
        self.store.invalidate_blocks(
            np.arange(base, base + self._blocks_per_slot, dtype=np.int32))
        self._stored[slot] = 0
        self._valid[slot] = 0
        self._fill[slot] = 0
        self._ncand[slot] = 0
        self.slots[slot] = _OSlot()

    # -- the layer step ---------------------------------------------------------

    def _score_topk(self, idx: int, hidden, cos, sin, n_sel_h):
        """Q/K/V and per-slot block top-k of layer idx. hidden [B, E];
        cos/sin [B, D/2]; n_sel_h [B·H_kv], each row's retrievable
        candidates. Returns (q [B·H, 1, D], k_new, v_new [B·H_kv, D], blk
        [B·H_kv, kb] slot-local ids, ascending)."""
        m, st, b = self.cfg.model, self.bstate, self.budget
        B = hidden.shape[0]
        H, Hk, D = m.num_heads, self.H_kv, self.D
        lp = llama._layer_params(self.params, idx)
        h_norm = llama.rms_norm(hidden, lp["ln1"], m.rms_norm_eps)
        yq, yk, yv = llama._products(h_norm, lp, ("wq", "wk", "wv"))
        q = llama._apply_rope_batched(yq.reshape(B, H, D), cos, sin)
        k_new = llama._apply_rope_batched(yk.reshape(B, Hk, D), cos, sin)
        lut = pq.adc_lut(q.reshape(B * H, D), st.centroids[idx], self.S,
                         self.metric)
        if self.use_jhist:
            mass = pq.joint_block_mass(lut, st.jhist[idx], head_dim=D,
                                       kernel=self.use_kernel)
            blk = pq.topk_from_block_mass(mass, n_sel_h, b.topk,
                                          group=m.num_groups, block=self.bs)
        else:
            blk, _ = pq.mips_topk_blocks(
                pq.adc_gather_scores(lut, st.codes[idx]), n_sel_h, b.topk,
                group=m.num_groups, head_dim=D, block=self.bs,
                metric=self.metric)
        return (q.reshape(B * H, 1, D), k_new.reshape(B * Hk, D),
                yv.reshape(B * Hk, D), torch.sort(blk, -1).values)

    def _kv(self, idx: int, rows):
        """Store rows [..., 2D] as (k, v) in the engine dtype (dequantized
        with layer idx's scales for an int8 store)."""
        dt = self.bstate.k_local.dtype
        if self.kv_int8:
            return quant.dequant_kv(rows, self.bstate.k_scale[idx],
                                    self.bstate.v_scale[idx], dtype=dt)
        return rows[..., :self.D].to(dt), rows[..., self.D:].to(dt)

    def _attn_evict(self, idx: int, hidden, q, k_new, v_new, blk_idx, sel,
                    step: dict):
        """Window assembly, attention and MLP of layer idx for every slot,
        then each slot's ring evict and, where ``step["app_h"]`` says so,
        its store-tail append. The window is [sink | local ring | selected
        blocks (rows below n_sel) | tail (its first n_tail rows) | new].
        Returns hidden [B, E]."""
        m, st = self.cfg.model, self.bstate
        B, Hk, D, bs = hidden.shape[0], self.H_kv, self.D, self.bs
        slots, miss_pos, staged, cache = sel
        blocks = assemble_blocks(cache, staged, slots, miss_pos)
        self.store.admit(idx)
        BH, kb = blocks.shape[:2]
        k_rows, v_rows = self._kv(idx, blocks.reshape(BH, kb * bs, 2 * D))
        tok = (blk_idx[:, :, None] * bs
               + torch.arange(bs, device=self.device)).reshape(BH, kb * bs)
        ok = ((slots >= 0) | (miss_pos >= 0))[:, :, None].expand(
            BH, kb, bs).reshape(BH, kb * bs)
        k_tl, v_tl = self._kv(idx, st.tail[idx])
        dt = st.k_local.dtype
        out = decode_window_attention_segments(q, [
            (st.k_sink[idx], st.v_sink[idx], None),
            (st.k_local[idx], st.v_local[idx], None),
            (k_rows, v_rows, (tok < step["n_sel_h"][:, None]) & ok),
            (k_tl, v_tl, torch.arange(bs, device=self.device)[None]
             < step["n_tail_h"][:, None]),
            (k_new[:, None].to(dt), v_new[:, None].to(dt), None)])
        lp = llama._layer_params(self.params, idx)
        hidden = llama._finish_layer(m, lp, hidden,
                                     out.reshape(B, m.num_heads * D),
                                     self.comm)
        # ring evict of every slot: the oldest local row out, the new token
        # in, the evicted key encoded as candidate n_cand[slot]
        heads, ptr_h = step["heads"], step["ptr_h"]
        ev_k = st.k_local[idx, heads, ptr_h][:, None]          # [BH, 1, D]
        ev_v = st.v_local[idx, heads, ptr_h][:, None]
        ev_codes = pq.encode(
            pq.to_groups(ev_k, self.S),
            st.centroids[idx].reshape(BH * self.S, self.C, -1), st.phi[idx],
            self.metric).reshape(BH, self.S).to(torch.uint8)
        kv_ev = (quant.quantize_kv(ev_k, ev_v, st.k_scale[idx],
                                   st.v_scale[idx])[:, 0] if self.kv_int8
                 else torch.cat([ev_k[:, 0], ev_v[:, 0]], -1))
        st.k_local[idx, heads, ptr_h] = k_new.to(dt)
        st.v_local[idx, heads, ptr_h] = v_new.to(dt)
        st.codes[idx, heads[:, None], step["subs"], step["code_col"]] = \
            ev_codes
        app = step["app_h"]
        if app is not None:
            st.tail[idx, app, step["fill_app"]] = kv_ev[app].to(
                st.tail.dtype)
        jh = step["jhist_rows"]
        if jh is not None:
            pair = ev_codes[:, 0].long() * self.C + ev_codes[:, 1].long()
            pq.jhist_increment(st.jhist, (idx, jh, step["jhist_blk"],
                                          pair[jh]))
        return hidden

    def _next_token(self, logits, noise):
        """Greedy argmax, or one draw of the sampler from ``noise``."""
        if self.logits_log is not None:
            self.logits_log.append(logits.detach().float().cpu())
        if self.sampler is None:
            return torch.argmax(logits, -1)
        return self.sampler(logits, noise.fill_(torch.empty(
            logits.shape, dtype=torch.float32, device=logits.device)))

    # -- the decode step --------------------------------------------------------

    def _step_indices(self, do_app: np.ndarray) -> dict:
        """The step's per-row counts and write positions as device tensors
        (the counters are host arrays; no host sync)."""
        B, Hk, bs = self.B, self.H_kv, self.bs
        st = self.bstate
        ix = self.store.device_index
        n_sel = np.minimum(self._ncand, self._valid)
        n_tail = np.maximum(self._ncand - self._valid, 0)
        N_tail = st.codes.shape[-1]
        app_h = np.flatnonzero(np.repeat(do_app, Hk))
        blk_h = np.repeat(st.n_cand // bs, Hk)
        jrows = np.flatnonzero(blk_h < (st.jhist.shape[2] if self.use_jhist
                                        else 0))
        return dict(
            n_sel_h=ix(np.repeat(n_sel, Hk)),
            n_tail_h=ix(np.repeat(n_tail, Hk)),
            heads=ix(np.arange(B * Hk)), ptr_h=ix(np.repeat(st.ring_ptr, Hk)),
            subs=ix(np.arange(self.S))[None],
            code_col=ix(np.repeat(np.minimum(st.n_cand, N_tail - 1),
                                  Hk))[:, None],
            app_h=ix(app_h) if app_h.size else None,
            fill_app=ix(np.repeat(self._fill, Hk)[app_h]),
            jhist_rows=ix(jrows) if jrows.size else None,
            jhist_blk=ix(blk_h[jrows]))

    @torch.no_grad()
    def _decode_step(self, next_toks: np.ndarray,
                     active: np.ndarray) -> np.ndarray:
        """One decode step over all B slots (a slot that is not live is
        masked: no selection, no append; its token is dropped). Returns the
        next tokens [B]."""
        t_step = time.perf_counter()
        B, Hk, L = self.B, self.H_kv, self.cfg.model.num_layers
        tm, st, store = self.timings, self.bstate, self.store
        ix = store.device_index
        do_app = (self._ncand >= self._stored) & active
        step = self._step_indices(do_app)
        hidden = llama.embed_lookup(self.params, ix(np.asarray(next_toks)))
        cos, sin = llama.rope_cos_sin(self.cfg.model, ix(st.pos))
        q, k_new, v_new, blk = self._score_topk(0, hidden, cos, sin,
                                                step["n_sel_h"])
        cb_h = (self._valid // self.bs)[self._head_slot]   # complete blocks
        base_h = (np.arange(B) * self._blocks_per_slot)[self._head_slot]
        act_h = active[self._head_slot]
        stale = self.stale and self._blk_stale is not None
        new_blks, rec = [blk], []
        for idx in range(L):
            t0 = time.perf_counter()
            if stale:
                blk_np = self._blk_stale[idx]
            else:
                blk_np = blk.cpu().numpy()                    # sync
                rec.append(blk_np)
            t1 = time.perf_counter()
            tm["wait_s"] += t1 - t0
            ok = (blk_np < cb_h[:, None]) & act_h[:, None]
            gids = np.where(ok, blk_np + base_h[:, None], 0)
            slots, miss_pos, staged, cache = store.classify_blocks(
                idx, gids, ok=ok)
            sel = (ix(slots), ix(miss_pos), staged, cache)
            blk_t = ix(blk_np) if stale else blk
            tm["host_s"] += time.perf_counter() - t1
            hidden = self._attn_evict(idx, hidden, q, k_new, v_new, blk_t,
                                      sel, step)
            if idx < L - 1:
                q, k_new, v_new, blk = self._score_topk(
                    idx + 1, hidden, cos, sin, step["n_sel_h"])
                new_blks.append(blk)
                if (stale and store.cuda
                        and staged.shape[0] >= BACKPRESSURE_BLOCKS):
                    t0 = time.perf_counter()
                    torch.cuda.current_stream(self.device).synchronize()
                    tm["wait_s"] += time.perf_counter() - t0
        m = self.cfg.model
        last = llama.rms_norm(hidden, self.params["final_norm"],
                              m.rms_norm_eps)
        nxt = self._next_token(llama.lm_head_logits(self.params, last),
                               self.noise)
        st.n_cand += 1
        st.ring_ptr = (st.ring_ptr + 1) % self.budget.local
        st.pos += 1
        t0 = time.perf_counter()
        if self.stale:
            # one pull: every layer's next selections and the tokens
            flat = torch.cat([torch.stack(new_blks).reshape(-1),
                              nxt.reshape(-1).to(new_blks[0].dtype)])
            flat = flat.cpu().numpy()
            BH, kb = new_blks[0].shape
            self._blk_stale = flat[:L * BH * kb].reshape(L, BH, kb)
            nxt = flat[L * BH * kb:]
        else:
            nxt = nxt.cpu().numpy()
        tm["wait_s"] += time.perf_counter() - t0
        if self.selection_log is not None and rec:
            self.selection_log.append([x.copy() for x in rec])
        self._ncand += active.astype(np.int64)
        self._fill += do_app.astype(np.int64)
        for b_i in np.flatnonzero(self._fill == self.bs):
            # the filled tail block goes to the host
            ext = st.tail[:, b_i * Hk:(b_i + 1) * Hk].clone()
            gid = (b_i * self._blocks_per_slot
                   + int(self._valid[b_i]) // self.bs)
            for layer in range(L):
                store.adopt_block_device(layer, ext[layer], block_id=gid)
            self._valid[b_i] += self.bs
            self._fill[b_i] = 0
        tm["decode_s"] += time.perf_counter() - t_step
        tm["steps"] += 1
        return nxt

    # -- public API -------------------------------------------------------------

    def generate_batch(self, prompts, max_new_tokens: int, eos_ids=(), *,
                       noise=None, forced=None) -> List[list]:
        """Decode B prompts concurrently (all slots prefilled first).
        noise: the sampler's noise source; GumbelNoise of sample_seed when
        None. forced: teacher forcing for accuracy checks, a token list per
        slot: after step i slot s is fed forced[s][i] instead of the token
        it produced (which is still returned). Returns a list of token
        lists."""
        if len(prompts) != self.B:
            raise ValueError(f"need exactly {self.B} prompts, "
                             f"got {len(prompts)}")
        prompts = [np.asarray(p, np.int64) for p in prompts]
        self.setup(max(int(p.shape[0]) for p in prompts), max_new_tokens,
                   noise)
        for slot, ids in enumerate(prompts):
            adm = self._admission_start(slot, slot, ids)
            while not self._admission_step(adm):
                pass
        return self.decode_until_done(max_new_tokens, eos_ids, forced)

    def decode_until_done(self, max_new_tokens: int, eos_ids=(),
                          forced=None) -> List[list]:
        """Decode every admitted slot until EOS or max_new_tokens (the rest
        of ``generate_batch``; ``forced`` as there). Returns a list of
        token lists."""
        for s in self.slots:
            if s.tokens[-1] in eos_ids or max_new_tokens <= 1:
                s.done = True
        while any(not s.done for s in self.slots):
            active = np.asarray([not s.done for s in self.slots])
            next_toks = np.asarray(
                [s.tokens[-1] if forced is None
                 else forced[b_i][len(s.tokens) - 1]
                 for b_i, s in enumerate(self.slots)], np.int64)
            nxt = self._decode_step(next_toks, active)
            for b_i, s in enumerate(self.slots):
                if s.done:
                    continue
                t = int(nxt[b_i])
                s.tokens.append(t)
                if t in eos_ids or len(s.tokens) >= max_new_tokens:
                    s.done = True
        self.store.flush()
        return [s.tokens for s in self.slots]

    def serve(self, requests: Iterable[tuple], max_new_tokens: int,
              eos_ids=(), arrivals: Optional[dict] = None,
              timing: Optional[dict] = None,
              prefill_len: Optional[int] = None, *, noise=None) -> dict:
        """Continuous serving: (seq_id, prompt_ids) requests admit FIFO
        (the first arrived) into free slots, one prefill unit per decode
        step; finished slots retire and their id range is reused. Returns
        seq_id -> tokens. arrivals / timing: as ``BatchEngine``'s (arrival
        seconds; per-sequence "arrive", "admit", "first", "done",
        "token_times")."""
        queue = [(sid, np.asarray(ids, np.int64)) for sid, ids in requests]
        if not queue:
            return {}
        self.setup(prefill_len if prefill_len is not None
                   else max(int(p.shape[0]) for _, p in queue),
                   max_new_tokens, noise)
        arrivals = arrivals or {}
        results: dict = {}
        t0 = time.perf_counter()
        now = lambda: time.perf_counter() - t0  # noqa: E731

        def rec(sid, key, val):
            if timing is not None:
                timing.setdefault(sid, {})[key] = val

        pending: Optional[_OAdmission] = None
        while queue or pending is not None or any(
                not s.done for s in self.slots):
            if pending is None and queue and any(s.done for s in self.slots):
                t_now = now()
                q_i = next((i for i, (sid, _) in enumerate(queue)
                            if t_now >= arrivals.get(sid, 0.0)), None)
                if q_i is not None:
                    sid, ids = queue.pop(q_i)
                    slot = next(i for i, s in enumerate(self.slots) if s.done)
                    rec(sid, "arrive", arrivals.get(sid, 0.0))
                    rec(sid, "admit", now())
                    pending = self._admission_start(slot, sid, ids)
            active = np.asarray([not s.done for s in self.slots])
            if active.any():
                next_toks = np.asarray(
                    [s.tokens[-1] if not s.done else 0 for s in self.slots],
                    np.int64)
                nxt = self._decode_step(next_toks, active)
                t_step = now()
                for b_i, s in enumerate(self.slots):
                    if s.done:
                        continue
                    t = int(nxt[b_i])
                    s.tokens.append(t)
                    if timing is not None:
                        timing[s.seq_id]["token_times"].append(t_step)
                    if t in eos_ids or len(s.tokens) >= max_new_tokens:
                        results[s.seq_id] = s.tokens
                        rec(s.seq_id, "done", t_step)
                        self._retire(b_i)
            if pending is not None:
                if self._admission_step(pending):
                    s = self.slots[pending.slot]
                    rec(pending.seq_id, "first", now())
                    if timing is not None:
                        timing[pending.seq_id]["token_times"] = [
                            timing[pending.seq_id]["first"]]
                    if s.tokens[-1] in eos_ids or max_new_tokens <= 1:
                        results[s.seq_id] = s.tokens
                        rec(s.seq_id, "done", now())
                        self._retire(pending.slot)
                    pending = None
            elif not active.any() and queue:
                # the pool is idle and nothing has arrived: sleep until the
                # earliest arrival
                nxt_t = min(arrivals.get(sid, 0.0) for sid, _ in queue)
                time.sleep(max(0.0, nxt_t - now()))
        self.store.flush()
        return results
