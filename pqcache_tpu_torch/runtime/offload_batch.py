"""Batch-as-heads serving on the host-offload tier: B concurrent sequences
sharing one pinned host store and one device block cache.

Counterpart of ``pqcache_tpu/runtime/offload_batch.py``
(``BatchOffloadEngine``). The single-sequence engine
(``runtime/offload_engine.py``) pays its per-layer host work (classify,
stage, launch) for one stream; this engine folds B slots into the kv-head
axis, as ``policies/pq_search.py``'s batch-as-heads layout does:

  * state tensors [L, B·H_kv, ...], per-slot counters [B] on the host;
  * block ids carry a per-slot prefix (slot · blocks_per_slot + block), so
    one ``HostKVStore`` holds every slot's blocks, one LFU and device cache
    serve them all, and each layer's misses of the whole batch stage at
    once, with an explicit ``ok`` mask of the valid ids;
  * per-slot growing tail blocks live in the state ([L, B·H_kv, bs, 2D])
    with per-slot fill cursors; a filled tail goes to the host between
    steps.

Prefill runs per slot through the single-sequence engine's prefill (its
offload writes slot-prefixed ids) and is folded into the batched state.
``serve`` admits FIFO into free slots, one prefill unit per decode step;
a finished slot retires: its id range is invalidated in the store and the
LFU (``invalidate_blocks``), so the next occupant's ids never hit the old
rows. Stale selection (``cache.stale_select``) is reseeded by one exact
step after every admission.

Decode per layer mirrors the JAX program: every slot's selection and
window, the ring evict of every slot (a slot that is not live evicts too,
into its own rows, and its tokens are dropped), the tail append of the
slots whose eviction enters the store.
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
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.core.sampling import GumbelNoise
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.ops.attention_ref import \
    decode_window_attention_segments
from pqcache_tpu_torch.runtime.host_offload import (HostKVStore,
                                                    assemble_blocks)
from pqcache_tpu_torch.runtime.offload_engine import (BACKPRESSURE_BLOCKS,
                                                      OffloadEngine,
                                                      OffloadPQState)


@dataclasses.dataclass
class _OSlot:
    seq_id: Optional[int] = None
    tokens: Optional[list] = None
    done: bool = True


@dataclasses.dataclass
class _OAdmission:
    """An admission in flight: the single-sequence prefill advanced one
    bounded unit at a time (``OffloadEngine._prefill_pass_steps``)."""
    slot: int
    seq_id: int
    gen: object                 # the prefill's step generator
    rem_parts: dict             # layer -> remainder rows (or None)
    n_store: int
    true_len: int


class BatchOffloadEngine:
    """Fixed-pool batch decode over the shared host store (B slots).

    ``generate_batch`` serves a fixed batch, all slots prefilled first;
    ``serve`` is continuous: requests admit into free slots one prefill
    unit per decode step, finished slots retire. device: cuda unless
    given."""

    def __init__(self, cfg: EngineConfig, params: dict, *, batch_size: int,
                 dtype=torch.bfloat16, device=None, comm=None, shard=(0, 1)):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.B = batch_size
        m = cfg.model
        self.H_kv = m.num_kv_heads
        self.D = m.head_dim
        # the single-sequence engine provides the prefill and the layer
        # pieces the two tiers share
        self._se = OffloadEngine(cfg, params, dtype, device=self.device,
                                 comm=comm, shard=shard)
        self.params = self._se.params
        self.S, self.C, self.bs = self._se.S, self._se.C, self._se.bs
        self.kv_int8 = self._se.kv_int8
        self.use_jhist = self._se.use_jhist
        self.sampler = self._se.sampler
        self.stale = cfg.cache.stale_select
        self._blk_stale: Optional[np.ndarray] = None   # [L, B·H_kv, kb]
        self.store: Optional[HostKVStore] = None
        self.timings: dict = {}
        self.noise = None

    # -- batched state -----------------------------------------------------

    def _insert(self, sst: OffloadPQState, slot: int,
                rem: torch.Tensor) -> None:
        """Fold a prefilled single-sequence state into slot ``slot``; rem
        [L, H_kv, bs, 2D] holds the prefill's remainder rows (zero-padded
        to a block; rows past the fill cursor are never read)."""
        bst = self.bstate
        hs = slice(slot * self.H_kv, (slot + 1) * self.H_kv)
        for name in ("k_sink", "v_sink", "k_local", "v_local", "codes",
                     "centroids", "jhist", "k_scale", "v_scale"):
            dst = getattr(bst, name)
            if dst is not None:
                dst[:, hs] = getattr(sst, name)
        bst.phi[:, slot * self.H_kv * self.S:(slot + 1) * self.H_kv
                * self.S] = sst.phi
        bst.tail[:, hs] = rem.to(bst.tail.dtype)
        bst.n_cand[slot] = sst.n_cand
        bst.ring_ptr[slot] = 0
        bst.pos[slot] = sst.pos

    # -- decode pieces (batch-as-heads) --------------------------------------

    def _score_topk_b(self, idx: int, hidden, cos, sin, n_sel_h):
        """Q/K/V and per-slot block top-k of layer idx. hidden [B, E];
        cos/sin [B, D/2]; n_sel_h [B·H_kv]. Returns (q [B·H, 1, D], k_new,
        v_new [B·H_kv, D], blk [B·H_kv, kb] slot-local ids, ascending)."""
        m = self.cfg.model
        st = self.bstate
        B = hidden.shape[0]
        H, Hk, D = m.num_heads, m.num_kv_heads, m.head_dim
        lp = llama._layer_params(self.params, idx)
        h_norm = llama.rms_norm(hidden, lp["ln1"], m.rms_norm_eps)
        yq, yk, yv = llama._products(h_norm, lp, ("wq", "wk", "wv"))
        q = llama._apply_rope_batched(yq.reshape(B, H, D), cos, sin)
        k_new = llama._apply_rope_batched(yk.reshape(B, Hk, D), cos, sin)
        v_new = yv.reshape(B, Hk, D)
        blk = self._se._select(st, idx, q.reshape(B * H, D), n_sel_h)
        return (q.reshape(B * H, 1, D), k_new.reshape(B * Hk, D),
                v_new.reshape(B * Hk, D), blk)

    def _attn_tail_b(self, idx: int, hidden, q, k_new, v_new, blk_idx, sel,
                     step: dict):
        """Window assembly, attention and MLP of layer idx for every slot,
        then each slot's ring evict and, where ``step["app_h"]`` says so,
        its store-tail append. Returns hidden [B, E]."""
        m = self.cfg.model
        st = self.bstate
        se = self._se
        B, Hk, D, bs = self.B, self.H_kv, self.D, self.bs
        BH = B * Hk
        slots, miss_pos, staged, cache = sel
        blocks = assemble_blocks(cache, staged, slots, miss_pos)
        self.store.admit(idx)
        k_rows, v_rows, row_mask = se._window_rows(
            st, idx, blocks, blk_idx, slots, miss_pos, step["n_sel_h"])
        k_tl, v_tl = se._tail_kv(st, idx, st.tail[idx])
        tail_mask = (torch.arange(bs, device=self.device)[None]
                     < step["n_tail_h"][:, None])
        dt = st.k_local.dtype
        out = decode_window_attention_segments(q, [
            (st.k_sink[idx], st.v_sink[idx], None),
            (st.k_local[idx], st.v_local[idx], None),
            (k_rows, v_rows, row_mask),
            (k_tl, v_tl, tail_mask),
            (k_new[:, None].to(dt), v_new[:, None].to(dt), None)])
        lp = llama._layer_params(self.params, idx)
        hidden = llama._finish_layer(m, lp, hidden,
                                     out.reshape(B, m.num_heads * D),
                                     self._se.comm)
        # ring evict of every slot: the oldest local row out, the new token
        # in, the evicted key encoded as candidate n_cand[slot]
        heads, ptr_h = step["heads"], step["ptr_h"]
        ev_k = st.k_local[idx, heads, ptr_h][:, None]          # [BH, 1, D]
        ev_v = st.v_local[idx, heads, ptr_h][:, None]
        ev_codes = se._encode_evicted(st, idx, ev_k)           # [BH, S]
        kv_ev = se._evicted_row(st, idx, ev_k, ev_v).to(st.tail.dtype)
        st.k_local[idx, heads, ptr_h] = k_new.to(dt)
        st.v_local[idx, heads, ptr_h] = v_new.to(dt)
        st.codes[idx, heads[:, None], step["subs"], step["code_col"]] = \
            ev_codes
        app = step["app_h"]
        if app is not None:
            st.tail[idx, app, step["fill_app"]] = kv_ev[app]
        if self.use_jhist:
            jh = step["jhist_rows"]
            if jh is not None:
                pair = (ev_codes[:, 0].long() * self.C
                        + ev_codes[:, 1].long())
                pq.jhist_increment(st.jhist, (idx, jh, step["jhist_blk"],
                                              pair[jh]))
        return hidden

    # -- run setup, admission, retirement -----------------------------------

    def _setup(self, max_prompt_len: int, max_new_tokens: int,
               noise=None) -> None:
        """Pool-wide run state: one prefill length P (one budget) for every
        slot, the shared store sized to B id ranges, the batched state and
        the per-slot host counters."""
        cfg = self.cfg
        m = cfg.model
        self._P, pad, self._chunked, self._ch = self._se._plan(
            max_prompt_len, max_new_tokens)
        self.budget = b = self._se.budget
        self.max_new = max_new_tokens
        if b.n_tail_max % self.bs:
            raise ValueError(f"n_tail_max {b.n_tail_max} not divisible by "
                             f"cache block {self.bs}")
        self._blocks_per_slot = b.n_tail_max // self.bs
        self.timings = {"host_s": 0.0, "wait_s": 0.0, "decode_s": 0.0,
                        "steps": 0}
        self.store = None
        self.store = HostKVStore(
            m.num_layers, m.num_kv_heads, self.B * b.n_tail_max, m.head_dim,
            block_size=self.bs, hbm_cache_tokens=cfg.cache.hbm_cache_tokens,
            cache_topk_blocks=cfg.cache.cache_topk_blocks,
            dtype=torch.int8 if self.kv_int8 else self._se.dtype,
            device=self.device)
        B = self.B
        bst = self._se._init_state(b, rows=B * self.H_kv)
        bst.n_cand = np.zeros((B,), np.int64)
        bst.ring_ptr = np.zeros((B,), np.int64)
        bst.pos = np.zeros((B,), np.int64)
        bst.tail = torch.zeros(
            (m.num_layers, B * self.H_kv, self.bs, 2 * self.D),
            dtype=self.store.dtype, device=self.device)
        self.bstate = bst
        self._stored = np.zeros((B,), np.int64)   # prefill rows per slot
        self._valid = np.zeros((B,), np.int64)    # complete-block rows
        self._fill = np.zeros((B,), np.int64)     # tail cursor
        self._ncand = np.zeros((B,), np.int64)
        self.noise = noise
        if self.sampler is not None and noise is None:
            self.noise = GumbelNoise(cfg.runtime.sample_seed, self.device)
        self.slots: List[_OSlot] = [_OSlot() for _ in range(B)]
        self._head_slot = np.repeat(np.arange(B), self.H_kv)
        self._blk_stale = None

    def _admission_start(self, slot: int, seq_id: int,
                         ids: np.ndarray) -> _OAdmission:
        """Open slot ``slot`` for ``ids``: the prefill's offload writes the
        slot's id range of the shared store; the admission advances one
        unit per ``_admission_step``."""
        b = self.budget
        ids = np.asarray(ids, np.int64)
        true_len = int(ids.shape[0])
        pad = self._P - true_len
        if pad < 0:
            raise ValueError(f"prompt {true_len} > pool prefill {self._P}")
        n_store = true_len - b.sink
        base = slot * self._blocks_per_slot
        rem_parts: dict = {}
        se = self._se

        def offload_fn(idx, k, v, st):
            k, v = se.quant_layer_kv(st, idx, k, v)
            part = self.store.offload_blocks_device(
                idx, k, v, n_store, pad + b.sink, id_base=base)
            if part is not None:
                part = F.pad(part, (0, 0, 0, self.bs - part.shape[1]))
            rem_parts[idx] = part

        gen = se._prefill_pass_steps(
            se._init_state(b), ids, self._P, pad, true_len, self._chunked,
            self._ch, offload_fn, self.store.sync_transfers)
        return _OAdmission(slot=slot, seq_id=seq_id, gen=gen,
                           rem_parts=rem_parts, n_store=n_store,
                           true_len=true_len)

    def _admission_step(self, adm: _OAdmission) -> bool:
        """Advance one prefill unit; True once the admission is done (first
        token taken, state folded in, slot live)."""
        try:
            next(adm.gen)
            return False
        except StopIteration as e:
            logits, sst = e.value
        first = int(self._se._next_token(logits, self.noise))
        L = self.cfg.model.num_layers
        if adm.rem_parts and adm.rem_parts[0] is not None:
            rem = torch.stack([adm.rem_parts[i] for i in range(L)])
        else:
            rem = torch.zeros((L, self.H_kv, self.bs, 2 * self.D),
                              dtype=self.bstate.tail.dtype,
                              device=self.device)
        with torch.no_grad():
            self._insert(sst, adm.slot, rem)
        # stale selections of this slot's rows came from the previous
        # occupant: the next step runs exact and reseeds them
        self._blk_stale = None
        b = self.budget
        n_full = adm.n_store // self.bs
        self._stored[adm.slot] = adm.n_store
        self._valid[adm.slot] = n_full * self.bs
        self._fill[adm.slot] = adm.n_store - n_full * self.bs
        self._ncand[adm.slot] = max(adm.true_len - b.sink - b.local, 0)
        self.slots[adm.slot] = _OSlot(seq_id=adm.seq_id, tokens=[first],
                                      done=False)
        return True

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

    # -- decode step ---------------------------------------------------------

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
            n_sel_h=ix(np.repeat(n_sel, Hk)), n_tail_h=ix(np.repeat(n_tail,
                                                                     Hk)),
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
        """One batched decode step over all B slots (a slot that is not
        live is masked: no selection, no append; its token is dropped).
        Returns the next tokens [B]."""
        t_step = time.perf_counter()
        B, Hk, L = self.B, self.H_kv, self.cfg.model.num_layers
        tm = self.timings
        st = self.bstate
        do_app = (self._ncand >= self._stored) & active
        step = self._step_indices(do_app)
        hidden = llama.embed_lookup(self.params, self.store.device_index(
            np.asarray(next_toks)))
        cos, sin = llama.rope_cos_sin(self.cfg.model, self.store.device_index(
            st.pos))
        q, k_new, v_new, blk = self._score_topk_b(0, hidden, cos, sin,
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
            slots, miss_pos, staged, cache = self.store.classify_blocks(
                idx, gids, ok=ok)
            ix = self.store.device_index
            sel = (ix(slots), ix(miss_pos), staged, cache)
            blk_t = ix(blk_np) if stale else blk
            tm["host_s"] += time.perf_counter() - t1
            hidden = self._attn_tail_b(idx, hidden, q, k_new, v_new, blk_t,
                                       sel, step)
            if idx < L - 1:
                q, k_new, v_new, blk = self._score_topk_b(
                    idx + 1, hidden, cos, sin, step["n_sel_h"])
                new_blks.append(blk)
                if (stale and self.store.cuda
                        and staged.shape[0] >= BACKPRESSURE_BLOCKS):
                    t0 = time.perf_counter()
                    torch.cuda.current_stream(self.device).synchronize()
                    tm["wait_s"] += time.perf_counter() - t0
        m = self.cfg.model
        last = llama.rms_norm(hidden, self.params["final_norm"],
                              m.rms_norm_eps)
        nxt = self._se._next_token(llama.lm_head_logits(self.params, last),
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
        self._ncand += active.astype(np.int64)
        self._fill += do_app.astype(np.int64)
        for b_i in range(B):
            if self._fill[b_i] == self.bs:
                # the filled tail block goes to the host
                hs = slice(b_i * Hk, (b_i + 1) * Hk)
                ext = st.tail[:, hs].clone()
                gid = (b_i * self._blocks_per_slot
                       + int(self._valid[b_i]) // self.bs)
                for layer in range(L):
                    self.store.adopt_block_device(layer, ext[layer],
                                                  block_id=gid)
                self._valid[b_i] += self.bs
                self._fill[b_i] = 0
        tm["decode_s"] += time.perf_counter() - t_step
        tm["steps"] += 1
        return nxt

    # -- public API -----------------------------------------------------------

    @property
    def logits_log(self) -> Optional[list]:
        """Set to [] to record the logits of each admission's prefill [V]
        and of every decode step [B, V] (``OffloadEngine.logits_log``)."""
        return self._se.logits_log

    @logits_log.setter
    def logits_log(self, log: Optional[list]) -> None:
        self._se.logits_log = log

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
        self._setup(max(int(p.shape[0]) for p in prompts), max_new_tokens,
                    noise)
        for slot, ids in enumerate(prompts):
            adm = self._admission_start(slot, slot, ids)
            while not self._admission_step(adm):
                pass
        return self._decode_until_done(max_new_tokens, eos_ids, forced)

    def _decode_until_done(self, max_new_tokens: int, eos_ids=(),
                           forced=None) -> List[list]:
        """Decode every admitted slot until EOS or max_new_tokens (the rest
        of ``generate_batch``, shared with the sharded tier's ring
        prefill; ``forced`` as there). Returns a list of token lists."""
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
        self._setup(prefill_len if prefill_len is not None
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
