"""Slot-based continuous batching engine (batch-as-heads).

Counterpart of ``pqcache_tpu/runtime/batch_engine.py``. The B slots of a
pool are folded into the policy's kv-head axis (state [L, B·H_kv, ...],
counters [B] on the device), and scheduling is iteration-level at chunk
granularity:

  * a request's prefill runs as a single sequence and its state is
    inserted into a free slot of the batched state, in place;
  * one ``BatchedDecoder`` per engine advances every slot ``chunk`` tokens,
    replayed from its CUDA graph on ``cuda`` (``graph=False`` on the CPU):
    ``insert_slot`` writes into the captured state and never rebinds a
    tensor the graph reads;
  * between chunks, finished sequences retire and arrived requests are
    admitted into their slots.

All slots share one bucketed prefill length P and therefore one budget.
Finished slots keep decoding until a new request takes the slot: their
tokens are dropped, and their writes past the reservation are clamped
inside their own rows, so a live slot's tokens do not change. The decoder
leaves the room check to the engine, which checks each live slot's own.

With ``RuntimeConfig.prefill_chunk`` an admission is chunk-major and
INTERLEAVED by default: one prefill slab (``llama.prefill_chunk_step``, K2
at q_offset) between decode chunks, then the policy tail and the insert,
so a running stream stalls for one slab at most; the token streams are
those of the monolithic admission. A pool-wide ``prefix``
(``Engine.prefill_prefix``) makes every prompt a suffix prefilled against
the cached prefix K/V.

Sampling (temperature > 0) draws the first token from the prefill logits
and then one [B, V] draw per decode step, all from one generator seeded
with ``RuntimeConfig.sample_seed``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.core.sampling import GumbelNoise, make_sampler
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import (get_policy, policy_class,
                                             use_kernels)
from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
from pqcache_tpu_torch.runtime.generate import chunk_plan_capped, params_to


@dataclasses.dataclass
class _Slot:
    seq_id: Optional[int] = None
    tokens: Optional[list] = None
    done: bool = True
    next_tok: int = 0
    pos: int = 0
    room: int = 0           # decode steps left in the slot's reservation


@dataclasses.dataclass
class _Admission:
    """An in-flight interleaved admission: the per-layer K/V buffers being
    assembled slab by slab and the cursor."""
    seq_id: int
    tokens: torch.Tensor    # [P] left-padded prompt, on the device
    pad: int
    true_len: int
    kbuf: torch.Tensor      # [L, H_kv, P, D]
    vbuf: torch.Tensor
    h: Optional[torch.Tensor] = None   # last slab's rows [ch, E]
    i: int = 0              # next slab index
    n_slabs: int = 0


def _nbytes(obj) -> int:
    """Bytes of the tensors in a params dict or a state dataclass."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if dataclasses.is_dataclass(obj):
        return sum(_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


class BatchEngine:
    """Fixed-pool continuous batching over B slots on one device.

    device: cuda unless given (without CUDA and without a device it
    raises). graph: replay decode steps from a CUDA graph; the default is
    True on cuda, and a CPU device takes only False."""

    def __init__(self, cfg: EngineConfig, params: dict, *, batch_size: int = 4,
                 prefill_len: int, max_new_tokens: int, dtype=torch.bfloat16,
                 prefix=None, interleave: str = "auto", device=None,
                 graph: Optional[bool] = None):
        """prefix: a pool-wide ``PrefixCache``; each prompt is then a suffix
        of at most prefill_len - prefix.n tokens, right-padded.

        interleave: "auto" (on whenever the prefill is chunked, there is no
        prefix, and the admission buffers [L, H_kv, P, D] fit next to the
        resident set, ``_interleave_fits``), "on", or "off" (the monolithic,
        layer-major admission, which holds one layer's K/V)."""
        self.device = resolve_device(device)
        use_kernels(cfg)
        if cfg.cache.offload:
            raise ValueError(
                "BatchEngine serves the device tier; batched serving on the "
                "host-offload tier is "
                "runtime/offload_batch.BatchOffloadEngine")
        # every policy with a batch-as-heads decode (pq_search, original)
        # also has the prefill_tail that chunked and prefix admission need
        if not hasattr(policy_class(cfg.runtime.policy),
                       "decode_attn_batched"):
            raise ValueError(
                f"policy {cfg.runtime.policy!r} has no batch-as-heads decode; "
                f"serve it through the single-sequence "
                f"runtime/generate.Engine")
        self.cfg = cfg
        self.params = params_to(params, self.device, dtype)
        self.B = batch_size
        self.P = prefill_len
        self.prefix = prefix
        self.P_suf = prefill_len - (prefix.n if prefix is not None else 0)
        if self.P_suf <= 0:
            raise ValueError(f"prefix {prefix.n} leaves no suffix room "
                             f"under prefill_len {prefill_len}")
        # chunked admission prefill: admissions run with the pool's state
        # resident, so full-length prefill activations are the peak-memory
        # term; the chunk plan may pad P, and budget and state follow it
        ch = cfg.runtime.prefill_chunk
        pf_chunk = 0
        if prefix is None and ch and self.P > ch:
            self.P, pf_chunk = chunk_plan_capped(
                self.P, ch, cfg.runtime.max_seq_len)
        self.max_new = max_new_tokens
        self.dtype = dtype
        self.budget = compute_budget(cfg.budget, self.P, max_new_tokens)
        self.policy = get_policy(cfg, self.budget, device=self.device)
        self._pf_chunk = pf_chunk
        self.sampler = make_sampler(cfg.runtime.temperature,
                                    cfg.runtime.top_k, cfg.runtime.top_p)
        self.noise = (GumbelNoise(cfg.runtime.sample_seed, self.device)
                      if self.sampler is not None else None)

        if interleave not in ("auto", "on", "off"):
            raise ValueError(f"interleave must be auto/on/off, "
                             f"got {interleave!r}")
        self.interleave = bool(pf_chunk) and prefix is None
        if interleave == "off":
            self.interleave = False
        elif interleave == "on" and not self.interleave:
            raise ValueError("interleave='on' requires a chunked prefill "
                             "(runtime.prefill_chunk) and no prefix cache")
        self.bstate = self.policy.init_batched_state(self.B, dtype)
        self.slots: List[_Slot] = [_Slot() for _ in range(self.B)]
        if interleave == "auto" and self.interleave:
            self.interleave = self._interleave_fits()
        if graph is None:
            graph = self.device.type == "cuda"
        ring_k = getattr(self.policy, "ring_k", 0)
        # one decoder for the engine's life: its graph reads the batched
        # state, which admissions update in place
        self.decoder = BatchedDecoder(
            cfg.model, self.params, self.policy, self.bstate,
            chunk=ring_k or max(max_new_tokens, 1), graph=graph,
            device=self.device, sample=self.sampler, noise=self.noise,
            check_room=False)

    def _interleave_fits(self) -> bool:
        """Whether interleaved admission's all-layer K/V buffers
        (2 · [L, H_kv, P, D]) fit next to the params and the batched state
        under 90% of the device's memory. A device whose memory is unknown
        (the CPU) keeps interleave; PQCACHE_HBM_BYTES overrides."""
        lim = self._device_memory_limit(self.device)
        if not lim:
            return True
        m = self.cfg.model
        buf = (2 * m.num_layers * m.num_kv_heads * self.P * m.head_dim
               * torch.finfo(self.dtype).bits // 8)
        return (_nbytes(self.params) + _nbytes(self.bstate) + buf
                <= 0.90 * lim)

    @staticmethod
    def _device_memory_limit(device) -> Optional[int]:
        """Device memory in bytes: PQCACHE_HBM_BYTES, else a CUDA device's
        total memory, else None."""
        env = os.environ.get("PQCACHE_HBM_BYTES")
        if env:
            return int(env)
        device = torch.device(device)
        if device.type == "cuda":
            return int(torch.cuda.get_device_properties(device).total_memory)
        return None

    # -- admission ------------------------------------------------------------

    def _first_token(self, logits: torch.Tensor) -> int:
        """The first token from the prefill logits [V] (waits for them)."""
        if self.sampler is None:
            return int(torch.argmax(logits))
        return int(self.sampler(logits, self.noise.draw(logits.shape)))

    def _place(self, seq_id: int, state, first: int, pos0: int) -> int:
        """Insert a prefilled state into the first free slot."""
        slot = next(i for i, s in enumerate(self.slots) if s.done)
        self.policy.insert_slot(self.bstate, state, slot)
        self.slots[slot] = _Slot(seq_id=seq_id, tokens=[first], done=False,
                                 next_tok=first, pos=pos0,
                                 room=self.budget.max_new_tokens)
        return slot

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device without waiting for the card: on
        cuda through pinned memory, copied asynchronously (a blocking copy
        would wait for the work queued before it)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _left_padded(self, ids: np.ndarray):
        true_len = int(ids.shape[0])
        pad = self.P - true_len
        if pad < 0:
            raise ValueError(
                f"prompt {true_len} > engine prefill_len {self.P}")
        tokens = np.zeros((self.P,), np.int64)
        tokens[pad:] = ids
        return self._to_device(tokens), pad, true_len

    def _admission_start(self, seq_id: int, ids: np.ndarray) -> _Admission:
        m = self.cfg.model
        tokens, pad, true_len = self._left_padded(ids)
        kbuf = torch.zeros((m.num_layers, m.num_kv_heads, self.P, m.head_dim),
                           dtype=self.dtype, device=self.device)
        return _Admission(seq_id=seq_id, tokens=tokens, pad=pad,
                          true_len=true_len, kbuf=kbuf,
                          vbuf=torch.zeros_like(kbuf),
                          n_slabs=self.P // self._pf_chunk)

    def _admission_step(self, adm: _Admission) -> bool:
        """Advance one slab; True when the prefill slabs are exhausted."""
        ch = self._pf_chunk
        c0 = adm.i * ch
        hidden_c = llama.embed_lookup(self.params, adm.tokens[c0:c0 + ch])
        adm.h = llama.prefill_chunk_step(
            self.cfg.model, self.params, adm.kbuf, adm.vbuf, hidden_c,
            adm.pad, c0, use_kernel=self.policy.use_kernel)
        adm.i += 1
        return adm.i >= adm.n_slabs

    def _admission_finish(self, adm: _Admission) -> int:
        """Policy tail + slot insert; returns the slot index."""
        state = self.policy.init_state(self.dtype)
        logits = llama.prefill_finish_tail(
            self.cfg.model, self.params, self.policy, state, adm.kbuf,
            adm.vbuf, adm.h, adm.pad, adm.true_len)
        return self._place(adm.seq_id, state, self._first_token(logits),
                           adm.true_len)

    def _admit(self, seq_id: int, ids: np.ndarray) -> int:
        """Monolithic admission: the whole prefill, then the insert."""
        m = self.cfg.model
        true_len = int(ids.shape[0])
        state = self.policy.init_state(self.dtype)
        if self.prefix is not None:
            # a suffix of the pool's shared prefix, RIGHT-padded to P_suf
            if true_len > self.P_suf:
                raise ValueError(f"suffix {true_len} > suffix capacity "
                                 f"{self.P_suf} (prefix {self.prefix.n})")
            tokens = np.zeros((self.P_suf,), np.int64)
            tokens[:true_len] = ids
            logits = llama.prefill_with_prefix(
                m, self.params, self.policy, state, self.prefix.k,
                self.prefix.v, self._to_device(tokens), true_len)
            pos0 = self.prefix.n + true_len
        else:
            tokens, pad, true_len = self._left_padded(ids)
            if self._pf_chunk:
                logits = llama.prefill_chunked(
                    m, self.params, self.policy, state, tokens, pad,
                    true_len, chunk=self._pf_chunk)
            else:
                logits = llama.prefill(m, self.params, self.policy, state,
                                       tokens, pad, true_len)
            pos0 = true_len
        return self._place(seq_id, state, self._first_token(logits), pos0)

    # -- decode ---------------------------------------------------------------

    def _decode_chunk(self, chunk: int) -> np.ndarray:
        """Every slot ``chunk`` steps from its next token and position;
        returns the tokens [B, chunk] on the host (the loop's one wait for
        the card). Each live slot spends the steps it still needs from its
        own room; the steps past its last token, and all of a finished
        slot's, are dropped."""
        for s in self.slots:
            if s.done:
                continue
            need = min(chunk, self.max_new - len(s.tokens))
            if need > s.room:
                raise ValueError(
                    f"sequence {s.seq_id} needs {need} more steps, its "
                    f"slot's reservation has {s.room} left")
            s.room -= need
        toks, poss = (self._to_device(np.asarray(
            [getattr(s, k) for s in self.slots], np.int32))
            for k in ("next_tok", "pos"))
        out = self.decoder.generate(toks, poss, chunk)
        return out.T.cpu().numpy()

    def run(self, requests: Iterable[tuple[int, np.ndarray]],
            eos_ids=(), chunk: int = 16,
            arrivals: Optional[dict] = None,
            timing: Optional[dict] = None,
            admission: str = "fifo") -> dict[int, list]:
        """Process (seq_id, prompt_ids) requests; returns seq_id -> tokens.

        arrivals: seq_id -> earliest admission time (seconds from the call's
        start); requests are admitted once arrived, at chunk boundaries.
        timing: pass an empty dict to collect per-sequence wall-clock events
        (seconds from the call's start): "arrive", "admit" (prefill start;
        admit - arrive is the queue wait), "first" (first token on the
        host; first - arrive is TTFT under load), "done", and "token_times"
        (the completion time of the chunk that produced each token).

        admission: the queue discipline among ARRIVED requests: "fifo"
        (arrival order; a head that has not arrived does not block), or
        "spf" (shortest prompt first)."""
        if admission not in ("fifo", "spf"):
            raise ValueError(f"admission must be fifo/spf, "
                             f"got {admission!r}")
        ring_k = getattr(self.policy, "ring_k", 0)
        if ring_k:
            chunk = min(chunk, ring_k)   # chunks bounded by ring capacity
        queue = list(requests)
        arrivals = arrivals or {}
        results: dict[int, list] = {}
        t0 = time.perf_counter()

        def now():
            return time.perf_counter() - t0

        def next_admit():
            """Index into ``queue`` of the next request to admit, or None
            if nothing has arrived yet."""
            t_now = now()
            ready = [i for i, (sid, _) in enumerate(queue)
                     if t_now >= arrivals.get(sid, 0.0)]
            if not ready:
                return None
            if admission == "spf":
                return min(ready, key=lambda i: len(queue[i][1]))
            return ready[0]

        def sleep_to_next_arrival():
            nxt_t = min(arrivals.get(sid, 0.0) for sid, _ in queue)
            time.sleep(max(0.0, nxt_t - now()))

        def rec(sid, key, val):
            if timing is not None:
                timing.setdefault(sid, {})[key] = val

        def first_token_time(sid):
            rec(sid, "first", now())
            if timing is not None:
                timing[sid]["token_times"] = [timing[sid]["first"]]

        def decode_once():
            out_np = self._decode_chunk(chunk)
            t_chunk = now()
            for i, s in enumerate(self.slots):
                if s.done:
                    continue
                for t in out_np[i]:
                    t = int(t)
                    s.tokens.append(t)
                    s.pos += 1
                    if timing is not None:
                        timing[s.seq_id]["token_times"].append(t_chunk)
                    if t in eos_ids or len(s.tokens) >= self.max_new:
                        s.done = True
                        results[s.seq_id] = s.tokens
                        rec(s.seq_id, "done", t_chunk)
                        break
                s.next_tok = s.tokens[-1]

        def pool_busy():
            return any(not s.done for s in self.slots)

        if self.interleave:
            pending: Optional[_Admission] = None
            while queue or pending is not None or pool_busy():
                if (pending is None and queue
                        and any(s.done for s in self.slots)):
                    q_i = next_admit()
                    if q_i is not None:
                        sid, ids = queue.pop(q_i)
                        rec(sid, "arrive", arrivals.get(sid, 0.0))
                        rec(sid, "admit", now())
                        pending = self._admission_start(
                            sid, np.asarray(ids, np.int64))
                active = pool_busy()
                if active:
                    decode_once()
                if pending is not None:
                    if self._admission_step(pending):
                        self._admission_finish(pending)
                        first_token_time(pending.seq_id)
                        pending = None
                elif not active and queue:
                    # pool idle, nothing arrived: sleep to earliest arrival
                    sleep_to_next_arrival()
            return results

        def admit_all():
            while queue and any(s.done for s in self.slots):
                q_i = next_admit()
                if q_i is None:
                    break                 # nothing has arrived yet
                sid, ids = queue.pop(q_i)
                rec(sid, "arrive", arrivals.get(sid, 0.0))
                rec(sid, "admit", now())
                self._admit(sid, np.asarray(ids, np.int64))
                first_token_time(sid)     # _admit waits for the first token

        admit_all()
        while queue or pool_busy():
            if not pool_busy():
                # pool idle, requests still queued: sleep until the next
                # arrival, then admit
                sleep_to_next_arrival()
                admit_all()
                continue
            decode_once()
            admit_all()
        return results
