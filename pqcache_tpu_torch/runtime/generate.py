"""Generation engine: bucketed prefill and a greedy decode loop.

Counterpart of ``pqcache_tpu/runtime/generate.py::Engine`` for one sequence
on one device. It left-pads the prompt to a bucket length, runs the
configured policy (``pq_search``, ``original``, ``h2o``, ``infllm``,
``no_drop_lb`` or ``sparq_f``; ``pq_search`` falls back to ``original``
when its budgets are degenerate for the prompt, the others pass straight
through), runs one prefill and
then decodes greedily. With ``RuntimeConfig.prefill_chunk`` a long prompt
is prefilled in chunks (``llama.prefill_chunked``, the policies with a
``prefill_tail``); ``prefill_prefix`` snapshots a shared prompt prefix that
``generate(prefix=...)`` continues from (``llama.prefill_with_prefix``).

Decoding is greedy at temperature 0, else sampled (``core/sampling``): the
first token from the prefill logits, then one draw per decode step, all
from one generator seeded with ``RuntimeConfig.sample_seed`` per request,
so the same seed gives the same tokens. With ``CacheConfig.offload`` a
``pq_search`` request runs on the host-offload tier
(``runtime/offload_engine.OffloadEngine``, policy name
"pq_search_offload"); a prompt that falls back to ``original`` runs here.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import compute_budget, pq_is_applicable
from pqcache_tpu_torch.core.sampling import GumbelNoise, make_sampler
from pqcache_tpu_torch.models import llama, require_llama
from pqcache_tpu_torch.policies.base import get_policy, use_kernels


def bucket_length(n: int, bucket: int, minimum: int = 128) -> int:
    return max(minimum, ((n + bucket - 1) // bucket) * bucket)


def chunk_plan(P: int, ch: int, quantum: int = 1024) -> tuple[int, int]:
    """(P_padded, chunk) for chunked prefill: n = ceil(P / ch) chunks of one
    quantum-aligned length, P_padded = n * chunk. Shrinking the chunk pads
    at most one quantum per chunk, where rounding P up to a multiple of ch
    could nearly double the work. Idempotent on its own output."""
    quantum = min(quantum, ch)
    n = -(-P // ch)
    per = -(-P // n)
    chunk = (per + quantum - 1) // quantum * quantum
    return n * chunk, chunk


def chunk_plan_capped(P: int, ch: int, cap: int) -> tuple[int, int]:
    """chunk_plan under the reservation cap (max_seq_len): the finer 256
    quantum if the default plan pads past ``cap``, and unchunked at P
    (chunk 0) if that does too."""
    P_c, ch_c = chunk_plan(P, ch)
    if P_c > cap:
        P_c, ch_c = chunk_plan(P, ch, quantum=256)
    if P_c > cap:
        return P, 0
    return P_c, ch_c


@dataclass
class GenerateResult:
    tokens: list            # generated token ids (ints)
    prefill_seconds: float  # prompt in to first token out (host clock)
    decode_seconds: float   # the rest of the tokens
    policy_name: str


@dataclass
class PrefixCache:
    """Snapshot of a prefilled shared prompt prefix (a system prompt): the
    per-layer rope'd K/V, policy-independent. Built once by
    ``Engine.prefill_prefix``, reused by ``generate(..., prefix=...)``, which
    then prefills only the suffix."""
    k: torch.Tensor         # [L, H_kv, T_pre, D]
    v: torch.Tensor         # [L, H_kv, T_pre, D]
    n: int                  # T_pre, the unpadded prefix length


def params_to(params: dict, device, dtype=None) -> dict:
    """The params dict with every tensor on ``device``, float tensors in
    ``dtype`` when given; integer tensors (int8 weights) keep their dtype,
    and their '<name>_s' scales, being float, follow ``dtype``. Tensors
    already there are not copied."""
    def mv(t):
        keep = dtype is None or not t.is_floating_point()
        return t.to(device=device, dtype=t.dtype if keep else dtype)
    out = {k: mv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: mv(v) for k, v in params["layers"].items()}
    return out


class Engine:
    """Single-sequence generation engine.

    device: "cuda" unless given; without CUDA and without an explicit
    device it raises. params: the dict of ``models/llama.init_params`` (or
    ``bridge.params_from_numpy``); it is moved to ``device``/``dtype``."""

    def __init__(self, cfg: EngineConfig, params: dict,
                 dtype=torch.bfloat16, device=None):
        require_llama(cfg.model, "Engine")
        self.device = resolve_device(device)
        use_kernels(cfg)                      # rejects kernels modes early
        self.cfg = cfg
        self.dtype = dtype
        self.params = params_to(params, self.device, dtype)
        # the host-offload tier (CacheConfig.offload): KV in pinned host
        # memory with a device block cache
        self._off_engine = None
        if cfg.cache.offload and cfg.runtime.policy == "pq_search":
            from pqcache_tpu_torch.runtime.offload_engine import OffloadEngine
            self._off_engine = OffloadEngine(cfg, self.params, dtype,
                                             device=self.device)
        self.sampler = make_sampler(cfg.runtime.temperature, cfg.runtime.top_k,
                                    cfg.runtime.top_p)
        self._policies = {}
        self._last_policy = None

    def _policy(self, P: int, name: str):
        key = (P, name)
        if key not in self._policies:
            cfg = self.cfg
            if name != cfg.runtime.policy:
                cfg = dataclasses.replace(
                    cfg, runtime=dataclasses.replace(cfg.runtime, policy=name))
            budget = compute_budget(cfg.budget, P,
                                    cfg.runtime.max_new_tokens)
            self._policies[key] = get_policy(cfg, budget, device=self.device)
        return self._policies[key]

    def _prefill_chunk(self, P: int, policy) -> int:
        """The chunk of a chunked prefill at bucket P, or 0 for one pass:
        chunked when prefill_chunk is set, P exceeds it, the policy has a
        prefill_tail (pq_search, original) and a chunk plan lands exactly
        on P (_stream pads P to one)."""
        ch = self.cfg.runtime.prefill_chunk
        if not (ch and P > ch and hasattr(policy, "prefill_tail")):
            return 0
        for quantum in (1024, 256):
            P_c, ch_eff = chunk_plan(P, ch, quantum)
            if P_c == P:
                return ch_eff
        return 0

    def prefill_prefix(self, prefix_ids) -> PrefixCache:
        """Prefill a shared prompt prefix once, unpadded, and snapshot its
        per-layer K/V for ``generate(..., prefix=...)``. Raises when the
        prefix leaves no room under max_seq_len."""
        ids = np.asarray(prefix_ids, np.int64)
        T_pre = int(ids.shape[0])
        if T_pre + 1 > self.cfg.runtime.max_seq_len:
            raise ValueError(
                f"prefix {T_pre} leaves no room under max_seq_len "
                f"{self.cfg.runtime.max_seq_len}")
        k, v = llama.prefill_capture_kv(
            self.cfg.model, self.params, torch.from_numpy(ids).to(self.device),
            use_kernel=use_kernels(self.cfg))
        return PrefixCache(k=k, v=v, n=T_pre)

    def pick_policy(self, true_len: int, P: int) -> str:
        """Policy selection including the short-prompt dense fallback."""
        name = self.cfg.runtime.policy
        if name != "pq_search":
            return name
        b = compute_budget(self.cfg.budget, P, self.cfg.runtime.max_new_tokens)
        # budgets are sized from the bucket P, but candidates live in
        # [0, true_len - sink - local)
        runtime_cand = true_len - b.sink - b.local
        if (not pq_is_applicable(b, self.cfg.pq.n_centroids)
                or runtime_cand < max(b.topk, 1)):
            return "original"
        return name

    # -- public API --------------------------------------------------------

    def generate(self, prompt_ids, max_new_tokens: Optional[int] = None,
                 eos_ids=(), prefix=None) -> GenerateResult:
        """Generation. prefill_seconds ends when the first token is on
        the host; decode_seconds covers the rest. With ``prefix`` (a
        PrefixCache from prefill_prefix) the prompt is its suffix."""
        max_new = self._check_max_new(max_new_tokens)
        t0 = time.perf_counter()
        it = self._stream(np.asarray(prompt_ids, np.int64), max_new, eos_ids,
                          prefix=prefix)
        out_tokens = [next(it)]
        t1 = time.perf_counter()
        out_tokens.extend(it)
        t2 = time.perf_counter()
        return GenerateResult(tokens=out_tokens, prefill_seconds=t1 - t0,
                              decode_seconds=t2 - t1,
                              policy_name=self._last_policy)

    def generate_stream(self, prompt_ids, max_new_tokens: Optional[int] = None,
                        eos_ids=(), chunk: int = 8, prefix=None):
        """Yield generated token ids as they become available: the first
        right after prefill, then in chunks of ``chunk`` decoded tokens."""
        max_new = self._check_max_new(max_new_tokens)
        yield from self._stream(np.asarray(prompt_ids, np.int64), max_new,
                                eos_ids, chunk=chunk, prefix=prefix)

    def _check_max_new(self, max_new_tokens: Optional[int]) -> int:
        max_new = max_new_tokens or self.cfg.runtime.max_new_tokens
        if max_new > self.cfg.runtime.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {max_new} exceeds the engine reservation "
                f"{self.cfg.runtime.max_new_tokens}")
        return max_new

    def _stream(self, ids: np.ndarray, max_new: int, eos_ids=(),
                chunk: Optional[int] = None, prefix=None):
        cfg = self.cfg
        true_len = int(ids.shape[0])
        if prefix is not None and self._off_engine is not None:
            raise ValueError(
                "prefix caching is not supported on the offload tier")
        if prefix is not None:
            # the suffix RIGHT-padded to its bucket (causality hides the pad
            # keys; the logits come from the last real row), positions from
            # prefix.n
            pos = prefix.n + true_len
            if pos + max_new > cfg.runtime.max_seq_len:
                raise ValueError(
                    f"prefix {prefix.n} + suffix {true_len} + {max_new} new "
                    f"tokens exceeds max_seq_len {cfg.runtime.max_seq_len}")
            P_suf = min(bucket_length(true_len, cfg.runtime.prefill_bucket),
                        cfg.runtime.max_seq_len - prefix.n)
            name = self.pick_policy(pos, prefix.n + P_suf)
            policy = self._policy(prefix.n + P_suf, name)
            tokens = np.zeros((P_suf,), np.int64)
            tokens[:true_len] = ids
            state = policy.init_state(self.dtype)
            logits = llama.prefill_with_prefix(
                cfg.model, self.params, policy, state, prefix.k, prefix.v,
                torch.from_numpy(tokens).to(self.device), true_len)
        else:
            P = min(bucket_length(true_len, cfg.runtime.prefill_bucket),
                    cfg.runtime.max_seq_len)
            if true_len > P:
                raise ValueError(f"prompt {true_len} exceeds max_seq_len {P}")
            ch = cfg.runtime.prefill_chunk
            if ch and P > ch:
                # max_seq_len caps the reservation: no chunk padding past it
                P, _ = chunk_plan_capped(P, ch, cfg.runtime.max_seq_len)
            name = self.pick_policy(true_len, P)
            if self._off_engine is not None and name == "pq_search":
                self._last_policy = "pq_search_offload"
                yield from self._off_engine.stream(ids, max_new,
                                                   eos_ids=eos_ids)
                return
            policy = self._policy(P, name)
            pad, pos = P - true_len, true_len
            tokens = np.zeros((P,), np.int64)
            tokens[pad:] = ids
            tokens = torch.from_numpy(tokens).to(self.device)
            state = policy.init_state(self.dtype)
            ch_eff = self._prefill_chunk(P, policy)
            if ch_eff:
                logits = llama.prefill_chunked(cfg.model, self.params, policy,
                                               state, tokens, pad, true_len,
                                               chunk=ch_eff)
            else:
                logits = llama.prefill(cfg.model, self.params, policy, state,
                                       tokens, pad, true_len)
        self._last_policy = name
        noise = (GumbelNoise(cfg.runtime.sample_seed, self.device)
                 if self.sampler is not None else None)
        next_tok = int(torch.argmax(logits) if noise is None else
                       self.sampler(logits, noise.draw(logits.shape)))
        yield next_tok

        # decode in chunks of device work: EOS is checked between chunks
        if chunk is None:
            chunk = min(32, max(cfg.runtime.max_new_tokens - 1, 1))
        count = 1
        while count < max_new and next_tok not in eos_ids:
            n = min(chunk, max_new - count)
            toks = llama.decode_loop(
                cfg.model, self.params, policy, state,
                torch.full((), next_tok, device=self.device), pos, n,
                sample=self.sampler, noise=noise)
            pos += n
            for t in toks.tolist():
                next_tok = int(t)
                yield next_tok
                count += 1
                if next_tok in eos_ids:
                    break
