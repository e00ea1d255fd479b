"""Generation engine: bucketed prefill and a greedy decode loop.

Counterpart of ``pqcache_tpu/runtime/generate.py::Engine`` for one sequence
on one device. It left-pads the prompt to a bucket length, runs the
configured policy (``pq_search``, ``original``, ``h2o`` or ``infllm``;
``pq_search`` falls back to ``original`` when its budgets are degenerate
for the prompt, the others pass straight through), runs one prefill and
then decodes greedily.

Greedy decoding only: sampling (temperature > 0), chunked prefill, prefix
caching and the host-offload tier raise NotImplementedError.
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
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy, use_kernels


def bucket_length(n: int, bucket: int, minimum: int = 128) -> int:
    return max(minimum, ((n + bucket - 1) // bucket) * bucket)


@dataclass
class GenerateResult:
    tokens: list            # generated token ids (ints)
    prefill_seconds: float  # prompt in to first token out (host clock)
    decode_seconds: float   # the rest of the tokens
    policy_name: str


def params_to(params: dict, device, dtype=None) -> dict:
    """The params dict with every tensor on ``device`` (and in ``dtype``
    when given); tensors already there are not copied."""
    def mv(t):
        return t.to(device=device, dtype=dtype or t.dtype)
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
        self.device = resolve_device(device)
        use_kernels(cfg)                      # rejects kernels modes early
        if cfg.runtime.temperature > 0:
            raise NotImplementedError(
                "sampling (temperature > 0) is ported in a later slice")
        if cfg.runtime.prefill_chunk:
            raise NotImplementedError(
                "chunked prefill is ported in a later slice")
        if cfg.cache.offload:
            raise NotImplementedError(
                "the host-offload tier is ported in a later slice")
        self.cfg = cfg
        self.dtype = dtype
        self.params = params_to(params, self.device, dtype)
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
        """Greedy generation. prefill_seconds ends when the first token is on
        the host; decode_seconds covers the rest."""
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
        if prefix is not None:
            raise NotImplementedError(
                "prefix caching is ported in a later slice")
        cfg = self.cfg
        true_len = int(ids.shape[0])
        P = min(bucket_length(true_len, cfg.runtime.prefill_bucket),
                cfg.runtime.max_seq_len)
        if true_len > P:
            raise ValueError(f"prompt {true_len} exceeds max_seq_len {P}")
        name = self.pick_policy(true_len, P)
        self._last_policy = name
        policy = self._policy(P, name)
        pad = P - true_len
        tokens = np.zeros((P,), np.int64)
        tokens[pad:] = ids
        state = policy.init_state(self.dtype)
        logits = llama.prefill(cfg.model, self.params, policy, state,
                               torch.from_numpy(tokens).to(self.device), pad,
                               true_len)
        next_tok = int(torch.argmax(logits))
        yield next_tok

        # decode in chunks of device work: EOS is checked between chunks
        if chunk is None:
            chunk = min(32, max(cfg.runtime.max_new_tokens - 1, 1))
        count, pos = 1, true_len
        while count < max_new and next_tok not in eos_ids:
            n = min(chunk, max_new - count)
            toks = llama.decode_loop(
                cfg.model, self.params, policy, state,
                torch.full((), next_tok, device=self.device), pos, n)
            pos += n
            for t in toks.tolist():
                next_tok = int(t)
                yield next_tok
                count += 1
                if next_tok in eos_ids:
                    break
