"""Tensor-parallel single-sequence engine: one process per head shard.

Counterpart of ``pqcache_tpu/parallel/tp_decode.py``. The JAX engine runs
one program under ``shard_map`` with hand-placed psums; here every rank of
the tp group runs the single-device decode program on its own shard, and
the two row-parallel products of each layer are all-reduced
(``models/llama._finish_layer``, Megatron). Sharded: q / kv heads, the PQ
codebooks and codes and the KV state; replicated: the embedding, the final
norm and the LM head, so every rank computes the same logits and the same
argmax. The per-shard model is the ModelConfig with num_heads and
num_kv_heads divided by tp: every policy already computes head-parallel,
and each rank launches the kernels (K1, K2, K3, K5) at its shard's shapes.

k-means++ seeds each PQ group by its global index (``policy.shard``), so a
shard's codebooks are the unsharded engine's for its heads; the
all-reduces split the wo / down contractions into per-shard partials, so
tokens agree with one device up to summation order.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama, require_llama
from pqcache_tpu_torch.parallel.sharding import gather_layer, shard_params
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.generate import params_to


def local_model_config(cfg: EngineConfig, tp: int) -> EngineConfig:
    """The per-shard config: head counts divided by tp, shard_axis "tp"."""
    m = cfg.model
    if m.num_kv_heads % tp or m.num_heads % tp:
        raise ValueError(f"tp={tp} must divide head counts "
                         f"({m.num_heads}/{m.num_kv_heads})")
    local_m = dataclasses.replace(
        m, num_heads=m.num_heads // tp, num_kv_heads=m.num_kv_heads // tp)
    return dataclasses.replace(
        cfg, model=local_m,
        runtime=dataclasses.replace(cfg.runtime, shard_axis="tp"))


# the TP engines keep the LM head replicated: logits come out replicated
PARAM_SPECS = {"embed": None, "final_norm": None, "lm_head": None,
               "layers": {"ln1": None, "ln2": None, "wq": 2, "wk": 2,
                          "wv": 2, "wo": 1, "gate": 2, "up": 2, "down": 1}}


def local_params(params: dict, mesh, dtype, sharded: bool = False) -> dict:
    """This rank's ``PARAM_SPECS`` shard on the mesh's device in ``dtype``.
    params: the whole model, sliced where it lies before it moves (so the
    device never holds more than the shard), or with ``sharded`` this
    rank's shard already (``sharding.init_params_shard``)."""
    if not sharded:
        params = shard_params(params, mesh.tp_rank, mesh.tp, PARAM_SPECS)
    return params_to(params, mesh.device, dtype)


def left_pad(prompt_ids, P: int, device):
    """(tokens [P] on ``device``, pad, true_len) of a prompt LEFT-padded to
    P."""
    ids = np.asarray(prompt_ids, np.int64)
    true_len = int(ids.shape[0])
    pad = P - true_len
    if pad < 0:
        raise ValueError(f"prompt {true_len} > prefill_len {P}")
    tokens = np.zeros((P,), np.int64)
    tokens[pad:] = ids
    return torch.from_numpy(tokens).to(device), pad, true_len


def check_replicated(comm, toks: torch.Tensor) -> list:
    """The tokens [n] (or [n, B]) every rank of ``comm`` computed, as a
    host list, after checking that the ranks agree: the logits are
    replicated, so a parting is a fault, not a tie."""
    if comm is None:
        return toks.tolist()
    allt = comm.all_gather(toks.to(torch.int32).contiguous()[None])
    if not bool((allt == allt[:1]).all()):
        raise RuntimeError(f"tensor-parallel ranks disagree on tokens: "
                           f"{allt.tolist()}")
    return toks.tolist()


class TPEngine:
    """Single-sequence pq_search engine over the tp group of ``mesh``
    (``factory.make_mesh``). params: the whole model, or with ``sharded``
    this rank's shard (``local_params``); the engine keeps only the shard
    (``generate_ring`` rebuilds one layer at a time from the group's
    shards)."""

    def __init__(self, cfg: EngineConfig, params: dict, mesh,
                 prefill_len: int, max_new_tokens: int,
                 dtype=torch.bfloat16, sharded: bool = False):
        require_llama(cfg.model, "TPEngine")
        if cfg.runtime.policy != "pq_search":
            raise ValueError("the TP engines run pq_search")
        self.mesh = mesh
        self.tp = mesh.tp
        self.comm = mesh.tp_comm
        self.device = mesh.device
        self.cfg_global = cfg
        self.cfg_local = local_model_config(cfg, self.tp)
        self.P = prefill_len
        self.max_new = max_new_tokens
        self.dtype = dtype
        self.budget = compute_budget(cfg.budget, prefill_len, max_new_tokens)
        self.policy = get_policy(self.cfg_local, self.budget,
                                 device=self.device)
        self.policy.shard = (mesh.tp_rank, self.tp)
        self.local = local_params(params, mesh, dtype, sharded)
        # fixed-size decode chunks: EOS stops between chunks
        self.chunk = min(16, max(max_new_tokens - 1, 1))
        self.timings: dict = {}

    def init_state(self):
        """This rank's zero state: the local policy's, heads H_kv / tp."""
        return self.policy.init_state(self.dtype)

    def _padded(self, prompt_ids, max_new_tokens: int):
        if max_new_tokens > self.max_new:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} exceeds the engine "
                f"reservation {self.max_new}")
        return left_pad(prompt_ids, self.P, self.device)

    def _decode(self, state, first: int, pos: int, max_new_tokens: int,
                eos_ids, t0: float) -> list:
        """Decode chunks after the prefill's first token until EOS or
        max_new_tokens; records the timings and, with a group, the
        collectives' calls, bytes and host seconds of the decode."""
        t1 = time.perf_counter()
        before = _all_reduce_stats(self.comm)
        out = [first]
        stop = first in eos_ids
        while len(out) < max_new_tokens and not stop:
            n = min(self.chunk, max_new_tokens - len(out))
            toks = llama.decode_loop(
                self.cfg_local.model, self.local, self.policy, state,
                torch.tensor(out[-1], device=self.device), pos, n,
                comm=self.comm)
            pos += n
            for t in check_replicated(self.comm, toks):
                out.append(int(t))
                if int(t) in eos_ids:
                    stop = True
                    break
        t2 = time.perf_counter()
        after = _all_reduce_stats(self.comm)
        self.timings = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                        "steps": len(out) - 1,
                        "decode_all_reduce": {k: after[k] - before[k]
                                              for k in after}}
        return out[:max_new_tokens]

    @torch.no_grad()
    def prefill(self, prompt_ids, max_new_tokens: int, *, ring: bool = False,
                inner: int = 512):
        """This rank's prefilled state, the replicated last-token logits
        [V] and the prompt length: the TP prefill, or with ``ring`` the
        SEQUENCE-PARALLEL one over the same group (each rank ring-prefills
        its P / tp slice with each layer's whole weights, gathered from the
        group's shards as the layer comes, ``ring_prefill.ring_forward``;
        one all-to-all reshards the K/V head-major, and the local policy
        builds its state through ``prefill_tail``, ``ring_prefill.
        gather_state_tp``)."""
        tokens, pad, true_len = self._padded(prompt_ids, max_new_tokens)
        if not ring:
            state = self.init_state()
            logits = llama.prefill(self.cfg_local.model, self.local,
                                   self.policy, state, tokens, pad, true_len,
                                   comm=self.comm)
            return state, logits, true_len
        from pqcache_tpu_torch.parallel.ring_prefill import (gather_state_tp,
                                                             ring_forward)
        tp = self.tp
        if self.cfg_global.model.num_kv_heads % tp:
            raise ValueError(f"the ring handoff's all-to-all needs tp ({tp}) "
                             f"to divide num_kv_heads")
        if self.P % tp:
            raise ValueError(f"prefill_len {self.P} not divisible by tp {tp}")
        C = self.P // tp
        r = self.mesh.tp_rank
        logits, kv = ring_forward(
            self.cfg_global.model, self.local, tokens[r * C:(r + 1) * C],
            pad, true_len, self.comm, inner=inner,
            layer_params=lambda idx: gather_layer(self.local, idx,
                                                  self.comm))
        state = gather_state_tp(self.policy, kv, pad, true_len, self.comm,
                                dtype=self.dtype)
        return state, logits, true_len

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int, eos_ids=()) -> list:
        t0 = time.perf_counter()
        state, logits, true_len = self.prefill(prompt_ids, max_new_tokens)
        first = check_replicated(self.comm, torch.argmax(logits)[None])[0]
        return self._decode(state, first, true_len, max_new_tokens,
                            eos_ids, t0)

    @torch.no_grad()
    def generate_ring(self, prompt_ids, max_new_tokens: int, eos_ids=(),
                      inner: int = 512) -> list:
        """Generate with the SEQUENCE-PARALLEL prefill (``prefill(...,
        ring=True)``: for prompts past one card's memory), then the
        ordinary TP decode chunks. The tokens are ``generate``'s."""
        t0 = time.perf_counter()
        state, logits, true_len = self.prefill(prompt_ids, max_new_tokens,
                                               ring=True, inner=inner)
        first = check_replicated(self.comm, torch.argmax(logits)[None])[0]
        return self._decode(state, first, true_len, max_new_tokens,
                            eos_ids, t0)


def _all_reduce_stats(comm) -> dict:
    s = {} if comm is None else comm.stats.get("all_reduce", {})
    return {k: s.get(k, 0) for k in ("calls", "bytes", "seconds")}
