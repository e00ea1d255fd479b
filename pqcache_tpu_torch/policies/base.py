"""Attention-policy registry (counterpart of ``pqcache_tpu/policies/base.py``).

A policy owns the per-sequence state and exposes per-layer prefill and
decode attention that the model calls at its attention site:

  init_state(dtype) -> state
  prefill_attn(state, idx, q [H, P, D], k, v [H_kv, P, D], pad_len,
               true_len) -> out [H, P, D]            (writes layer idx)
  decode_attn(state, idx, q [H, 1, D], k_new, v_new [H_kv, 1, D], shared)
      -> (out [H, 1, D], append payload or None)
  commit_appends(state, payloads, shared)            (all layers, per step)
  shared_pre(state) -> shared;  shared_post(state, shared)

A policy with ``deferred_appends = True`` returns its layer's new K/V as the
payload and writes every layer's at once in ``commit_appends`` after the
layer loop; the others write it inside ``decode_attn`` (JAX's
``deferred_appends`` switch). The port updates the state in place instead of
returning a new pytree. Registered: ``original``, ``pq_search``, ``h2o`` and
``infllm``; ``no_drop_lb`` and ``sparq_f`` are not ported yet.
"""

from __future__ import annotations

from typing import Any

from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import Budget

_REGISTRY: dict[str, Any] = {}


def register_policy(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def policy_class(name: str) -> Any:
    import pqcache_tpu_torch.policies.h2o  # noqa: F401
    import pqcache_tpu_torch.policies.infllm  # noqa: F401
    import pqcache_tpu_torch.policies.original  # noqa: F401
    import pqcache_tpu_torch.policies.pq_search  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown policy {name!r}; the port has "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_policy(cfg: EngineConfig, budget: Budget, device=None):
    """The configured policy, its state on ``device`` (cuda unless given)."""
    return policy_class(cfg.runtime.policy)(cfg, budget, device=device)


def use_kernels(cfg: EngineConfig) -> bool:
    """RuntimeConfig.kernels: "auto"/"pallas" select the CUDA kernels, "xla"
    their plain PyTorch versions. Interpret mode is a Pallas-only feature."""
    mode = cfg.runtime.kernels
    if mode in ("auto", "pallas"):
        return True
    if mode == "xla":
        return False
    raise ValueError(f"kernels={mode!r} has no counterpart in the PyTorch "
                     f"port (use 'auto', 'pallas' or 'xla')")
