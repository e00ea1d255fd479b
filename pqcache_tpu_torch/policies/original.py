"""`original` policy: dense attention over an uncompressed KV cache.

Counterpart of the single-sequence part of ``pqcache_tpu/policies/original.py``:
the quality ceiling and the short-prompt fallback of ``pq_search``. State is
updated in place.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import Budget
from pqcache_tpu_torch.ops.attention_ref import decode_window_attention_segments
from pqcache_tpu_torch.ops.dispatch import dense_prefill_attention
from pqcache_tpu_torch.policies.base import register_policy, use_kernels
from pqcache_tpu_torch.runtime.state import DenseState, make_dense_state


@register_policy("original")
class OriginalPolicy:
    deferred_appends = True

    def __init__(self, cfg: EngineConfig, budget: Budget, device=None):
        self.cfg = cfg
        self.budget = budget
        self.device = resolve_device(device)
        self.max_len = budget.prefill_len + budget.max_new_tokens
        self.use_kernel = use_kernels(cfg)

    def init_state(self, dtype=torch.bfloat16) -> DenseState:
        return make_dense_state(self.cfg, self.max_len, dtype=dtype,
                                device=self.device)

    def prefill_attn(self, state: DenseState, idx: int, q, k, v,
                     pad_len: int, true_len: int):
        out, _ = dense_prefill_attention(q, k, v, pad_len,
                                         use_kernel=self.use_kernel)
        self.prefill_tail(state, idx, k, v, pad_len, true_len)
        return out

    def prefill_tail(self, state: DenseState, idx: int, k, v, pad_len: int,
                     true_len: int) -> None:
        P = k.shape[1]
        state.k_cache[idx, :, :P] = k
        state.v_cache[idx, :, :P] = v
        state.length, state.start, state.pos = P, int(pad_len), int(true_len)

    def decode_attn(self, state: DenseState, idx: int, q, k_new, v_new,
                    shared):
        # the valid cache span [start, length) as a slice: masking the whole
        # buffer computes the same result over more bytes
        lo, hi = shared["start"], shared["length"]
        dt = state.k_cache.dtype
        out = decode_window_attention_segments(q, [
            (state.k_cache[idx, :, lo:hi], state.v_cache[idx, :, lo:hi],
             None),
            (k_new.to(dt), v_new.to(dt), None),
        ])
        return out, (k_new[:, 0], v_new[:, 0])

    def commit_appends(self, state: DenseState, payloads, shared) -> None:
        """One append of all layers' new tokens: payloads = (k_new
        [L, H_kv, D], v_new [L, H_kv, D])."""
        k_new, v_new = payloads
        slot = shared["length"]
        state.k_cache[:, :, slot] = k_new
        state.v_cache[:, :, slot] = v_new

    def shared_pre(self, state: DenseState):
        return {"length": state.length, "start": state.start}

    def shared_post(self, state: DenseState, shared) -> None:
        state.length += 1
        state.pos += 1
