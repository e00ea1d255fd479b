"""`original` policy: dense attention over an uncompressed KV cache.

Counterpart of ``pqcache_tpu/policies/original.py``: the quality ceiling,
the short-prompt fallback of ``pq_search`` and the baseline arm of the
batched decode (B slots folded into the kv-head axis, per-slot [start,
length) spans with device counters). State is updated in place. A model
with sliding-window layers keeps the cache of its full layers and a ring
per window layer (``policies/window.py``), as ``pq_search`` does.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import Budget
from pqcache_tpu_torch.ops.attention_ref import decode_window_attention_segments
from pqcache_tpu_torch.ops.dispatch import dense_prefill_attention
from pqcache_tpu_torch.policies.base import register_policy, use_kernels
from pqcache_tpu_torch.policies.window import WindowLayers
from pqcache_tpu_torch.runtime.stages import span, stage
from pqcache_tpu_torch.runtime.state import (DenseState, make_dense_state,
                                             per_head)


@register_policy("original")
class OriginalPolicy:
    deferred_appends = True

    def __init__(self, cfg: EngineConfig, budget: Budget, device=None):
        self.cfg = cfg
        self.budget = budget
        self.device = resolve_device(device)
        self.max_len = budget.prefill_len + budget.max_new_tokens
        self.use_kernel = use_kernels(cfg)
        self.kinds = WindowLayers(cfg.model)

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
        if idx in self.kinds.ring:
            self.kinds.prefill(state, idx, k, v, pad_len, true_len)
            return
        idx = self.kinds.full[idx]
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

    # -- batch-as-heads (original.py:92-155) --------------------------------

    def init_batched_state(self, B: int, dtype=torch.bfloat16) -> DenseState:
        return make_dense_state(self.cfg, self.max_len, dtype=dtype,
                                device=self.device, batch=B)

    def insert_slot(self, bstate: DenseState, state: DenseState,
                    slot: int) -> None:
        """Write a prefilled single-sequence cache into slot ``slot``."""
        H_kv = self.cfg.model.num_kv_heads
        h = slice(slot * H_kv, (slot + 1) * H_kv)
        with span("insert_slot", slot=slot):
            bstate.k_cache[:, h] = state.k_cache
            bstate.v_cache[:, h] = state.v_cache
            bstate.length[slot] = state.length
            bstate.start[slot] = state.start
            bstate.pos[slot] = state.pos
            self.kinds.insert_slot(bstate, state, slot)

    def decode_attn_batched(self, state: DenseState, idx: int, q, k_new,
                            v_new, shared):
        """q [B, H, D]; k/v_new [B, H_kv, D] -> (out [B, H, D], payload).
        Dense attention over the folded cache, each slot's [start, length)
        as a validity mask (a per-slot slice would read a count on the
        host). A window layer attends its ring and returns no payload."""
        if idx in self.kinds.ring:
            return self.kinds.decode_batched(state, idx, q, k_new, v_new,
                                             shared), None
        idx = self.kinds.full[idx]
        B, H, D = q.shape
        Hf = k_new.shape[0] * k_new.shape[1]
        dt = state.k_cache.dtype
        T = state.k_cache.shape[2]
        kpos = torch.arange(T, device=q.device)[None, :]
        mask = ((kpos >= shared["start_h"][:, None])
                & (kpos < shared["length_h"][:, None]))
        k_new_f = k_new.reshape(Hf, 1, D).to(dt)
        v_new_f = v_new.reshape(Hf, 1, D).to(dt)
        with stage("attention"):
            out = decode_window_attention_segments(q.reshape(B * H, 1, D), [
                (state.k_cache[idx], state.v_cache[idx], mask),
                (k_new_f, v_new_f, None)])
        return out.reshape(B, H, D), (k_new_f[:, 0], v_new_f[:, 0])

    def commit_appends_batched(self, state: DenseState, payloads,
                               shared) -> None:
        """Write every layer's new token at each slot's length: payloads =
        (k_new, v_new) [L, B·H_kv, D]."""
        k_new, v_new = payloads
        T = state.k_cache.shape[2]
        pos = shared["length_h"].long().clamp(max=T - 1)
        heads = torch.arange(pos.shape[0], device=pos.device)
        state.k_cache[:, heads, pos] = k_new.to(state.k_cache.dtype)
        state.v_cache[:, heads, pos] = v_new.to(state.v_cache.dtype)

    def shared_pre_batched(self, state: DenseState):
        H_kv = self.cfg.model.num_kv_heads
        return {"length": state.length, "start": state.start,
                "length_h": per_head(state.length, H_kv),
                "start_h": per_head(state.start, H_kv),
                **self.kinds.shared(state)}

    def shared_post_batched(self, state: DenseState, shared) -> None:
        state.length += 1
        state.pos += 1
