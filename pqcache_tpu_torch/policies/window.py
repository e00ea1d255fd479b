"""The sliding-window layers' KV, beside a policy's full-layer state.

A model whose layers differ in kind (``config.AfmoeConfig``) hands every
layer to one policy. The policy keeps its own state (PQ retrieval, or the
dense cache) for the full-attention layers only, and for each window layer
a ring of the sequence's last ``window`` keys and values
(``runtime/state.py``'s ``win_k/win_v``): the token at position p sits at
row p % window, so a decode step writes one row and attends the whole
ring, no selection. ``WindowLayers`` maps a policy's layer index to its
kind and does the window layers' work for ``pq_search`` and ``original``
alike; where the model has no window layer it maps every layer to itself
and none of this runs.

Positions count real tokens (a left-padded prompt's first real token is
position 0), as the model's RoPE does: during a batched step the new
token's position is the slot's ``pos`` counter, advanced after the step.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch.ops.attention_ref import (
    decode_window_attention_segments)
from pqcache_tpu_torch.runtime.state import per_head


class WindowLayers:
    """Layer kinds of a model (``ModelConfig``): ``full[idx]`` is a full
    layer's index into the policy's stacked state, ``ring[idx]`` a window
    layer's index into ``win_k/win_v``."""

    def __init__(self, model):
        self.full = {g: i for i, g in enumerate(model.full_layers)}
        self.ring = {g: i for i, g in enumerate(model.window_layers)}
        self.window = (model.window_of(model.window_layers[0])
                       if self.ring else 0)
        self.H_kv = model.num_kv_heads

    def prefill(self, state, idx: int, k: torch.Tensor, v: torch.Tensor,
                pad_len: int, true_len: int) -> None:
        """Window layer idx of a single-sequence state from its K/V
        [H_kv, P, D] of a left-padded prompt: the last min(true_len,
        window) real tokens, each at row position % window."""
        W, n = self.window, int(true_len)
        pos = torch.arange(max(n - W, 0), n, device=k.device)
        rows = int(pad_len) + pos
        w = self.ring[idx]
        state.win_k[w][:, pos % W] = k[:, rows].to(state.win_k.dtype)
        state.win_v[w][:, pos % W] = v[:, rows].to(state.win_v.dtype)

    def insert_slot(self, bstate, state, slot: int) -> None:
        """The window rings of a single-sequence state into slot ``slot``
        of a batched one (nothing for a model without window layers)."""
        if not self.ring:
            return
        h = slice(slot * self.H_kv, (slot + 1) * self.H_kv)
        bstate.win_k[:, h] = state.win_k
        bstate.win_v[:, h] = state.win_v

    def shared(self, state) -> dict:
        """The step's per-head positions [B·H_kv], where there are window
        layers."""
        return {"pos_h": per_head(state.pos, self.H_kv)} if self.ring else {}

    def decode_batched(self, state, idx: int, q, k_new, v_new,
                       shared) -> torch.Tensor:
        """Window layer idx of a batched step: write each slot's new K/V
        (k/v_new [B, H_kv, D]) at row pos % window of its ring, then attend
        the ring with q [B, H, D], rows past pos masked while the ring is
        not yet full. Returns out [B, H, D]. Reads no count on the host."""
        B, H, D = q.shape
        Hf = B * self.H_kv
        w, W = self.ring[idx], self.window
        pos = shared["pos_h"].long()
        heads = torch.arange(Hf, device=q.device)
        ring_k, ring_v = state.win_k[w], state.win_v[w]
        ring_k[heads, pos % W] = k_new.reshape(Hf, D).to(ring_k.dtype)
        ring_v[heads, pos % W] = v_new.reshape(Hf, D).to(ring_v.dtype)
        mask = torch.arange(W, device=q.device)[None, :] <= pos[:, None]
        out = decode_window_attention_segments(
            q.reshape(B * H, 1, D), [(ring_k, ring_v, mask)])
        return out.reshape(B, H, D)
