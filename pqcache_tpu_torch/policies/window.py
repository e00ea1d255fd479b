"""The sliding-window layers' KV, beside a policy's full-layer state.

A model whose layers differ in kind (``config.AfmoeConfig``) hands every
layer to one policy. The policy keeps its own state (PQ retrieval, or the
dense cache) for the full-attention layers only, and for each window layer
a ring of the sequence's last ``window`` keys and values
(``runtime/state.py``'s ``win_kv``, K and V interleaved per row as in
``kv_tail``): the token at position p sits at row p % window, so a decode
step writes one row and attends the ring's valid rows [0, min(p + 1,
window)), no selection. That is K1's work over the ring's blocks with
``n_cand`` = min(p + 1, window) (``window_attention``). ``WindowLayers``
maps a policy's layer index to its kind and does the window layers' work
for ``pq_search`` and ``original`` alike; where the model has no window
layer it maps every layer to itself and none of this runs.

Positions count real tokens (a left-padded prompt's first real token is
position 0), as the model's RoPE does: during a batched step the new
token's position is the slot's ``pos`` counter, advanced after the step.
"""

from __future__ import annotations

import math

import torch

from pqcache_tpu_torch.ops.block_attn import block_attention
from pqcache_tpu_torch.runtime.state import per_head

# K1's block over a ring: the ring's rows in order, in blocks of up to 256
MAX_BLOCK = 256


def window_attention(q: torch.Tensor, win_kv: torch.Tensor, ring: int,
                     blk_idx: torch.Tensor, n_valid: torch.Tensor,
                     block: int) -> torch.Tensor:
    """Attention of q [B·H, 1, D] over the rows [0, n_valid) of each
    folded head's ring ``win_kv[ring]`` (win_kv [L_w, B·H_kv, W, 2D], K |
    V; n_valid int32 [B·H_kv], at least 1, so that every head's sum l is
    at least 1), by one K1 launch in no profiler scope (the plain version
    on CPU tensors), then one divide into q's dtype. blk_idx [B·H_kv, W
    // block]: every block of the ring, in order. Returns out [B·H, D].
    Counts its launches in ``window_attention.launches``."""
    _, l, acc = block_attention(q, win_kv, ring, blk_idx, n_valid,
                                block=block)
    if q.device.type == "cuda":
        window_attention.launches += 1
    out = torch.empty(acc.shape, dtype=q.dtype, device=q.device)
    torch.div(acc, l[..., None], out=out)
    return out.reshape(-1, acc.shape[-1])


window_attention.launches = 0


class WindowLayers:
    """Layer kinds of a model (``ModelConfig``): ``full[idx]`` is a full
    layer's index into the policy's stacked state, ``ring[idx]`` a window
    layer's index into ``win_kv``."""

    def __init__(self, model):
        self.full = {g: i for i, g in enumerate(model.full_layers)}
        self.ring = {g: i for i, g in enumerate(model.window_layers)}
        self.window = (model.window_of(model.window_layers[0])
                       if self.ring else 0)
        self.H_kv = model.num_kv_heads
        self.block = math.gcd(self.window, MAX_BLOCK)
        self._blocks = {}       # (folded heads, device) -> blk_idx

    def prefill(self, state, idx: int, k: torch.Tensor, v: torch.Tensor,
                pad_len: int, true_len: int) -> None:
        """Window layer idx of a single-sequence state from its K/V
        [H_kv, P, D] of a left-padded prompt: the last min(true_len,
        window) real tokens, each at row position % window, K | V."""
        W, n = self.window, int(true_len)
        pos = torch.arange(max(n - W, 0), n, device=k.device)
        rows = int(pad_len) + pos
        ring = state.win_kv[self.ring[idx]]
        ring[:, pos % W] = torch.cat([k[:, rows], v[:, rows]],
                                     -1).to(ring.dtype)

    def insert_slot(self, bstate, state, slot: int) -> None:
        """The window rings of a single-sequence state into slot ``slot``
        of a batched one (nothing for a model without window layers)."""
        if not self.ring:
            return
        bstate.win_kv[:, slot * self.H_kv:(slot + 1) * self.H_kv] = \
            state.win_kv

    def _block_ids(self, Hf: int, device) -> torch.Tensor:
        """Every block of a ring, in order, for each of Hf folded heads:
        int32 [Hf, window // block], made once and kept."""
        key = (Hf, str(device))
        if key not in self._blocks:
            nb = self.window // self.block
            self._blocks[key] = torch.arange(
                nb, dtype=torch.int32, device=device).repeat(Hf, 1)
        return self._blocks[key]

    def shared(self, state) -> dict:
        """The step's per-head positions [B·H_kv], where there are window
        layers."""
        return {"pos_h": per_head(state.pos, self.H_kv)} if self.ring else {}

    def _step_index(self, shared) -> None:
        """Once a step, on its first window layer (so in the
        ``window_attn`` scope): the (folded head, ring row) of each new
        token (``win_at``, int64 [B·H_kv] each), the valid rows after its
        write (``win_n`` int32 [B·H_kv], min(pos + 1, window)) and the
        rings' block ids (``win_blk``), into ``shared``. Reads no count on
        the host."""
        pos_h = shared["pos_h"]
        Hf = pos_h.shape[0]
        shared["win_at"] = (torch.arange(Hf, device=pos_h.device),
                            (pos_h % self.window).long())
        shared["win_n"] = torch.clamp(pos_h + 1, max=self.window)
        shared["win_blk"] = self._block_ids(Hf, pos_h.device)

    def decode_batched(self, state, idx: int, q, k_new, v_new,
                       shared) -> torch.Tensor:
        """Window layer idx of a batched step: write each slot's new K/V
        (k/v_new [B, H_kv, D]) in the two halves of row pos % window of its
        ring, then attend the ring's valid rows with q [B, H, D] by K1.
        Returns out [B, H, D]. Reads no count on the host."""
        B, H, D = q.shape
        Hf = B * self.H_kv
        w = self.ring[idx]
        ring = state.win_kv[w]
        if "win_at" not in shared:
            self._step_index(shared)
        heads, row = shared["win_at"]
        ring[heads, row, :D] = k_new.reshape(Hf, D).to(ring.dtype)
        ring[heads, row, D:] = v_new.reshape(Hf, D).to(ring.dtype)
        out = window_attention(q.reshape(B * H, 1, D), state.win_kv, w,
                               shared["win_blk"], shared["win_n"],
                               self.block)
        return out.reshape(B, H, D)
