"""Sequence state: the PQ retrieval state and the dense KV cache.

Counterpart of ``pqcache_tpu/runtime/state.py``. The fields and layouts are
the JAX package's, stacked over layers:

  * ``k_sink/v_sink`` [L, H_kv, sink, D]: the first `sink` prompt tokens.
  * ``kv_tail`` [L, H_kv, N_tail, 2D]: every non-sink token in sequence
    order, K and V interleaved per row (bf16, or int8 with frozen
    per-channel scales ``k_scale/v_scale`` [L, H_kv, 1, D]). Retrieval
    candidates are ``tail[:n_cand]``, the local window
    ``tail[n_cand : n_cand + local]``.
  * ``codes`` [L, H_kv, S, N_tail] uint8 PQ codes aligned with the tail;
    ``centroids`` [L, H_kv, S, C, d]; ``phi`` [L, H_kv*S, 1, 1] (zeros for
    the euclidean metric).
  * ``jhist`` [L, H_kv, N_tail // select_block, C^2] uint8: the joint code
    histogram of the block scorer; None where that scorer does not apply
    (select_block 1 or above 256, or ``scorer="kernel"``).

A single-sequence state keeps its counters ``n_cand`` and ``pos`` as host
ints (the JAX package keeps device scalars): the single-sequence engine
always knows them, and the kernels take them by value, so a decode step
never waits on the device for them.

A batched state (``batch=B``, batch-as-heads) folds B sequence slots into
the kv-head axis ([L, B·H_kv, ...], slot-major) and keeps its counters on
the device, as the JAX package does: ``n_cand``, ``pos`` (and ``length``,
``start`` of the dense cache) are int32 [B], so a decode step reads no
count on the host and can be captured into a CUDA graph. It adds the
write-combining ring ``ring_kv`` [L, B·H_kv, ring_k, 2D] (bf16: the
tokens of the current decode chunk, raw until the chunk's flush) with its
fill count ``ring_r`` (int32, 0-d), and a tail ``tail_pad`` rows longer,
so that the flush's ring_k rows never run past it.

A model with a latent cache (``config.DeepseekV2Config``, MLA) keeps one
kv head of width D (576) per layer, whose rows are the keys and whose
first Dv (512) columns are the values: ``kv_tail`` [L, H_kv, N_tail, D]
and ``ring_kv`` [L, B·H_kv, ring_k, D] hold each row once, and ``v_sink``
is the view ``k_sink[..., :Dv]``. Its tail is bf16.

A model with sliding-window layers (``config.AfmoeConfig``) keeps the
retrieval state (or the dense cache) of its full-attention layers only,
stacked over ``ModelConfig.full_layers``; its window layers keep
``win_kv`` [L_w, H_kv, window, 2D] beside it: a ring of each sequence's
last ``window`` keys and values, position p at row p % window, K and V
interleaved per row as in ``kv_tail``, so that K1 attends it
(``policies/window.py``). Both policies that serve such a model hold both
kinds in one state, so a slot insert moves both.

Policies update these dataclasses in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import Budget


@dataclass
class PQState:
    """Stacked-over-layers PQ retrieval state for one sequence."""

    k_sink: torch.Tensor
    v_sink: torch.Tensor
    kv_tail: torch.Tensor
    codes: torch.Tensor
    centroids: torch.Tensor
    phi: torch.Tensor
    n_cand: Union[int, torch.Tensor] = 0   # int, or int32 [B] (batched)
    pos: Union[int, torch.Tensor] = 0
    jhist: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    ring_kv: Optional[torch.Tensor] = None  # [L, B·H_kv, ring_k, 2D]
    ring_r: Optional[torch.Tensor] = None   # int32 0-d: filled ring columns
    win_kv: Optional[torch.Tensor] = None   # [L_w, H_kv, window, 2D]


@dataclass
class DenseState:
    """Plain KV cache (`original`, `infllm`), with the accumulated scores
    and keep-mask of `h2o`."""

    k_cache: torch.Tensor    # [L, H_kv, T_max, D]
    v_cache: torch.Tensor    # [L, H_kv, T_max, D]
    # int, or int32 [B] in a batched state
    length: Union[int, torch.Tensor] = 0   # tokens written (next write slot)
    start: Union[int, torch.Tensor] = 0    # first valid slot (left-pad offset)
    pos: Union[int, torch.Tensor] = 0      # position of the next token
    scores: Optional[torch.Tensor] = None   # [L, H_kv, T_max] f32
    mask: Optional[torch.Tensor] = None     # [L, H_kv, T_max] bool
    win_kv: Optional[torch.Tensor] = None   # [L_w, H_kv, window, 2D]


def per_head(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each entry of x's first axis n times in a row: a batched state's
    per-slot counts [B] -> per folded kv head [B·n] (repeat_interleave by
    a constant, without reading a count on the host)."""
    return x[:, None].expand(x.shape[0], n, *x.shape[1:]).reshape(
        x.shape[0] * n, *x.shape[1:])


def _window_ring(m, batch: int, dtype, device):
    """The window layers' rings win_kv [L_w, B·H_kv, window, 2D] (K | V),
    or None for a model without window layers."""
    if not m.window_layers:
        return None
    return torch.zeros((len(m.window_layers), max(batch, 1) * m.num_kv_heads,
                        m.window_of(m.window_layers[0]), 2 * m.head_dim),
                       dtype=dtype, device=device)


def _counters(batch: int, device, n: int):
    """n zero counters: host ints, or int32 [batch] device tensors."""
    if not batch:
        return (0,) * n
    return tuple(torch.zeros(batch, dtype=torch.int32, device=device)
                 for _ in range(n))


def make_pq_state(cfg: EngineConfig, budget: Budget, *,
                  dtype=torch.bfloat16, device=None, jhist_blocks: int = 0,
                  batch: int = 0, ring_k: int = 0,
                  tail_pad: int = 0) -> PQState:
    """Zero-filled PQ state on ``device`` (cuda unless given). The tail
    holds budget.n_tail_max rows (rounded up to 256) plus ``tail_pad``;
    jhist_blocks > 0 adds the joint-code-histogram buffer, which only the
    joint-histogram scorer reads. batch=B > 0: the batch-as-heads state, B
    slots folded into the kv-head axis, counters int32 [B] on the device;
    ring_k > 0 adds the write-combining ring of ring_k columns."""
    device = resolve_device(device)
    m = cfg.model
    S = cfg.pq.n_subvec_per_head
    C = cfg.pq.n_centroids
    d_lift = m.head_dim // S + (1 if cfg.pq.metric == "ip" else 0)
    L, D = len(m.full_layers), m.head_dim
    Hf = max(batch, 1) * m.num_kv_heads
    N_tail = budget.n_tail_max + tail_pad
    kv_int8 = cfg.cache.kv_dtype == "int8"
    if kv_int8 and m.latent_kv:
        raise ValueError("a latent (MLA) tail is bf16; kv_dtype int8 is "
                         "not supported there")
    row = D if m.latent_kv else 2 * D      # a tail row: latent, or K | V

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    n_cand, pos = _counters(batch, device, 2)
    k_sink = z(L, Hf, budget.sink, D)
    return PQState(
        k_sink=k_sink,
        v_sink=(k_sink[..., :m.value_dim] if m.latent_kv
                else z(L, Hf, budget.sink, D)),
        kv_tail=z(L, Hf, N_tail, row,
                  dt=torch.int8 if kv_int8 else dtype),
        codes=z(L, Hf, S, N_tail, dt=torch.uint8),
        centroids=z(L, Hf, S, C, d_lift, dt=torch.float32),
        phi=z(L, Hf * S, 1, 1, dt=torch.float32),
        n_cand=n_cand, pos=pos,
        jhist=(z(L, Hf, jhist_blocks, C * C, dt=torch.uint8)
               if jhist_blocks else None),
        k_scale=(torch.ones((L, Hf, 1, D), device=device)
                 if kv_int8 else None),
        v_scale=(torch.ones((L, Hf, 1, D), device=device)
                 if kv_int8 else None),
        ring_kv=z(L, Hf, ring_k, row) if ring_k else None,
        ring_r=z(dt=torch.int32) if ring_k else None,
        win_kv=_window_ring(m, batch, dtype, device),
    )


def make_dense_state(cfg: EngineConfig, max_len: int, *,
                     with_scores: bool = False, dtype=torch.bfloat16,
                     device=None, batch: int = 0) -> DenseState:
    """Zero-filled dense cache on ``device`` (cuda unless given); the token
    dim rounds up to 256 as in the JAX package. with_scores adds the
    per-slot scores (zeros) and keep-mask (ones). batch=B > 0: B slots
    folded into the kv-head axis, counters int32 [B] on the device."""
    device = resolve_device(device)
    m = cfg.model
    if m.latent_kv:
        raise ValueError("a latent (MLA) cache is kept by pq_search only")
    max_len = (max_len + 255) // 256 * 256
    shape = (len(m.full_layers), max(batch, 1) * m.num_kv_heads, max_len,
             m.head_dim)
    length, start, pos = _counters(batch, device, 3)
    return DenseState(
        k_cache=torch.zeros(shape, dtype=dtype, device=device),
        v_cache=torch.zeros(shape, dtype=dtype, device=device),
        length=length, start=start, pos=pos,
        scores=(torch.zeros(shape[:3], device=device) if with_scores
                else None),
        mask=(torch.ones(shape[:3], dtype=torch.bool, device=device)
              if with_scores else None),
        win_kv=_window_ring(m, batch, dtype, device))
