"""Single-sequence state: the PQ retrieval state and the dense KV cache.

Counterpart of ``pqcache_tpu/runtime/state.py`` (the single-sequence part;
the batch-as-heads ring fields come with the batched slice). The fields and
layouts are the JAX package's, stacked over layers:

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

The counters ``n_cand`` and ``pos`` are host ints here (the JAX package keeps
device scalars): the single-sequence engine always knows them, and the
kernels take them by value, so a decode step never waits on the device for
them. Policies update these dataclasses in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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
    n_cand: int = 0
    pos: int = 0
    jhist: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


@dataclass
class DenseState:
    """Plain KV cache (`original`, `infllm`), with the accumulated scores
    and keep-mask of `h2o`."""

    k_cache: torch.Tensor    # [L, H_kv, T_max, D]
    v_cache: torch.Tensor    # [L, H_kv, T_max, D]
    length: int = 0          # tokens written (== next write slot)
    start: int = 0           # first valid slot (left-pad offset)
    pos: int = 0             # absolute position of the next token
    scores: Optional[torch.Tensor] = None   # [L, H_kv, T_max] f32
    mask: Optional[torch.Tensor] = None     # [L, H_kv, T_max] bool


def make_pq_state(cfg: EngineConfig, budget: Budget, *,
                  dtype=torch.bfloat16, device=None,
                  jhist_blocks: int = 0) -> PQState:
    """Zero-filled single-sequence PQ state on ``device`` (cuda unless
    given). The tail holds budget.n_tail_max rows (rounded up to 256);
    jhist_blocks > 0 adds the joint-code-histogram buffer, which only the
    joint-histogram scorer reads."""
    device = resolve_device(device)
    m = cfg.model
    S = cfg.pq.n_subvec_per_head
    C = cfg.pq.n_centroids
    d_lift = m.head_dim // S + (1 if cfg.pq.metric == "ip" else 0)
    L, H_kv, D = m.num_layers, m.num_kv_heads, m.head_dim
    N_tail = budget.n_tail_max
    kv_int8 = cfg.cache.kv_dtype == "int8"

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return PQState(
        k_sink=z(L, H_kv, budget.sink, D),
        v_sink=z(L, H_kv, budget.sink, D),
        kv_tail=z(L, H_kv, N_tail, 2 * D,
                  dt=torch.int8 if kv_int8 else dtype),
        codes=z(L, H_kv, S, N_tail, dt=torch.uint8),
        centroids=z(L, H_kv, S, C, d_lift, dt=torch.float32),
        phi=z(L, H_kv * S, 1, 1, dt=torch.float32),
        jhist=(z(L, H_kv, jhist_blocks, C * C, dt=torch.uint8)
               if jhist_blocks else None),
        k_scale=(torch.ones((L, H_kv, 1, D), device=device)
                 if kv_int8 else None),
        v_scale=(torch.ones((L, H_kv, 1, D), device=device)
                 if kv_int8 else None),
    )


def make_dense_state(cfg: EngineConfig, max_len: int, *,
                     with_scores: bool = False, dtype=torch.bfloat16,
                     device=None) -> DenseState:
    """Zero-filled dense cache on ``device`` (cuda unless given); the token
    dim rounds up to 256 as in the JAX package. with_scores adds the
    per-slot scores (zeros) and keep-mask (ones)."""
    device = resolve_device(device)
    m = cfg.model
    max_len = (max_len + 255) // 256 * 256
    shape = (m.num_layers, m.num_kv_heads, max_len, m.head_dim)
    return DenseState(
        k_cache=torch.zeros(shape, dtype=dtype, device=device),
        v_cache=torch.zeros(shape, dtype=dtype, device=device),
        scores=(torch.zeros(shape[:3], device=device) if with_scores
                else None),
        mask=(torch.ones(shape[:3], dtype=torch.bool, device=device)
              if with_scores else None))
