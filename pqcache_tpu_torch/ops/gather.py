"""K6: batched row gather.

The CUDA kernel ``csrc/gather.cu`` replaces the Pallas TPU kernel
``pqcache_tpu/ops/gather_pallas.py::gather_rows`` (body ``_gather_kernel``);
its plain PyTorch version is ``gather_rows_ref``, the JAX package's
``gather_rows_xla`` with a head offset. On a CPU tensor the wrapper computes
the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch.ops import _build


def _heads(src, idx, head_offset: int):
    H_total, T, _ = src.shape
    H = idx.shape[0]
    if idx.dim() != 2 or not 0 <= head_offset <= H_total - H:
        raise ValueError(f"gather_rows: idx {tuple(idx.shape)} with "
                         f"head_offset {head_offset} does not fit src "
                         f"{tuple(src.shape)}")
    return H, T


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor,
                    head_offset: int = 0) -> torch.Tensor:
    """Plain version of gather_rows (same contract)."""
    head_offset = int(head_offset)
    H, T = _heads(src, idx, head_offset)
    heads = torch.arange(head_offset, head_offset + H, device=src.device)
    return src[heads[:, None], idx.long().clamp(0, T - 1)]


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                head_offset: int = 0) -> torch.Tensor:
    """src [H_total, T, D'] of any dtype; idx [H, K] int32 or int64 ->
    out [H, K, D'] with out[h, j] = src[head_offset + h, idx[h, j]].
    ``head_offset`` selects a contiguous head range of a stacked buffer
    (one layer of the [L * H_kv, T, 2D] tail) without slicing it out. An
    index outside [0, T) is clamped into it, as XLA's gather does."""
    if src.device.type == "cpu":
        return gather_rows_ref(src, idx, head_offset)
    head_offset = int(head_offset)
    if src.device.type != "cuda" or idx.device != src.device:
        raise ValueError(f"gather_rows: src on {src.device}, idx on "
                         f"{idx.device}; the kernel takes both on one CUDA "
                         f"device")
    if src.dim() != 3 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"gather_rows: unsupported src {tuple(src.shape)} "
                         f"or idx dtype {idx.dtype}")
    if not src.is_contiguous():
        raise ValueError("gather_rows: src must be contiguous (a copy of a "
                         "stacked tail would cost more than the gather)")
    H, T = _heads(src, idx, head_offset)
    K = idx.shape[1]
    idx = idx.contiguous()
    out = torch.empty((H, K, src.shape[2]), dtype=src.dtype, device=src.device)
    if K == 0:
        return out
    _build.check(_build.lib("gather").pq_gather_rows(
        src.data_ptr(), idx.data_ptr(), idx.element_size(), H, K, T,
        src.shape[2] * src.element_size(), head_offset, out.data_ptr(),
        _build.stream_ptr(src.device)), "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
