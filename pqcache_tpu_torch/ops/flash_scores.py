"""K4: per-key columns of the causal softmax, for the score-reading policies.

The CUDA kernels ``csrc/flash_scores.cu`` (a row-stats pass and a column
pass) replace the Pallas TPU kernel
``pqcache_tpu/ops/flash_attention.py::flash_scores`` (``_score_kernel``); the
plain PyTorch version is ``ops/attention_ref.flash_scores_ref``. On a CPU
tensor the wrapper computes the plain version; on a CUDA tensor it launches
the kernels or raises.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch.ops import _build
from pqcache_tpu_torch.ops.attention_ref import _as_int, flash_scores_ref

SUPPORTED_HEAD_DIMS = (64, 128)
SCORE_MODES = ("sum", "max")


def flash_scores(q: torch.Tensor, k: torch.Tensor, valid_lo=0,
                 valid_len=None, *, score_mode: str = "sum",
                 recent_cnt: int = 32) -> torch.Tensor:
    """q [H, T, D], k [H_kv, T, D] -> F [H, T] float32.

    A pair (q row, key) counts when both lie in [valid_lo, valid_len) and
    key <= q row. "sum": F[h, t] = sum over q rows of the softmax
    probability p(q, t); "max": F[h, t] = max of p(q, t) over pairs with
    t <= q - recent_cnt. Columns that no pair reaches are 0. The kernels
    take bf16 q and k with D in SUPPORTED_HEAD_DIMS."""
    if score_mode not in SCORE_MODES:
        raise ValueError(f"flash_scores: score_mode {score_mode!r} not in "
                         f"{SCORE_MODES}")
    if q.device.type == "cpu":
        return flash_scores_ref(q, k, valid_lo, valid_len,
                                score_mode=score_mode, recent_cnt=recent_cnt)
    H, T, D = q.shape
    H_kv, Tk, Dk = k.shape
    if q.device.type != "cuda" or k.device != q.device:
        raise ValueError(f"flash_scores: q on {q.device}, k on {k.device}")
    if not q.dtype == k.dtype == torch.bfloat16:
        raise TypeError(f"flash_scores kernel takes bf16, got {q.dtype}, "
                        f"{k.dtype}")
    if D not in SUPPORTED_HEAD_DIMS or Dk != D or Tk != T or H % H_kv:
        raise ValueError(f"flash_scores: unsupported shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)}")
    lo = max(_as_int(valid_lo), 0)
    hi = T if valid_len is None else min(_as_int(valid_len), T)
    q, k = q.contiguous(), k.contiguous()
    # F, then the row-stats scratch (m, l) of the first pass
    buf = torch.empty((3, H, T), dtype=torch.float32, device=q.device)
    _build.check(_build.lib("flash_scores").pq_flash_scores(
        q.data_ptr(), k.data_ptr(), buf[0].data_ptr(), buf[1].data_ptr(),
        buf[2].data_ptr(), H, H_kv, T, D, lo, hi, int(score_mode == "max"),
        int(recent_cnt), _build.stream_ptr(q.device)), "flash_scores")
    flash_scores.launches += 1
    return buf[0]


flash_scores.launches = 0
