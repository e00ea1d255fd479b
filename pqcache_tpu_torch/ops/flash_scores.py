"""K4: per-key columns of the causal softmax, for the score-reading policies.

The CUDA kernels ``csrc/flash_scores.cu`` (a column pass fed with K2's row
statistics, after a small pass that folds each row's (m, l) into one
log-sum-exp) replace the Pallas TPU kernel
``pqcache_tpu/ops/flash_attention.py::flash_scores`` (``_score_kernel``); the
plain PyTorch version is ``ops/attention_ref.flash_scores_ref``. On a CPU
tensor the wrapper computes the plain version; on a CUDA tensor it launches
the kernels or raises.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch.ops import _build
from pqcache_tpu_torch.ops.attention_ref import (_as_int, check_row_stats,
                                                 flash_scores_ref)
from pqcache_tpu_torch.ops.flash_attention import _check
from pqcache_tpu_torch.ops.flash_attention import row_stats as k2_row_stats

SCORE_MODES = ("sum", "max")


def flash_scores(q: torch.Tensor, k: torch.Tensor, valid_lo=0,
                 valid_len=None, *, score_mode: str = "sum",
                 recent_cnt: int = 32, row_stats=None) -> torch.Tensor:
    """q [H, T, D], k [H_kv, T, D] -> F [H, T] float32.

    A pair (q row, key) counts when both lie in [valid_lo, valid_len) and
    key <= q row. "sum": F[h, t] = sum over q rows of the softmax
    probability p(q, t); "max": F[h, t] = max of p(q, t) over pairs with
    t <= q - recent_cnt. Columns that no pair reaches are 0. The kernels
    take bf16 q and k with D 64 or 128.

    ``row_stats`` (m, l), each [H, T] f32, as ``flash_attention(...,
    return_stats=True)`` returns them for the same q, k and valid range:
    given, only the column pass runs; absent, K2's stats-only mode computes
    them first."""
    if score_mode not in SCORE_MODES:
        raise ValueError(f"flash_scores: score_mode {score_mode!r} not in "
                         f"{SCORE_MODES}")
    check_row_stats(row_stats, q.shape[:2], "flash_scores")
    if q.device.type == "cpu":
        return flash_scores_ref(q, k, valid_lo, valid_len,
                                score_mode=score_mode, recent_cnt=recent_cnt,
                                row_stats=row_stats)
    _check(q, k, None, "flash_scores")
    H, T, D = q.shape
    H_kv, Tk, _ = k.shape
    if Tk != T:
        raise ValueError(f"flash_scores: q has {T} rows, k {Tk}")
    lo = max(_as_int(valid_lo), 0)
    hi = T if valid_len is None else min(_as_int(valid_len), T)
    q, k = q.contiguous(), k.contiguous()
    if any(x.data_ptr() % 16 for x in (q, k)):
        raise ValueError("flash_scores: q and k must be 16-byte aligned")
    if row_stats is None:
        m, l = k2_row_stats(q, k, lo, hi)
    else:
        m, l = (x.to(device=q.device, dtype=torch.float32).contiguous()
                for x in row_stats)
    f = torch.empty((H, T), dtype=torch.float32, device=q.device)
    # scratch: each row's base-2 log-sum-exp, rows padded to the q tile
    lse2 = torch.empty((H, -(-T // 128) * 128), dtype=torch.float32,
                       device=q.device)
    _build.check(_build.lib("flash_scores").pq_flash_scores(
        q.data_ptr(), k.data_ptr(), m.data_ptr(), l.data_ptr(),
        lse2.data_ptr(), f.data_ptr(), H, H_kv, T, D, lo, hi,
        int(score_mode == "max"), int(recent_cnt),
        _build.stream_ptr(q.device)), "flash_scores")
    flash_scores.launches += 1
    return f


flash_scores.launches = 0
