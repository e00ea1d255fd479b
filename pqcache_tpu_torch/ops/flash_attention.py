"""K2: causal flash attention for prefill, and the row statistics K4 reads.

The CUDA kernel ``csrc/flash_attention.cu`` replaces the Pallas TPU kernel
``pqcache_tpu/ops/flash_attention.py::flash_attention`` (``_flash_kernel_tri``
/ ``_flash_kernel``); its plain PyTorch version is
``ops/attention_ref.chunked_attention``. On a CPU tensor the wrapper computes
the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch.ops import _build
from pqcache_tpu_torch.ops.attention_ref import _as_int, chunked_attention

SUPPORTED_HEAD_DIMS = (64, 128)
# (q/k width, v width) of K2's variant with values narrower than the keys
# and a given logit scale: MLA's expanded heads (``models/deepseek_v2.py``)
SUPPORTED_QK_V = ((192, 128),)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor | None,
           what: str, dv: bool = False) -> None:
    """Raise on what the kernel does not take (CUDA tensors only); ``dv``:
    the variant with narrower values (SUPPORTED_QK_V)."""
    H, _, D = q.shape
    H_kv, Tk, Dk = k.shape
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if k.device != q.device or (v is not None and v.device != q.device):
        raise ValueError(f"{what}: q, k, v on different devices")
    dtypes = (q.dtype, k.dtype) + (() if v is None else (v.dtype,))
    if any(dt != torch.bfloat16 for dt in dtypes):
        raise TypeError(f"{what} kernel takes bf16, got {dtypes}")
    if dv:
        ok = ((D, v.shape[-1]) in SUPPORTED_QK_V and Dk == D and Tk >= 1
              and v.shape[:2] == k.shape[:2])
    else:
        ok = (D in SUPPORTED_HEAD_DIMS and Dk == D and Tk >= 1
              and (v is None or v.shape == k.shape))
    if not ok:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}"
                         + ("" if v is None else f" v {tuple(v.shape)}"))
    if H % H_kv:
        raise ValueError(f"{what}: H={H} not a multiple of H_kv={H_kv}")


def _launch(q, k, v, out, m, l, lo: int, hi: int, q_offset: int,
            causal: bool, what: str, window: int = 0, scale=None) -> None:
    """One launch of K2 (v None: its stats-only mode; window > 0: its
    window variant, causal, no statistics; scale given: its variant with
    narrower values, no statistics); tensors contiguous, on one card. TMA
    reads 16-byte aligned rows."""
    ptrs = [0 if x is None else x.data_ptr() for x in (q, k, v, out, m, l)]
    if any(p % 16 for p in ptrs[:4]):
        raise ValueError(f"{what}: q, k, v must be 16-byte aligned")
    H, Tq, D = q.shape
    H_kv, Tk, _ = k.shape
    lib, stream = _build.lib("flash_attention"), _build.stream_ptr(q.device)
    if scale is not None:
        rc = lib.pq_flash_attention_dv(*ptrs[:4], H, H_kv, Tq, Tk, D,
                                       v.shape[-1], lo, hi, int(q_offset),
                                       int(causal), float(scale), stream)
    elif window:
        rc = lib.pq_flash_attention_window(*ptrs[:4], H, H_kv, Tq, Tk, D, lo,
                                           hi, int(q_offset), int(window),
                                           stream)
    else:
        rc = lib.pq_flash_attention(*ptrs, H, H_kv, Tq, Tk, D, lo, hi,
                                    int(q_offset), int(causal), stream)
    _build.check(rc, what)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_lo=0, valid_len=None, *, causal: bool = True,
                    q_offset: int = 0, return_stats: bool = False,
                    window: int = 0, scale=None):
    """q [H, Tq, D], k/v [H_kv, Tk, D] -> out [H, Tq, D] (q.dtype).

    Keys outside [valid_lo, valid_len) are masked (valid_len defaults to
    Tk); with ``causal`` a key at index > q_offset + q row is masked too.
    Query rows that see no valid key come out 0. The kernel takes bf16 q, k
    and v with D in SUPPORTED_HEAD_DIMS.

    ``window`` > 0 (causal, no statistics): a key at index <= q_offset + q
    row - window is masked too, a sliding layer's band. The kernel's
    window variant skips the key tiles wholly below a q tile's band and
    masks by element only the tiles that straddle it; window 0 launches
    the kernel without the bound.

    ``scale`` given (no window, no statistics): logits times ``scale``
    instead of 1/sqrt(D), and v may be narrower, [H_kv, Tk, Dv], the output
    [H, Tq, Dv]: the kernel's variant for (D, Dv) in SUPPORTED_QK_V, MLA's
    expanded prefill heads (192 / 128).

    With ``return_stats`` returns (out, m, l), the row statistics K4 reads
    ([H, Tq] f32): m the row max of the scaled logit, l the sum of
    exp(logit - m) over the row's valid keys; a row that sees no key, or
    whose position q_offset + row is outside [valid_lo, valid_len), has
    m = -1e30 and l = 0."""
    if window and (not causal or return_stats or window < 0):
        raise ValueError("a window needs causal attention without row "
                         "statistics")
    if scale is not None and (window or return_stats):
        raise ValueError("a given scale takes no window and no row "
                         "statistics")
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, valid_len=valid_len,
                                 valid_lo=valid_lo, causal=causal,
                                 q_offset=q_offset, return_stats=return_stats,
                                 window=window, scale=scale)
    _check(q, k, v, "flash_attention", dv=scale is not None)
    H, Tq, _ = q.shape
    Tk = k.shape[1]
    lo = max(_as_int(valid_lo), 0)
    hi = Tk if valid_len is None else min(_as_int(valid_len), Tk)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((H, Tq, v.shape[-1]), dtype=q.dtype, device=q.device)
    m = l = None
    if return_stats:
        m, l = torch.empty((2, H, Tq), dtype=torch.float32, device=q.device)
    _launch(q, k, v, out, m, l, lo, hi, q_offset, causal, "flash_attention",
            window, scale)
    flash_attention.launches += 1
    return (out, m, l) if return_stats else out


flash_attention.launches = 0


def row_stats(q: torch.Tensor, k: torch.Tensor, lo: int, hi: int):
    """K2's stats-only mode on a CUDA tensor (no P V, no output): the causal
    row statistics (m, l) [H, T] f32 of q [H, T, D] against k [H_kv, T, D]
    over keys and rows in [lo, hi), as ``flash_attention(..., causal=True,
    return_stats=True)`` gives them. K4's wrapper calls it when no row
    statistics are handed in; it does not count as a flash_attention
    launch."""
    _check(q, k, None, "row_stats")
    H, T, _ = q.shape
    m, l = torch.empty((2, H, T), dtype=torch.float32, device=q.device)
    _launch(q.contiguous(), k.contiguous(), None, None, m, l, lo, hi, 0, True,
            "row_stats")
    return m, l
