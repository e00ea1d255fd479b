"""Prefill attention dispatch: the CUDA kernels K2 (+ K4) or their plain
versions.

Counterpart of ``pqcache_tpu/ops/dispatch.py::dense_prefill_attention`` and
``prefill_chunk_attention``.
There is no head-dim gate: the kernel wrappers take the head dims they
support and raise on any other.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch.ops.attention_ref import (chunked_attention,
                                                 flash_scores_ref)
from pqcache_tpu_torch.ops.flash_attention import flash_attention
from pqcache_tpu_torch.ops.flash_scores import flash_scores


def dense_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, pad_len, *,
                            with_scores: bool = False,
                            score_mode: str = "sum",
                            use_kernel: bool = True):
    """Causal self-attention over a left-padded prompt (keys before
    ``pad_len`` are masked). Returns (out [H, T, D], scores [H, T] f32 or
    None): with ``with_scores`` the per-key softmax columns of
    ``score_mode`` "sum" or "max" (K4, with its default recent window of
    32, as JAX's dispatch leaves it). K2 then hands its row statistics to
    K4, which runs its column pass only.

    use_kernel=False runs the plain versions (RuntimeConfig.kernels="xla"),
    with the same hand-off."""
    attn = flash_attention if use_kernel else chunked_attention
    if not with_scores:
        return attn(q, k, v, valid_lo=pad_len, causal=True), None
    out, m, l = attn(q, k, v, valid_lo=pad_len, causal=True,
                     return_stats=True)
    scores = flash_scores if use_kernel else flash_scores_ref
    return out, scores(q, k, valid_lo=pad_len, score_mode=score_mode,
                       row_stats=(m, l))


def prefill_chunk_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, pad_len, *, q_offset: int,
                            use_kernel: bool = True,
                            window: int = 0, scale=None) -> torch.Tensor:
    """Causal attention of one prefill q chunk [H, Tq, D], whose row 0 sits
    at key index q_offset, against the keys k/v [H_kv, Tk, D] (keys before
    ``pad_len`` masked; keys past q_offset + Tq - 1 are masked by causality,
    so k may run past the chunk). Returns [H, Tq, D]: K2 at ``q_offset``,
    or with use_kernel=False its plain version, which the JAX package's
    ``chunked_attention_rect`` computes too. ``window`` > 0: a sliding
    layer's band, each row attending its last ``window`` keys (K2's
    window bound). ``scale``: the logits' scale where it is not
    1/sqrt(q width), and v [H_kv, Tk, Dv] may then be narrower than q and
    k (MLA's expanded heads, K2's 192 / 128 variant)."""
    attn = flash_attention if use_kernel else chunked_attention
    if window:
        return attn(q, k, v, valid_lo=pad_len, causal=True,
                    q_offset=q_offset, window=window)
    return attn(q, k, v, valid_lo=pad_len, causal=True, q_offset=q_offset,
                scale=scale)
