"""Plain PyTorch attention: the reference versions the CUDA kernels are held
against (``chunked_attention`` for K2, ``flash_scores_ref`` for K4), the
materialized-softmax oracle ``dense_attention``, and the decode paths (the
segment merge, and the one-window attention of infllm).

Counterpart of ``pqcache_tpu/ops/attention_xla.py``. Shapes: q [H, Tq, D],
k/v [H_kv, Tk, D] (no batch dim). GQA reshapes q into [H_kv, group, ...] so
no key/value copy is made. Masked logits use the finite ``NEG_INF`` and
outputs divide by ``max(l, 1e-30)``, so rows that see no key stay finite.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite sentinel: keeps fully-masked rows NaN-free


def _as_int(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0, valid_len=None,
                    valid_lo=None, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Materialized-scores attention, O(Tq*Tk) memory: the test oracle.
    q [H, Tq, D], k/v [H_kv, Tk, D]; keys at index >= valid_len or
    < valid_lo are masked; with ``causal`` a key at index > q_offset + q row
    is masked. Returns [H, Tq, D] in q.dtype."""
    H, Tq, D = q.shape
    H_kv, Tk, _ = k.shape
    group = H // H_kv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(H_kv, group, Tq, D).float()
    logits = torch.einsum("hgqd,hkd->hgqk", qg, k.float()) * scale
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= torch.arange(Tq, device=q.device)[:, None] + q_offset
    if valid_len is not None:
        mask &= kpos < _as_int(valid_len)
    if valid_lo is not None:
        mask &= kpos >= _as_int(valid_lo)
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), -1)
    out = torch.einsum("hgqk,hkd->hgqd", probs, v.float())
    return out.reshape(H, Tq, D).to(q.dtype)


def check_row_stats(row_stats, shape, what: str) -> None:
    """Raise ValueError unless ``row_stats`` is None or a pair (m, l) of
    tensors of ``shape`` ([H, T])."""
    if row_stats is None:
        return
    shape = tuple(shape)
    if (not isinstance(row_stats, (tuple, list)) or len(row_stats) != 2
            or any(not isinstance(x, torch.Tensor) or tuple(x.shape) != shape
                   for x in row_stats)):
        got = ([tuple(getattr(x, "shape", ())) for x in row_stats]
               if isinstance(row_stats, (tuple, list)) else type(row_stats))
        raise ValueError(f"{what}: row_stats must be (m, l) of shape {shape}, "
                         f"got {got}")


def flash_scores_ref(q: torch.Tensor, k: torch.Tensor, valid_lo=0,
                     valid_len=None, *, score_mode: str = "sum",
                     recent_cnt: int = 32, block: int = 512,
                     row_stats=None) -> torch.Tensor:
    """Per-key columns of the causal softmax, the plain version of K4.

    q [H, T, D], k [H_kv, T, D] -> F [H, T] float32. A pair (q row, key)
    counts when both lie in [valid_lo, valid_len) and key <= q row; p is
    its softmax probability within the q row. "sum": F[h, t] = sum over
    q of p(q, t). "max": F[h, t] = max of p(q, t) over pairs with
    t <= q - recent_cnt (0 where there is none). Two float32 sweeps per q
    block, as ``pqcache_tpu/ops/attention_xla.py::chunked_attention``
    (with_scores=True): the first finds each row's (m, l), the second
    adds up the normalised columns; nothing larger than block x block is
    built. ``row_stats`` (m, l) [H, T], as ``chunked_attention(...,
    return_stats=True)`` gives them, replaces the first sweep."""
    if score_mode not in ("sum", "max"):
        raise ValueError(f"score_mode must be 'sum' or 'max', got "
                         f"{score_mode!r}")
    check_row_stats(row_stats, q.shape[:2], "flash_scores_ref")
    H, T, D = q.shape
    H_kv = k.shape[0]
    group = H // H_kv
    scale = 1.0 / (D ** 0.5)
    lo = max(_as_int(valid_lo), 0)
    hi = T if valid_len is None else min(_as_int(valid_len), T)
    F = torch.zeros((H_kv, group, T), dtype=torch.float32, device=q.device)
    kf = k.float()
    qg = q.reshape(H_kv, group, T, D).float() * scale
    offs = torch.arange(block, device=q.device)
    first = lo // block * block
    for i0 in range(first, hi, block):
        i1 = min(i0 + block, T)
        qpos = i0 + offs[:i1 - i0]
        q_ok = (qpos >= lo) & (qpos < hi)
        q_i = qg[:, :, i0:i1]

        def tiles():
            for j0 in range(first, min(hi, i1), block):
                kpos = j0 + offs[:min(j0 + block, T) - j0]
                mask = (q_ok[:, None] & ((kpos >= lo) & (kpos < hi))[None, :]
                        & (kpos[None, :] <= qpos[:, None]))
                lg = torch.einsum("hgqd,hkd->hgqk", q_i,
                                  kf[:, j0:j0 + kpos.numel()])
                yield j0, kpos, mask, torch.where(mask, lg, NEG_INF)

        if row_stats is None:
            m = torch.full((H_kv, group, i1 - i0), NEG_INF, device=q.device)
            l = torch.zeros((H_kv, group, i1 - i0), device=q.device)
            for _, _, mask, lg in tiles():
                m_new = torch.maximum(m, lg.amax(-1))
                p = torch.where(mask, torch.exp(lg - m_new[..., None]), 0.0)
                l = l * torch.exp(m - m_new) + p.sum(-1)
                m = m_new
        else:
            m, l = (x.float().reshape(H_kv, group, T)[:, :, i0:i1]
                    for x in row_stats)
        l = torch.clamp(l, min=1e-30)[..., None]
        for j0, kpos, mask, lg in tiles():
            if score_mode == "max":
                mask = mask & (kpos[None, :] <= qpos[:, None] - recent_cnt)
            p = torch.where(mask, torch.exp(lg - m[..., None]), 0.0) / l
            cols = F[:, :, j0:j0 + kpos.numel()]
            if score_mode == "sum":
                cols += p.sum(2)
            else:
                cols.copy_(torch.maximum(cols, p.amax(2)))
    return F.reshape(H, T)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_len=None, valid_lo=None, *, causal: bool = True,
                      q_offset: int = 0, block: int = 512,
                      return_stats: bool = False, window: int = 0,
                      scale: Optional[float] = None):
    """Online-softmax attention with q-block x k-block tiling in float32.

    Keys outside [valid_lo, valid_len) are masked (left-padded prompts);
    with ``causal`` a key at index > q_offset + q row is masked too, and
    with ``window`` > 0 (causal only) a key at index <= q_offset + q row -
    window: a sliding layer attends its last ``window`` keys.
    Returns out [H, Tq, D] in q.dtype; with ``return_stats`` (out, m, l),
    K2's row statistics [H, Tq] f32: m the row max of the scaled logit, l
    the sum of exp(logit - m) over the row's valid keys, and m = NEG_INF,
    l = 0 for a row that sees no key or whose position q_offset + row lies
    outside [valid_lo, valid_len).

    ``scale``: the logits' scale (1/sqrt(D) unless given); v may be
    narrower than q and k ([H_kv, Tk, Dv]), the output then [H, Tq, Dv].

    Masked probabilities are zeroed, as in the Pallas kernel
    (``pqcache_tpu/ops/flash_attention.py``): a query row that sees no key
    (a left-pad row) comes out 0. The JAX XLA twin leaves those probabilities
    unmasked and writes the mean of V there instead; the rows are padding
    and no later computation reads them.
    """
    H, Tq, D = q.shape
    H_kv, Tk, _ = k.shape
    Dv = v.shape[-1]
    group = H // H_kv
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    hi = Tk if valid_len is None else min(_as_int(valid_len), Tk)
    lo = 0 if valid_lo is None else max(_as_int(valid_lo), 0)

    out = torch.zeros((H_kv, group, Tq, Dv), dtype=torch.float32,
                      device=q.device)
    m_all = torch.full((H_kv, group, Tq), NEG_INF, device=q.device)
    l_all = torch.zeros((H_kv, group, Tq), device=q.device)
    kf, vf = k.float(), v.float()
    qg = q.reshape(H_kv, group, Tq, D).float() * scale
    koffs = torch.arange(block, device=q.device)
    for i0 in range(0, Tq, block):
        i1 = min(i0 + block, Tq)
        qpos = q_offset + torch.arange(i0, i1, device=q.device)
        q_i = qg[:, :, i0:i1]
        m = torch.full((H_kv, group, i1 - i0), NEG_INF, device=q.device)
        l = torch.zeros((H_kv, group, i1 - i0), device=q.device)
        acc = torch.zeros((H_kv, group, i1 - i0, Dv), device=q.device)
        k_end = hi if not causal else min(hi, q_offset + i1)
        k_lo = max(lo, q_offset + i0 - window + 1) if window else lo
        # whole k blocks outside [k_lo, k_end) contribute nothing: skip them
        for j0 in range(k_lo // block * block, k_end, block):
            j1 = min(j0 + block, Tk)
            kpos = j0 + koffs[:j1 - j0]
            mask = ((kpos >= lo) & (kpos < hi))[None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            lg = torch.einsum("hgqd,hkd->hgqk", q_i, kf[:, j0:j1])
            lg = torch.where(mask, lg, NEG_INF)
            m_new = torch.maximum(m, lg.amax(-1))
            p = torch.where(mask, torch.exp(lg - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "hgqk,hkd->hgqd", p, vf[:, j0:j1])
            m = m_new
        out[:, :, i0:i1] = acc / torch.clamp(l, min=1e-30)[..., None]
        seen = (qpos >= lo) & (qpos < hi)
        m_all[:, :, i0:i1] = torch.where(seen, m, NEG_INF)
        l_all[:, :, i0:i1] = torch.where(seen, l, 0.0)
    out = out.reshape(H, Tq, Dv).to(q.dtype)
    if return_stats:
        return out, m_all.reshape(H, Tq), l_all.reshape(H, Tq)
    return out


def segment_partial(qg: torch.Tensor, k_seg: torch.Tensor,
                    v_seg: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Online-softmax partial (m, l, acc) of qg [H_kv, g, D] over one
    key/value segment [H_kv, W, D]; mask [H_kv, W] or [W] bool. Merge the
    result with decode_window_attention_segments(..., partials=[...])."""
    H_kv, g, D = qg.shape
    scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("hgd,hwd->hgw", qg.float(), k_seg.float()) * scale
    if mask is not None:
        mask = mask if mask.dim() == 2 else mask[None].expand(H_kv, -1)
        logits = torch.where(mask[:, None, :], logits, NEG_INF)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        p = torch.where(mask[:, None, :], p, 0.0)
    l = p.sum(-1)
    acc = torch.einsum("hgw,hwd->hgd", p.to(v_seg.dtype).float(),
                       v_seg.float())
    return m, l, acc


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b [H, M, N] in f32. Two bf16 operands on the card multiply as a
    bf16 GEMM that accumulates and writes f32: a product of two bf16 values
    is exact in f32, so this is the f32 product without f32 copies of the
    operands (at decode, b is a layer's whole key or value cache)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def decode_window_attention_segments(q: torch.Tensor, segments,
                                     partials=()) -> torch.Tensor:
    """Single-step attention over several key/value segments without
    concatenating them, merged by the online-softmax (max/sum) combination.

    q [H, 1, D]; segments: list of (k [H_kv, W_i, D], v, mask [H_kv, W_i]
    bool or None); partials: precomputed (m [H_kv, g], l [H_kv, g],
    acc [H_kv, g, Dv]) from the block-retrieval kernel, merged the same
    way. The values may be narrower than the keys (Dv < D: a latent cache,
    whose values are the keys' first Dv columns). Returns [H, 1, Dv] in
    q.dtype."""
    H, _, D = q.shape
    H_kv = (segments[0][0] if segments else partials[0][0]).shape[0]
    Dv = (segments[0][1] if segments else partials[0][2]).shape[-1]
    group = H // H_kv
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(H_kv, group, D)

    m = torch.full((H_kv, group), NEG_INF, device=q.device)
    l = torch.zeros((H_kv, group), device=q.device)
    acc = torch.zeros((H_kv, group, Dv), device=q.device)
    for pm, pl_, pacc in partials:
        m_new = torch.maximum(m, pm)
        c_old = torch.exp(m - m_new)
        c_p = torch.exp(torch.clamp(pm, min=NEG_INF) - m_new)
        l = l * c_old + pl_ * c_p
        acc = acc * c_old[..., None] + pacc * c_p[..., None]
        m = m_new
    for k_seg, v_seg, mask in segments:
        logits = _bmm_f32(qg, k_seg.transpose(1, 2)) * scale
        if mask is not None:
            logits = torch.where(mask[:, None, :], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        if mask is not None:
            p = torch.where(mask[:, None, :], p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _bmm_f32(p.to(v_seg.dtype), v_seg)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(H, 1, Dv).to(q.dtype)


def decode_window_attention(q: torch.Tensor, k_win: torch.Tensor,
                            v_win: torch.Tensor,
                            win_mask: Optional[torch.Tensor] = None, *,
                            return_probs: bool = False):
    """Single-step attention over one assembled window with a materialized
    softmax. q [H, 1, D]; k/v_win [H_kv, W, D]; win_mask [H_kv, W] bool
    (True = attend). Returns out [H, 1, D] in q.dtype and, with
    ``return_probs``, the probabilities summed over each GQA group
    [H_kv, W] f32 (the attention mass each window position received)."""
    H, _, D = q.shape
    H_kv, W, _ = k_win.shape
    group = H // H_kv
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(H_kv, group, D).float()
    logits = torch.einsum("hgd,hwd->hgw", qg, k_win.float()) * scale
    if win_mask is not None:
        logits = torch.where(win_mask[:, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, -1)
    out = torch.einsum("hgw,hwd->hgd", probs.to(v_win.dtype).float(),
                       v_win.float())
    out = out.reshape(H, 1, D).to(q.dtype)
    if return_probs:
        return out, probs.sum(1)
    return out
