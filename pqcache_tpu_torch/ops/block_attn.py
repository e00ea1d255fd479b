"""K1: block-retrieval decode attention over the selected tail blocks.

The CUDA kernel ``csrc/block_attn.cu`` replaces the Pallas TPU kernel
``pqcache_tpu/ops/block_attn_pallas.py::block_topk_attention`` (body
``_kernel``); its plain PyTorch version is ``block_topk_attention_ref``,
ported from ``block_topk_attention_xla``. On a CPU tensor the wrapper
computes the plain version; on a CUDA tensor it launches the kernel or
raises.

Both take the TPU kernel's options: local-window coverage (``win_len`` /
``win_max``: the batched decode attends each slot's local window in the same
pass) and the pair fetch (``pair``), which computes the same function.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch.ops import _build
from pqcache_tpu_torch.ops.attention_ref import NEG_INF
from pqcache_tpu_torch.runtime.stages import scoped

SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_GROUPS = (1, 2, 4, 8)
# (kv_tail dtype, q dtype) -> the kernel's kv_dtype code: bf16 rows take a
# bf16 query, int8 rows the f32 query with the K scale folded in
_DTYPES = {(torch.bfloat16, torch.bfloat16): 1, (torch.int8, torch.float32): 2}
_ID_DTYPES = (torch.int32, torch.int64)


def _check_options(N: int, block: int, pair: bool, win_len, win_max: int):
    if pair and N % (2 * block):
        raise ValueError(f"block_topk_attention: pair fetch needs the tail "
                         f"length {N} to be a multiple of 2 * block "
                         f"({2 * block})")
    if win_max < 0 or (win_max and win_len is None):
        raise ValueError("block_topk_attention: win_max > 0 needs win_len")


def _per_head(x, H_kv: int, device) -> torch.Tensor:
    """An int, a 0-d tensor or an [H_kv] tensor -> [H_kv] int64."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=device, dtype=torch.long)
        return x.expand(H_kv) if x.dim() == 0 else x
    return torch.full((H_kv,), int(x), dtype=torch.long, device=device)


@scoped("pq_fetch")
def block_topk_attention_ref(q, kv_tail, layer, blk_idx, n_cand, *, block,
                             pair: bool = False, win_len=None,
                             win_max: int = 0):
    """Plain PyTorch version with the kernel's contract (see
    block_topk_attention)."""
    H, _, D = q.shape
    _, H_kv, N, _ = kv_tail.shape
    _check_options(N, block, pair, win_len, win_max)
    group = H // H_kv
    nb_sel = blk_idx.shape[1]
    offs = torch.arange(block, device=q.device)
    n_c = _per_head(n_cand, H_kv, q.device)
    rows = (blk_idx.long()[:, :, None] * block + offs).reshape(
        H_kv, nb_sel * block)
    mask = rows < n_c[:, None]
    if win_max:
        # the aligned blocks spanning [n_cand, n_cand + win_len), clamped to
        # the tail's last block; a clamped duplicate is masked (not_dup)
        nb_local = -(-win_max // block) + 1
        lo_blk = torch.div(n_c, block, rounding_mode="floor")
        ent = lo_blk[:, None] + torch.arange(nb_local, device=q.device)
        lrows = (ent.clamp(max=N // block - 1)[:, :, None] * block
                 + offs).reshape(H_kv, nb_local * block)
        wl = _per_head(win_len, H_kv, q.device).clamp(0, win_max)
        hi_blk = torch.div(n_c + wl - 1, block, rounding_mode="floor")
        lmask = ((lrows >= n_c[:, None]) & (lrows < (n_c + wl)[:, None])
                 & (ent <= hi_blk[:, None]).repeat_interleave(block, 1))
        rows = torch.cat([rows, lrows], 1)
        mask = torch.cat([mask, lmask], 1)
    heads = torch.arange(H_kv, device=q.device)
    kv = kv_tail[int(layer)][heads[:, None], rows]        # [H_kv, W, 2D]
    k, v = kv[..., :D].float(), kv[..., D:].float()
    qg = q.reshape(H_kv, group, D).float() / (D ** 0.5)
    s = torch.einsum("hgd,hwd->hgw", qg, k)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(mask[:, None, :], torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("hgw,hwd->hgd", p, v)
    return m, l, acc


def _count_arg(x, H_kv: int, device, what: str):
    """n_cand or win_len as the kernel reads it: (tensor kept alive, device
    pointer, stride, scalar). A tensor stays on the card (a 0-d one is read
    by every head, stride 0): a value read on the host would be frozen into
    a captured CUDA graph."""
    if not isinstance(x, torch.Tensor):
        return None, None, 0, int(x)
    if x.dim() > 1 or (x.dim() == 1 and x.shape[0] != H_kv):
        raise ValueError(f"block_topk_attention: {what} of shape "
                         f"{tuple(x.shape)} for {H_kv} kv heads")
    x = x.to(device=device, dtype=torch.int32).contiguous()
    return x, x.data_ptr(), int(x.dim() == 1), 0


@scoped("pq_fetch")
def block_topk_attention(q: torch.Tensor, kv_tail: torch.Tensor, layer,
                         blk_idx: torch.Tensor, n_cand, *, block: int,
                         n_par: int = 4, pair: bool = False, win_len=None,
                         win_max: int = 0):
    """Attention partials of q over the selected candidate blocks and, with
    win_max > 0, each head's local window.

    q [H, 1, D] (bf16 with a bf16 tail; f32 with an int8 tail, its K scale
    folded in); kv_tail [L, H_kv, N, 2D] (N % block == 0; H_kv may be the
    folded B·H_kv of the batched decode); layer: int; blk_idx [H_kv, nb_sel]
    block ids; n_cand: int, 0-d tensor or [H_kv] tensor — tail rows at index
    >= n_cand are masked.

    ``win_len`` / ``win_max``: win_max > 0 also attends the contiguous rows
    [n_cand, n_cand + win_len) of each head (win_len: int, 0-d or [H_kv]
    tensor, at most win_max) in the same online-softmax pass. ``pair``: the
    TPU kernel's 2·block-aligned pair fetch; the result is the same, and it
    needs N % (2·block) == 0. ``n_par`` was the TPU kernel's count of DMA
    lanes and does not change the result: it is accepted and ignored.

    Returns (m [H_kv, g], l [H_kv, g], acc [H_kv, g, D]) float32
    online-softmax partials (logits scaled by 1/sqrt(D)) for
    ops/attention_ref.decode_window_attention_segments."""
    if q.device.type == "cpu":
        return block_topk_attention_ref(q, kv_tail, layer, blk_idx, n_cand,
                                        block=block, pair=pair,
                                        win_len=win_len, win_max=win_max)
    if q.device.type != "cuda":
        raise ValueError(f"block_topk_attention: unsupported device "
                         f"{q.device}")
    H, one, D = q.shape
    L, H_kv, N, D2 = kv_tail.shape
    nb_sel = blk_idx.shape[-1]
    _check_options(N, block, pair, win_len, win_max)
    if kv_tail.device != q.device or blk_idx.device != q.device:
        raise ValueError("block_topk_attention: tensors on different devices")
    if (one != 1 or D not in SUPPORTED_HEAD_DIMS or D2 != 2 * D
            or H % H_kv or H // H_kv not in SUPPORTED_GROUPS
            or blk_idx.shape != (H_kv, nb_sel) or nb_sel < 1
            or block < 1 or N % block):
        raise ValueError(
            f"block_topk_attention: unsupported shapes q {tuple(q.shape)} "
            f"kv_tail {tuple(kv_tail.shape)} blk_idx {tuple(blk_idx.shape)} "
            f"block {block}")
    kv_code = _DTYPES.get((kv_tail.dtype, q.dtype))
    if kv_code is None:
        raise TypeError(f"block_topk_attention: unsupported dtypes q "
                        f"{q.dtype}, kv_tail {kv_tail.dtype}")
    if not kv_tail.is_contiguous() or kv_tail.data_ptr() % 16:
        raise ValueError("block_topk_attention: kv_tail must be contiguous "
                         "and 16-byte aligned")
    layer = int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"block_topk_attention: layer {layer} out of range")
    g = H // H_kv
    q = q.contiguous()
    # the kernel reads int32 or int64 ids as they are: no cast launch
    blk = blk_idx if blk_idx.dtype in _ID_DTYPES else blk_idx.to(torch.int32)
    blk = blk.contiguous()
    # (the converted count tensors stay referenced until the launch)
    n_keep, n_ptr, n_stride, n_scalar = _count_arg(n_cand, H_kv, q.device,
                                                   "n_cand")
    w_keep, w_ptr, w_stride, w_scalar = (
        _count_arg(win_len, H_kv, q.device, "win_len") if win_max
        else (None, None, 0, 0))
    # the outputs (m, l, acc): one f32 buffer cut into views, and nothing else
    out = torch.empty(H_kv * g * (D + 2), dtype=torch.float32,
                      device=q.device)
    m, l, acc = out.split([H_kv * g] * 2 + [H_kv * g * D])
    _build.check(_build.lib("block_attn").pq_block_attn(
        q.data_ptr(), kv_tail.data_ptr(), kv_code, H_kv, N, D, g, layer,
        blk.data_ptr(), int(blk.dtype == torch.int64), nb_sel, n_ptr,
        n_stride, n_scalar, int(win_max), w_ptr, w_stride, w_scalar, block,
        m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        _build.stream_ptr(q.device)), "block_topk_attention")
    m, l, acc = m.view(H_kv, g), l.view(H_kv, g), acc.view(H_kv, g, D)
    block_topk_attention.launches += 1
    return m, l, acc


block_topk_attention.launches = 0


def last_ctas() -> int:
    """CTAs per kv head that the kernel's last launch chose."""
    return _build.lib("block_attn").pq_block_attn_ctas()
