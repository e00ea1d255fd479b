"""K5 (ADC scores) and K3 (fused ADC block scorer).

The CUDA kernels of ``csrc/adc.cu`` replace the Pallas TPU kernels
``pqcache_tpu/ops/adc_pallas.py::adc_scores_pallas`` / ``adc_scores_pallas_v2``
(K5) and ``adc_block_scores_pallas`` / ``adc_block_scores_pallas_batched``
(K3). Their plain PyTorch versions are ``adc_scores_ref`` (the JAX package's
``adc_scores_xla``) and ``adc_block_scores_ref`` (ADC -> x 1/sqrt(D) -> mask
at or past n_cand -> softmax -> per-block sum). On a CPU tensor each wrapper
computes its plain version; on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import math

import torch

from pqcache_tpu_torch.ops import _build
from pqcache_tpu_torch.runtime.stages import scoped

SUPPORTED_SUBVECS = (1, 2, 4, 8, 16)
MAX_GROUP = 8             # K3: q heads per kv head (csrc/adc.cu MAX_G)


@scoped("pq_score")
def adc_scores_ref(lut: torch.Tensor, codes: torch.Tensor, *,
                   round_lut_bf16: bool = False) -> torch.Tensor:
    """Plain version of adc_scores (same contract)."""
    if round_lut_bf16:
        lut = lut.bfloat16()
    lut = lut.float()
    *lead, H_kv, g, S, C = lut.shape
    T = codes.shape[-1]
    idx = codes.long().unsqueeze(-3).expand(*lead, H_kv, g, S, T)
    return torch.gather(lut, -1, idx).sum(-2)


def _check_adc(name, lut, codes):
    if lut.device.type != "cuda" or codes.device != lut.device:
        raise ValueError(f"{name}: lut on {lut.device}, codes on "
                         f"{codes.device}; the kernel takes both on one "
                         f"CUDA device")
    if lut.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError(f"{name}: takes an f32 lut and uint8 codes, got "
                        f"{lut.dtype} and {codes.dtype}")
    if lut.dim() < 4 or codes.dim() != lut.dim() - 1:
        raise ValueError(f"{name}: lut {tuple(lut.shape)} and codes "
                         f"{tuple(codes.shape)} do not match")
    *lead, H_kv, g, S, C = lut.shape
    if (tuple(codes.shape[:-1]) != (*lead, H_kv, S)
            or S not in SUPPORTED_SUBVECS or not 1 <= C <= 256
            or codes.shape[-1] < 1):
        raise ValueError(f"{name}: unsupported shapes lut "
                         f"{tuple(lut.shape)} codes {tuple(codes.shape)}")
    return lut.contiguous(), codes.contiguous()


@scoped("pq_score")
def adc_scores(lut: torch.Tensor, codes: torch.Tensor, *,
               round_lut_bf16: bool = False) -> torch.Tensor:
    """Per-token ADC scores.

    lut [..., H_kv, g, S, C] f32; codes [..., H_kv, S, T] uint8 with the
    same leading dims (folded into the kv-head axis). Returns scores
    [..., H_kv, g, T] f32, scores[h, j, t] = sum_s lut[h, j, s,
    codes[h, s, t]]. ``round_lut_bf16`` rounds the LUT entries to bf16
    first, as the v2 TPU kernel does (``PQConfig.adc_mode="v2"``; "v1"
    sums the f32 entries)."""
    if lut.device.type == "cpu":
        return adc_scores_ref(lut, codes, round_lut_bf16=round_lut_bf16)
    lut, codes = _check_adc("adc_scores", lut, codes)
    *lead, H_kv, g, S, C = lut.shape
    T = codes.shape[-1]
    out = torch.empty((*lead, H_kv, g, T), dtype=torch.float32,
                      device=lut.device)
    _build.check(_build.lib("adc").pq_adc_scores(
        lut.data_ptr(), codes.data_ptr(), math.prod(lead) * H_kv, g, S, C, T,
        int(round_lut_bf16), out.data_ptr(), _build.stream_ptr(lut.device)),
        "adc_scores")
    adc_scores.launches += 1
    return out


adc_scores.launches = 0


def _n_cand_rows(n_cand, B: int, device):
    """n_cand as a [B] tensor -> [B, 1, 1]; an int or a 0-d tensor is
    returned as it is (it broadcasts, and needs no copy to the device)."""
    if isinstance(n_cand, torch.Tensor) and n_cand.dim() == 1:
        return n_cand.to(device).reshape(B, 1, 1)
    return n_cand


@scoped("pq_score")
def adc_block_scores_ref(lut: torch.Tensor, codes: torch.Tensor, n_cand, *,
                         sel_block: int, head_dim: int) -> torch.Tensor:
    """Plain version of adc_block_scores (same contract)."""
    batched = lut.dim() == 5
    if not batched:
        lut, codes = lut[None], codes[None]
    B, H_kv, g, S, C = lut.shape
    T = codes.shape[-1]
    if T % sel_block:
        raise ValueError(f"T={T} must be a multiple of sel_block={sel_block}")
    scores = adc_scores_ref(lut, codes).reshape(B, H_kv * g, T)
    valid = (torch.arange(T, device=lut.device)[None, None, :]
             < _n_cand_rows(n_cand, B, lut.device))
    masked = torch.where(valid, scores / math.sqrt(head_dim), -torch.inf)
    probs = torch.where(valid, torch.softmax(masked, -1), 0.0)
    out = probs.reshape(B, H_kv * g, T // sel_block, sel_block).sum(-1)
    return out if batched else out[0]


@scoped("pq_score")
def adc_block_scores(lut: torch.Tensor, codes: torch.Tensor, n_cand, *,
                     sel_block: int, head_dim: int) -> torch.Tensor:
    """Fused ADC -> softmax -> per-block attention mass (euclidean metric).

    lut [(B,) H_kv, g, S, C] f32; codes [(B,) H_kv, S, T] uint8 with
    T % sel_block == 0; n_cand an int, or a [B] tensor of per-slot counts:
    tokens at index >= n_cand carry no mass. Returns the per-q-head block
    mass [(B,) H, T // sel_block] f32, each row summing to 1 over its valid
    blocks (all zeros where n_cand is 0). Group sum and top-k stay with the
    caller (``core/pq.topk_from_block_mass``)."""
    if lut.device.type == "cpu":
        return adc_block_scores_ref(lut, codes, n_cand, sel_block=sel_block,
                                    head_dim=head_dim)
    lut, codes = _check_adc("adc_block_scores", lut, codes)
    batched = lut.dim() == 5
    if lut.dim() == 4:
        lut, codes = lut[None], codes[None]
    if lut.dim() != 5:
        raise ValueError(f"adc_block_scores: lut {tuple(lut.shape)} is "
                         f"neither [H_kv, g, S, C] nor [B, H_kv, g, S, C]")
    B, H_kv, g, S, C = lut.shape
    T = codes.shape[-1]
    if g > MAX_GROUP or sel_block < 1 or T % sel_block:
        raise ValueError(f"adc_block_scores: unsupported shapes lut "
                         f"{tuple(lut.shape)} codes {tuple(codes.shape)} "
                         f"sel_block {sel_block}")
    if isinstance(n_cand, torch.Tensor) and n_cand.dim() == 1:
        if n_cand.shape != (B,):
            raise ValueError(f"adc_block_scores: n_cand {tuple(n_cand.shape)}"
                             f" for B={B}")
        n_vec = n_cand.to(device=lut.device, dtype=torch.int32).contiguous()
        n_ptr, n_scalar = n_vec.data_ptr(), 0
    else:
        n_ptr, n_scalar = None, int(n_cand)
    out = torch.empty((B, H_kv * g, T // sel_block), dtype=torch.float32,
                      device=lut.device)
    _build.check(_build.lib("adc").pq_adc_block_scores(
        lut.data_ptr(), codes.data_ptr(), n_ptr, n_scalar, B, H_kv, g, S, C,
        T, sel_block, int(head_dim), out.data_ptr(),
        _build.stream_ptr(lut.device)), "adc_block_scores")
    adc_block_scores.launches += 1
    return out if batched else out[0]


adc_block_scores.launches = 0


def block_scores_ctas() -> int:
    """CTAs per (slot, kv head) that K3's last launch chose."""
    return _build.lib("adc").pq_adc_block_scores_ctas()
