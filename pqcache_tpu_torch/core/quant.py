"""Int8 quantization: the KV tail's per-channel codes and weight-only int8.

Counterpart of ``pqcache_tpu/core/quant.py``. KV scales are per (layer,
head, channel), computed once from the prefill keys/values (absmax/127 over
the valid tokens) and frozen; generated tokens quantize with the same scales
and clip. The K scale folds into the query and the V scale out of the
attention partials, so the block-retrieval kernel reads int8 rows with no
scale arithmetic.

Weight-only int8 (W8A16): per-output-column scales, so that
x @ (W8 * s) = (x @ W8) * s and the scale applies to the small output
(``models/llama.py::_mm``, ``ops/w8.py``). Codes and scales are those of the
JAX package bit for bit (float32 arithmetic, rounding half to even).
"""

from __future__ import annotations

import torch


def kv_channel_scales(k: torch.Tensor, v: torch.Tensor, valid_len):
    """Per-channel absmax/127 scales over the first ``valid_len`` tokens.

    k, v: [H_kv, T, D]. Returns (k_scale, v_scale) each [H_kv, 1, D] f32,
    floored at 1e-8 so all-zero channels stay finite."""
    T = k.shape[1]
    valid = (torch.arange(T, device=k.device) < valid_len)[None, :, None]

    def amax(x):
        return torch.where(valid, x.float().abs(), 0.0).amax(1, keepdim=True)

    return (torch.clamp(amax(k) / 127.0, min=1e-8),
            torch.clamp(amax(v) / 127.0, min=1e-8))


def quantize_channels(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-channel int8: x [..., T, D], scale [..., 1, D] f32."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def quantize_kv(k, v, k_scale, v_scale) -> torch.Tensor:
    """K/V rows [..., T, D] -> one interleaved int8 row buffer [..., T, 2D]
    (K in [:D], V in [D:] — the tail layout)."""
    return torch.cat([quantize_channels(k, k_scale),
                      quantize_channels(v, v_scale)], dim=-1)


def dequant_kv(kv: torch.Tensor, k_scale, v_scale, dtype=torch.bfloat16):
    """Split and dequantize interleaved int8 rows [..., T, 2D] -> (k, v)."""
    D = kv.shape[-1] // 2
    k = kv[..., :D].float() * k_scale
    v = kv[..., D:].float() * v_scale
    return k.to(dtype), v.to(dtype)


# weight matrices of a layer that quantize_weight_tree turns into int8
W_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def quantize_weight_mat(w: torch.Tensor):
    """[..., in, out] float -> (int8 weights, per-out-column scales
    [..., 1, out] in w's dtype): absmax/127 over ``in``, floored at 1e-12.
    A stacked [L, in, out] matrix is quantized one layer at a time, so the
    float32 transient never exceeds one layer's matrix."""
    if w.dim() > 2:
        qs = [quantize_weight_mat(x) for x in w]
        return torch.stack([q for q, _ in qs]), torch.stack([s for _, s in qs])
    wf = w.float()
    s = torch.clamp(wf.abs().amax(-2, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s.to(w.dtype)


def quantize_weight_tree(params: dict, *, embed: bool = True) -> dict:
    """A new params dict with the layer matrices (W_KEYS) and the LM head
    in int8 beside '<name>_s' scale siblings, and with ``embed`` the
    embedding in int8 with per-ROW scales ('embed_s' [V, 1]). The model
    (``models/llama.py`` ``_mm``, ``embed_lookup``, ``lm_head_logits``)
    takes either layout."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in W_KEYS:
        layers[k], layers[k + "_s"] = quantize_weight_mat(layers[k])
    out["layers"] = layers
    out["lm_head"], out["lm_head_s"] = quantize_weight_mat(params["lm_head"])
    if embed:
        e = params["embed"]
        q, s = quantize_weight_mat(e.T)              # per row of [V, E]
        out["embed"], out["embed_s"] = q.T.contiguous(), s.T.contiguous()
    return out
