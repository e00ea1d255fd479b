"""A DeepSeek-V2 configuration's weights, drawn from the seed on the device,
in the port's layout (``pqcache_tpu_torch/models/deepseek_v2.py``: the
layers grouped by their MLP's kind, each group stacked over its layers,
applied as ``x @ w``; the attention's ``w_uk`` [H, qk_nope, kv_lora_rank]
and ``w_uv`` [H, kv_lora_rank, v_head] are the two halves of DeepSeek's
kv_b_proj).

As ``weights_afmoe.py``: a few large draws of a torch.Generator on the
card, in bf16, each leaf in one call, normal with the configuration's
``init_std``, norms at 1. The same seed gives the same weights on every
call.
"""

from __future__ import annotations

import torch

from benchmark.common import seed_bits

NORMS = ("ln_in", "ln_post")


def draw(cfg: dict, seed: int, device) -> dict:
    E, V, H = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    R, Dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    Dn, Dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    I, X, Ie = (cfg["intermediate_size"], cfg["n_routed_experts"],
                cfg["moe_intermediate_size"])
    Is = Ie * cfg["n_shared_experts"]
    Ld = cfg["first_k_dense_replace"]
    Lm = cfg["num_hidden_layers"] - Ld
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed_bits(seed))
    std = float(cfg["init_std"])

    def normal(*shape):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        return w.mul_(std)

    def group(L, mats):
        g = {k: normal(L, *shape) for k, shape in mats.items()}
        for k in NORMS:
            g[k] = torch.ones((L, E), dtype=torch.bfloat16, device=dev)
        g["kv_norm"] = torch.ones((L, R), dtype=torch.bfloat16, device=dev)
        return g

    attn = dict(wq=(E, H * (Dn + Dr)), w_kv_a=(E, R + Dr), w_uk=(H, Dn, R),
                w_uv=(H, R, Dv), wo=(H * Dv, E))
    params = {
        "embed": normal(V, E),
        "final_norm": torch.ones(E, dtype=torch.bfloat16, device=dev),
        "dense": group(Ld, dict(attn, gate=(E, I), up=(E, I), down=(I, E))),
        "moe": group(Lm, dict(attn, router=(E, X), experts_gate=(X, E, Ie),
                              experts_up=(X, E, Ie), experts_down=(X, Ie, E),
                              shared_gate=(E, Is), shared_up=(E, Is),
                              shared_down=(Is, E))),
    }
    params["lm_head"] = (params["embed"].T.contiguous()
                         if cfg.get("tie_word_embeddings") else normal(E, V))
    return params
