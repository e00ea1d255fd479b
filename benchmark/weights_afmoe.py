"""An AFMoE configuration's weights, drawn from the seed on the device, in
the port's layout (``pqcache_tpu_torch/models/afmoe.py``: the layers
grouped by their MLP's kind, each group stacked over its layers, applied
as ``x @ w``).

As ``weights.py``: a few large draws of a torch.Generator on the card, in
bf16, each leaf in one call, normal with the configuration's
``init_std``, norms at 1; the expert bias in f32, normal with the same
std. The same seed gives the same weights on every call.
"""

from __future__ import annotations

import torch

from benchmark.common import head_dim, seed_bits

NORMS = ("ln_in", "ln_post_attn", "ln_pre_mlp", "ln_post_mlp")


def draw(cfg: dict, seed: int, device) -> dict:
    E, V = cfg["hidden_size"], cfg["vocab_size"]
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 head_dim(cfg))
    I, X, Ie = (cfg["intermediate_size"], cfg["num_experts"],
                cfg["moe_intermediate_size"])
    Is = Ie * cfg["num_shared_experts"]
    Ld = cfg["num_dense_layers"]
    Lm = cfg["num_hidden_layers"] - Ld
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed_bits(seed))
    std = float(cfg["init_std"])

    def normal(*shape, dtype=torch.bfloat16):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return w.mul_(std)

    def group(L, mats):
        g = {k: normal(L, *shape) for k, shape in mats.items()}
        for k in NORMS:
            g[k] = torch.ones((L, E), dtype=torch.bfloat16, device=dev)
        for k in ("q_norm", "k_norm"):
            g[k] = torch.ones((L, D), dtype=torch.bfloat16, device=dev)
        return g

    attn = dict(wq=(E, H * D), wk=(E, Hkv * D), wv=(E, Hkv * D),
                wg=(E, H * D), wo=(H * D, E))
    params = {
        "embed": normal(V, E),
        "final_norm": torch.ones(E, dtype=torch.bfloat16, device=dev),
        "dense": group(Ld, dict(attn, gate=(E, I), up=(E, I),
                                down=(I, E))),
        "moe": group(Lm, dict(attn, router=(E, X), experts_gate=(X, E, Ie),
                              experts_up=(X, E, Ie),
                              experts_down=(X, Ie, E), shared_gate=(E, Is),
                              shared_up=(E, Is), shared_down=(Is, E))),
    }
    params["moe"]["expert_bias"] = normal(Lm, X, dtype=torch.float32)
    params["lm_head"] = (params["embed"].T.contiguous()
                         if cfg.get("tie_word_embeddings") else normal(E, V))
    return params
