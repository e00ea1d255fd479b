"""The model's weights, drawn from the seed on the device, in the port's
layout (weights stacked over layers, applied as ``x @ w``).

A few large draws of a torch.Generator on the card, in bf16, each leaf in
one call: normal with the configuration's ``init_std``, norms at 1. The
same seed gives the same weights on every call, so the reference draws
them again after the program's state is freed.
"""

from __future__ import annotations

import torch

from benchmark.common import model_shape, seed_bits


def draw(cfg: dict, seed: int, device) -> dict:
    s = model_shape(cfg)
    E, H, Hkv, D, I, L, V = (s["E"], s["H"], s["Hkv"], s["D"], s["I"],
                             s["L"], s["V"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed_bits(seed))
    std = float(cfg["init_std"])

    def normal(*shape):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        return w.mul_(std)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    params = {
        "embed": normal(V, E),
        "final_norm": ones(E),
        "layers": {
            "ln1": ones(L, E), "ln2": ones(L, E),
            "wq": normal(L, E, H * D), "wk": normal(L, E, Hkv * D),
            "wv": normal(L, E, Hkv * D), "wo": normal(L, H * D, E),
            "gate": normal(L, E, I), "up": normal(L, E, I),
            "down": normal(L, I, E),
        },
    }
    params["lm_head"] = (params["embed"].T.contiguous()
                         if cfg.get("tie_word_embeddings") else normal(E, V))
    return params
