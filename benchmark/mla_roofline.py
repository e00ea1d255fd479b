"""The bytes of K1's latent variant and the model FLOPs of a whole
DeepSeek-V2 decode step (absorbed MLA), from shapes (beside
``roofline.py``, whose H100 peaks they are divided by).

Counts are of what the inputs need, each input byte read once and each
output byte written once, bf16 rows and queries, f32 partials.
"""

from __future__ import annotations

from benchmark.common import budget
from benchmark.roofline import PEAK_BF16, PEAK_BYTES  # noqa: F401


def latent_row(model: dict) -> int:
    """Width of a cached latent row: kv_lora_rank + qk_rope_head_dim."""
    return model["kv_lora_rank"] + model["qk_rope_head_dim"]


def k1_latent_bytes(model: dict, batch: int, prompt_tokens: int,
                    ring: int) -> float:
    """Bytes one latent K1 call (one layer) needs: the selected blocks'
    rows and the tail's part of the local window (local - ring rows), each
    a bf16 latent row, for every slot; the absorbed queries (bf16, H per
    slot) and the block ids in; (m, l, acc over kv_lora_rank) in f32
    out."""
    H, D, R = model["num_attention_heads"], latent_row(model), \
        model["kv_lora_rank"]
    bd = budget(model, prompt_tokens)
    rows = bd["blocks"] * bd["block"] + bd["local"] - ring
    return float(batch * rows * D * 2 + batch * H * D * 2
                 + batch * bd["blocks"] * 8 + batch * H * (R + 2) * 4)


def attended_rows(model: dict, prompt_tokens: int) -> int:
    """Latent rows one decode step attends in each layer: the sink, the
    selected blocks, the local window and the new token."""
    bd = budget(model, prompt_tokens)
    return bd["sink"] + bd["blocks"] * bd["block"] + bd["local"] + 1


def step_flops(model: dict, batch: int, prompt_tokens: int) -> float:
    """Model FLOPs of one batched decode step in the absorbed form: 2 x
    every multiplied weight x the batch (per layer W_q, W_kv_a, W_o, the
    W_uk absorption of the query and the W_uv product of the output; the
    dense layer's MLP; per MoE layer the router, the experts each token
    selects and the shared experts; the head), plus attention per head
    over the attended latent rows: q . row over kv_lora_rank +
    qk_rope_head_dim columns and p . row over kv_lora_rank."""
    E, V, H = (model["hidden_size"], model["vocab_size"],
               model["num_attention_heads"])
    R, D = model["kv_lora_rank"], latent_row(model)
    Dn, Dv = model["qk_nope_head_dim"], model["v_head_dim"]
    Dq = Dn + model["qk_rope_head_dim"]
    I, Ie, X = (model["intermediate_size"], model["moe_intermediate_size"],
                model["n_routed_experts"])
    per_tok = model["num_experts_per_tok"] + model["n_shared_experts"]
    Ld = model["first_k_dense_replace"]
    attn = E * H * Dq + E * D + H * Dv * E + H * Dn * R + H * R * Dv
    weights = E * V
    for i in range(model["num_hidden_layers"]):
        weights += attn + (3 * E * I if i < Ld
                           else E * X + per_tok * 3 * E * Ie)
    rows = attended_rows(model, prompt_tokens) * model["num_hidden_layers"]
    return 2.0 * weights * batch + batch * 2.0 * H * (D + R) * rows
