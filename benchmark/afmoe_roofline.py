"""The bytes of an AFMoE decode step's expert kernels and the model FLOPs
of the whole step, from shapes (beside ``roofline.py``, whose H100 peaks
they are divided by).

Counts are of what the inputs need, each input byte read once and each
output byte written once, bf16 throughout.
"""

from __future__ import annotations

from benchmark.common import budget, head_dim
from benchmark.roofline import PEAK_BF16, PEAK_BYTES  # noqa: F401


def _moe_layers(model: dict) -> int:
    return model["num_hidden_layers"] - model["num_dense_layers"]


def moe_step_bytes(model: dict, batch: int, hit: list) -> float:
    """Bytes the expert kernels of one batched decode step need: for each
    MoE layer, the three bf16 matrices of every expert its routing hit
    (``hit``: the distinct experts selected over the batch, per MoE layer)
    and of the shared experts, and the routed rows in and out (batch x
    experts per token rows of hidden_size, each way)."""
    E, Ie = model["hidden_size"], model["moe_intermediate_size"]
    Is = Ie * model["num_shared_experts"]
    k = model["num_experts_per_tok"]
    if len(hit) != _moe_layers(model):
        raise ValueError(f"{len(hit)} hit counts for "
                         f"{_moe_layers(model)} MoE layers")
    expert, shared = 3 * E * Ie * 2, 3 * E * Is * 2
    rows = 2 * batch * k * E * 2
    return float(sum(h * expert + shared + rows for h in hit))


def attended_rows(model: dict, prompt_tokens: int) -> list:
    """Keys one decode step attends in each layer: a sliding layer's
    window (or the whole sequence while it is shorter); a full layer's
    sink, selected blocks, local window and the new token."""
    bd = budget(model, prompt_tokens)
    full = bd["sink"] + bd["blocks"] * bd["block"] + bd["local"] + 1
    W = model["sliding_window"]
    return [min(W, prompt_tokens + 1) if t == "sliding_attention" else full
            for t in model["layer_types"]]


def step_flops(model: dict, batch: int, prompt_tokens: int) -> float:
    """Model FLOPs of one batched decode step: 2 x every multiplied weight
    x the batch (per MoE layer the router, the experts each token
    selects and the shared experts; per dense layer its MLP; the
    attention's q, k, v, gate and output products; the head), plus
    attention (q.k and p.v) over each layer's attended rows."""
    E, V = model["hidden_size"], model["vocab_size"]
    H, Hkv, D = (model["num_attention_heads"],
                 model["num_key_value_heads"], head_dim(model))
    I, Ie, X = (model["intermediate_size"], model["moe_intermediate_size"],
                model["num_experts"])
    per_tok = model["num_experts_per_tok"] + model["num_shared_experts"]
    Ld = model["num_dense_layers"]
    attn = 2 * E * H * D + 2 * E * Hkv * D + H * D * E
    weights = E * V
    for i in range(model["num_hidden_layers"]):
        weights += attn + (3 * E * I if i < Ld
                           else E * X + per_tok * 3 * E * Ie)
    rows = sum(attended_rows(model, prompt_tokens))
    return 2.0 * weights * batch + batch * 4.0 * H * D * rows
