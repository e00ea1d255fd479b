"""Published H100 peaks and the operations and bytes a decode step needs,
from shapes.

The peaks and the bound are those of ``chip_smoke.py`` (``PEAK_BF16``,
``PEAK_BYTES``; a kernel's bound is the larger of operations over the peak
rate and bytes over the peak bandwidth), frozen here: NVIDIA's data sheet
for the H100 SXM part, dense, at its 700 W limit.

Counts are of what the inputs need, each input byte read once and each
output byte written once.
"""

from __future__ import annotations

from benchmark.common import budget, head_dim

PEAK_BF16 = 989e12      # FLOP/s, dense bf16
PEAK_BYTES = 3.35e12    # bytes/s, HBM3


def _products(model: dict) -> list:
    """(in, out) of each weight product of one layer."""
    E, I = model["hidden_size"], model["intermediate_size"]
    H, Hkv, D = (model["num_attention_heads"],
                 model["num_key_value_heads"], head_dim(model))
    return [(E, H * D), (E, Hkv * D), (E, Hkv * D), (H * D, E),
            (E, I), (E, I), (I, E)]


def step_flops(model: dict, batch: int, prompt_tokens: int) -> float:
    """Model FLOPs of one batched decode step: 2 x every multiplied weight
    x the batch, plus attention (q.k and p.v) over the attended rows:
    sink, the selected blocks, the local window and the new token."""
    L, V, E = (model["num_hidden_layers"], model["vocab_size"],
               model["hidden_size"])
    H, D = model["num_attention_heads"], head_dim(model)
    weights = L * sum(i * o for i, o in _products(model)) + E * V
    bd = budget(model, prompt_tokens)
    rows = bd["sink"] + bd["blocks"] * bd["block"] + bd["local"] + 1
    return 2.0 * weights * batch + L * batch * 4.0 * H * D * rows


def k1_bytes(model: dict, batch: int, prompt_tokens: int, ring: int,
             tail_bytes: int) -> float:
    """Bytes one K1 launch (one layer) needs: the selected blocks' rows and
    the tail's part of the local window (local - ring rows), K and V at the
    tail's width, for every folded kv head; the query (f32 with an int8
    tail, else bf16) and the block ids in; (m, l, acc) in f32 out."""
    H, Hkv, D = (model["num_attention_heads"],
                 model["num_key_value_heads"], head_dim(model))
    bd = budget(model, prompt_tokens)
    rows = bd["blocks"] * bd["block"] + bd["local"] - ring
    kv = batch * Hkv * rows * 2 * D * tail_bytes
    q = batch * H * D * (4 if tail_bytes == 1 else 2)
    ids = batch * Hkv * bd["blocks"] * 8
    out = batch * H * (D + 2) * 4
    return float(kv + q + ids + out)


def w8_step_bytes(model: dict, batch: int) -> float:
    """Bytes the W8 launches of one decode step need: int8 weights, their
    bf16 column scales, the bf16 rows in and out of every product (one
    read of x per group of products that share it), and the LM head's f32
    logits."""
    L, V, E = (model["num_hidden_layers"], model["vocab_size"],
               model["hidden_size"])
    prods = _products(model)
    w = sum(i * o + 2 * o for i, o in prods)
    # x read once per group: (q, k, v), wo, (gate, up), down
    x_in = sum(i for i, _ in (prods[0], prods[3], prods[4], prods[6]))
    y_out = sum(o for _, o in prods)
    layer = w + 2 * batch * (x_in + y_out)
    head = E * V + 2 * V + 2 * batch * E + 4 * batch * V
    return float(L * layer + head)
