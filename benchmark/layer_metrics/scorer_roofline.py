"""scorer_roofline: the joint-histogram scorer kernel's bound (its bytes
over the peak bandwidth) over its kernel time in the traced replayed steps,
in %. The kernel is matched by name; a program without it (before the
scorer had a kernel) reads nothing."""

from benchmark import roofline

KERNEL = "jhist_mass_kernel"


def scorer_bytes(model: dict, batch: int, prompt_tokens: int) -> float:
    """Bytes the scorer's launches of one decode step need: each layer's
    uint8 joint histogram of every folded kv head, NB blocks of C^2 counts
    (NB: the prompt's candidates rounded up to 256, over select_block; the
    turn's own blocks are left out, so the count can only be low), the f32
    exp-LUT factors (2 C per q head) in and the f32 block mass (NB per q
    head) out."""
    L = model["num_hidden_layers"]
    H, Hkv = model["num_attention_heads"], model["num_key_value_heads"]
    C = 2 ** model["pq"]["n_subbits"]
    n = prompt_tokens - model["budget"]["sink"]
    NB = -(-n // 256) * 256 // model["pq"]["select_block"]
    layer = batch * (Hkv * NB * C * C + H * 2 * C * 4 + H * NB * 4)
    return float(L * layer)


def read(record):
    if not record or "events" not in record:
        return None
    us = sum(d for name, _, d in record["events"] if KERNEL in name)
    if not us:
        return None
    need = record["steps"] * scorer_bytes(record["model"], record["batch"],
                                          record["prompt_tokens"])
    return 100.0 * (need / roofline.PEAK_BYTES) / (us / 1e6)
