"""k1_roofline: K1's bound (``roofline.k1_bytes`` over the peak bandwidth)
over its kernel time in the traced replayed steps, in %."""

from benchmark import roofline

KERNEL = "block_attn_kernel"


def read(record):
    if not record or "events" not in record:
        return None
    us = sum(d for name, _, d in record["events"] if KERNEL in name)
    if not us:
        return None
    m = record["model"]
    tail = 1 if m["precision"]["kv_tail"] == "int8" else 2
    need = sum(roofline.k1_bytes(m, record["batch"], record["prompt_tokens"],
                                 r, tail) for r in record["ring"])
    need *= m["num_hidden_layers"]
    return 100.0 * (need / roofline.PEAK_BYTES) / (us / 1e6)
