"""moe_roofline: the bytes the expert kernels need (``afmoe_roofline.
moe_step_bytes`` with the experts the eager step's routing hit) over the
peak bandwidth, over the time of the kernels under the ``moe_experts``
scope in the traced replayed steps, in %."""

from benchmark import afmoe_roofline


def read(record):
    if not record or "scopes" not in record or "hit" not in record:
        return None
    us = sum(d for (_, _, d), s in zip(record["events"], record["scopes"])
             if "moe_experts" in s.split("/"))
    if not us:
        return None
    need = record["steps"] * afmoe_roofline.moe_step_bytes(
        record["model"], record["batch"], record["hit"])
    return 100.0 * (need / afmoe_roofline.PEAK_BYTES) / (us / 1e6)
