"""decode.moe_ms: device ms per replayed decode step of the kernels
launched under the ``moe_route`` and ``moe_experts`` scopes (the MoE
layers' router and expert products, ``models/afmoe.py``), from a record
that keeps each kernel's scopes (``drivers/decode_turns_afmoe.py``)."""

SCOPES = ("moe_route", "moe_experts")


def read(record):
    if not record or "scopes" not in record:
        return None
    us = sum(d for (_, _, d), s in zip(record["events"], record["scopes"])
             if any(p in SCOPES for p in s.split("/")))
    return us / record["steps"] / 1e3 if us else None
