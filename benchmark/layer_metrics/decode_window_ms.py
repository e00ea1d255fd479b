"""decode.window_ms: device ms per replayed decode step of the kernels
launched under the ``window_attn`` scope (the sliding layers' attention
over their rings and the ring writes, ``models/afmoe.py``), from a record
that keeps each kernel's scopes (``drivers/decode_turns_afmoe.py``)."""


def read(record):
    if not record or "scopes" not in record:
        return None
    us = sum(d for (_, _, d), s in zip(record["events"], record["scopes"])
             if "window_attn" in s.split("/"))
    return us / record["steps"] / 1e3 if us else None
