"""decode.mla_ms: device ms per replayed decode step of the kernels
launched under the ``mla_absorb`` scope (the W_uk absorption of the query
and the W_uv product of the output, ``models/deepseek_v2.py``), from a
record that keeps each kernel's scopes (``drivers/decode_turns_mla.py``)."""


def read(record):
    if not record or "scopes" not in record:
        return None
    us = sum(d for (_, _, d), s in zip(record["events"], record["scopes"])
             if "mla_absorb" in s.split("/"))
    return us / record["steps"] / 1e3 if us else None
