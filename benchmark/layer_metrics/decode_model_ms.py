"""decode.model_ms: device ms per replayed decode step in the model bucket
(``benchmark/tracing.classify``): the weight products, the segment
merge, norms, RoPE, the LM head."""


def read(record):
    if not record or "events" not in record:
        return None
    us = sum(d for _, bucket, d in record["events"] if bucket == "model")
    return us / record["steps"] / 1e3
