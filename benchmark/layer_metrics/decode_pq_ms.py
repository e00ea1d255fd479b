"""decode.pq_ms: device ms per replayed decode step in the pq bucket
(``benchmark/tracing.classify``): the ADC table, the block scorer
and the top-k."""


def read(record):
    if not record or "events" not in record:
        return None
    us = sum(d for _, bucket, d in record["events"] if bucket == "pq")
    return us / record["steps"] / 1e3
