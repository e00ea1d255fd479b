"""decode.fetch_ms: device ms per replayed decode step in the fetch bucket
(``benchmark/tracing.classify``): K1 over the selected blocks and
the local window."""


def read(record):
    if not record or "events" not in record:
        return None
    us = sum(d for _, bucket, d in record["events"] if bucket == "fetch")
    return us / record["steps"] / 1e3
