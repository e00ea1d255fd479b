"""setup.tail_s: device seconds of the prefill_tail spans (each layer's
k-means, codes, state writes and joint histogram), from the totals, which
the ring never drops."""

from benchmark import program_spans as ps


def read(record):
    snap = ps.snapshot()
    tot = (snap or {}).get("totals", {}).get("prefill_tail")
    if not tot or not tot["count"] or not tot["device_s"]:
        return None
    return tot["device_s"]
