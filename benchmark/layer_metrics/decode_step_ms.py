"""decode.step_ms: the median, over the replay spans that captured no graph,
of device ms over the span's steps."""

from benchmark import program_spans as ps


def read(record):
    return ps.median_ms(ps.device_s(r) / r["ids"]["steps"]
                        for r in ps.records(ps.snapshot(), "replay")
                        if not r["ids"].get("captured"))
