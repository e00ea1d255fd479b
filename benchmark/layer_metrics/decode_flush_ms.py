"""decode.flush_ms: the median device ms of a flush span (the chunk's ring
flush: the deferred histogram joins, the ring's encode, tail and code
writes)."""

from benchmark import program_spans as ps


def read(record):
    return ps.median_ms(ps.device_s(r)
                        for r in ps.records(ps.snapshot(), "flush"))
