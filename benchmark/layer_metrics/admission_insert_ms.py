"""admission.insert_ms: the median device ms of an insert_slot span (one
slot's prefilled state written into the batched state)."""

from benchmark import program_spans as ps


def read(record):
    return ps.median_ms(ps.device_s(r)
                        for r in ps.records(ps.snapshot(), "insert_slot"))
