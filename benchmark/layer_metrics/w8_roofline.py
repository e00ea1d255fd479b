"""w8_roofline: the W8 kernel's bound (``roofline.w8_step_bytes`` over the
peak bandwidth) over its kernel time in the traced replayed steps, in %.
Nothing to read where the weights are not int8."""

from benchmark import roofline

KERNEL = "w8_kernel"


def read(record):
    if not record or "events" not in record:
        return None
    us = sum(d for name, _, d in record["events"] if KERNEL in name)
    if not us:
        return None
    need = record["steps"] * roofline.w8_step_bytes(record["model"],
                                                    record["batch"])
    return 100.0 * (need / roofline.PEAK_BYTES) / (us / 1e6)
