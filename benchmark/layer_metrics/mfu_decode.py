"""mfu.decode: model FLOPs of the traced replayed steps over their window
times the bf16 peak, in % (``benchmark/roofline.step_flops``)."""

from benchmark import roofline


def read(record):
    if not record or not record.get("window_s"):
        return None
    flops = record["steps"] * roofline.step_flops(
        record["model"], record["batch"], record["prompt_tokens"])
    return 100.0 * flops / (record["window_s"] * roofline.PEAK_BF16)
