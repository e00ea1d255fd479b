"""mfu.decode.moe: model FLOPs of the traced replayed steps of an AFMoE
cell (``afmoe_roofline.step_flops``: the experts each token selects, the
window on sliding layers) over their window times the bf16 peak, in %."""

from benchmark import afmoe_roofline


def read(record):
    if not record or not record.get("window_s") or "hit" not in record:
        return None
    flops = record["steps"] * afmoe_roofline.step_flops(
        record["model"], record["batch"], record["prompt_tokens"])
    return 100.0 * flops / (record["window_s"] * afmoe_roofline.PEAK_BF16)
