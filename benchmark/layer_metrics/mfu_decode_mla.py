"""mfu.decode.mla: model FLOPs of the traced replayed steps of a DeepSeek-V2
cell (``mla_roofline.step_flops``: the absorbed step, the experts each
token selects) over their window times the bf16 peak, in %."""

from benchmark import mla_roofline


def read(record):
    if (not record or not record.get("window_s")
            or "kv_lora_rank" not in record.get("model", {})):
        return None
    flops = record["steps"] * mla_roofline.step_flops(
        record["model"], record["batch"], record["prompt_tokens"])
    return 100.0 * flops / (record["window_s"] * mla_roofline.PEAK_BF16)
