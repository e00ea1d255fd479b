"""A cell at toy widths for the CPU tests (``tiny_cell.json``): every
part of a run but the look for a card and the timing's meaning."""

import json
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def cell(int8: bool = False) -> dict:
    """The tiny cell: bf16 weights and tail, or with ``int8`` weight-only
    int8 and an int8 tail (the NeMo cell's formats)."""
    wl = json.loads((HERE / "tiny_cell.json").read_text())
    wl["name"] = "tiny"
    if int8:
        wl["model"]["precision"] = dict(wl["model"]["precision"],
                                        weights="int8", kv_tail="int8")
    return wl


def run(seed: int, seconds: float = 2.0, int8: bool = False) -> dict:
    """One run of the tiny cell through the decode_turns driver, eager on
    the CPU."""
    from benchmark.drivers import decode_turns
    return decode_turns.run(dict(workload=cell(int8), seed=seed,
                                 seconds=seconds,
                                 trace=False, device=torch.device("cpu"),
                                 t0=time.perf_counter()))


def checks(res: dict) -> dict:
    return {c["name"]: c for c in res["checks"]}
