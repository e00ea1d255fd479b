"""The readings that a cell's limits are set from: the program's on many
seeds, and the control's.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 [--control N]

Per seed, in one process: the program's set-up and one whole turn at the
cell's own size and load, its state freed, then the reference over a
sample of the turn's slots as a run takes it: the numbers of a run's
``correct`` (``decode_turns.judge``, with the cell's limits), and the fit
of a k-means with no Lloyd step (``iters0_excess``). On the first N seeds
(``--control N``) also the control: the reference in the program's place,
computed in the next format below the configuration's (fp8 below bf16,
int4 below int8; ``reference/precision.py``), training its own codebooks,
teacher-forced on the same prompt and served tokens, judged as a run
judges the program: the gap of the token it puts first at each step, its
codes and its codebooks.
One JSON line per seed; exits non-zero when a program reading fails its
limit or a control passes them all.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from benchmark import weights as bench_weights  # noqa: E402
from benchmark.common import workload  # noqa: E402
from benchmark.drivers import decode_turns as dt  # noqa: E402
from benchmark.reference.pqcache import Reference  # noqa: E402


def control_mode(wl: dict) -> str:
    return "int4" if wl["model"]["precision"]["weights"] == "int8" else "fp8"


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _values(checks: list) -> dict:
    return {c["name"]: c["value"] for c in checks}


def readings(wl: dict, seed: int, dev, control: bool) -> dict:
    graph = dev.type == "cuda"
    t0 = time.perf_counter()
    prog = dt.Program(wl, seed, dev, graph)
    prog.turn(deadline=0.0)
    turns = [prog.turn()]
    peak = torch.cuda.max_memory_allocated(dev) if graph else 0
    ids = prog.ids
    cents = prog.state.centroids.float().clone()
    codes = prog.state.codes.clone()
    prog.free()
    t1 = time.perf_counter()
    picks = dt.sample(turns, wl, seed)
    inputs, out = dt.served(turns, picks)
    w = bench_weights.draw(wl["model"], seed, dev)
    ref = Reference(wl, w, dev)
    # a k-means cut short (no Lloyd step), as a program fault would leave
    # it: its fit beside the program's
    ref.probe_iters = 0
    ref.prefill(ids, cents, codes)
    checks, n = dt.judge(wl, ref, codes, inputs, out)
    res = dict(seed=seed, picks=picks, memory_peak_bytes=peak,
               correct=all(c["ok"] for c in checks), **_values(checks),
               tokens=n, iters0_excess=max(
                   st["fit"]["probe"] / st["fit"]["own"] - 1.0
                   for st in ref.state),
               program_s=t1 - t0, reference_s=time.perf_counter() - t1)
    del ref
    _free(dev)
    if control:
        mode = control_mode(wl)
        ctl = Reference(wl, w, dev, mode)
        ctl.prefill(ids)
        _, best = ctl.decode(inputs, [])
        c_cents = torch.stack([st["cent"] for st in ctl.state]).reshape(
            ctl.L, ctl.Hkv, ctl.S, ctl.C, -1)
        c_codes = torch.stack([st["own_codes"] for st in ctl.state])
        del ctl
        _free(dev)
        ref = Reference(wl, w, dev)
        ref.prefill(ids, c_cents, c_codes)
        c_checks, _ = dt.judge(wl, ref, c_codes, inputs, best)
        res.update(control=mode,
                   control_correct=all(c["ok"] for c in c_checks),
                   **{f"control_{k}": v
                      for k, v in _values(c_checks).items()},
                   control_agree=float((best == out).mean()))
        del ref
    del w
    _free(dev)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="read the control on the first N seeds too")
    args = ap.parse_args(argv)
    wl = workload(args.workload)
    dev = torch.device("cuda")
    bad = 0
    for i, s in enumerate(args.seeds):
        r = readings(wl, s, dev, i < args.control)
        print(json.dumps(r), flush=True)
        # a sound run has to come out correct, and a control not
        bad += (not r["correct"]) + bool(r.get("control_correct"))
    print(f"{bad} reading(s) on the wrong side of the limits "
          f"{wl['limits']}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
