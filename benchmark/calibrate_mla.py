"""The readings that a DeepSeek-V2 cell's limits are set from: the
program's on many seeds, and the control's (``calibrate_afmoe.py``'s
method for ``drivers/decode_turns_mla.py``).

    python3 benchmark/calibrate_mla.py --workload <cell> --seeds 1 2 3 [--control N]

Per seed, in one process: the program's set-up and one whole turn at the
cell's own size and load, the program's experts of the sampled slot-turns
as served, its state freed, then the reference over that sample as a run
takes it (the numbers of a run's ``correct``, with ``iters0_excess``, the
fit of a k-means with no Lloyd step, beside them). On the first N seeds
also the control: the reference in the program's place computed in fp8
(``reference/precision.py``), training its own codebooks and selecting its
own experts, teacher-forced on the same prompt and served tokens, judged
as a run judges the program. One JSON line per seed; exits non-zero when
a program reading fails its limit or a control passes them all.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from benchmark import weights_deepseek_v2  # noqa: E402
from benchmark.calibrate_afmoe import _free, _values  # noqa: E402
from benchmark.common import workload  # noqa: E402
from benchmark.drivers import decode_turns as dt  # noqa: E402
from benchmark.drivers import decode_turns_afmoe as da  # noqa: E402
from benchmark.drivers import decode_turns_mla as dm  # noqa: E402
from benchmark.reference.deepseek_v2 import MlaReference  # noqa: E402


def readings(wl: dict, seed: int, dev, control: bool) -> dict:
    graph = dev.type == "cuda"
    t0 = time.perf_counter()
    prog = dm.Program(wl, seed, dev, graph)
    prog.turn(deadline=0.0)
    turns = [prog.turn()]
    peak = torch.cuda.max_memory_allocated(dev) if graph else 0
    picks = dt.sample(turns, wl, seed)
    inputs, out = dt.served(turns, picks)
    routes, unserved = prog.routes(turns, picks)
    ids = prog.ids
    cents = prog.state.centroids.float().clone()
    codes = prog.state.codes.clone()
    prog.free()
    t1 = time.perf_counter()
    w = weights_deepseek_v2.draw(wl["model"], seed, dev)
    ref = MlaReference(wl, w, dev)
    ref.probe_iters = 0
    ref.prefill(ids, cents, codes)
    checks, n = da.judge(wl, ref, codes, inputs, out, routes, unserved)
    res = dict(seed=seed, picks=picks, memory_peak_bytes=peak,
               correct=all(c["ok"] for c in checks), **_values(checks),
               tokens=n, iters0_excess=max(
                   st["fit"]["probe"] / st["fit"]["own"] - 1.0
                   for st in ref.state),
               program_s=t1 - t0, reference_s=time.perf_counter() - t1)
    del ref
    _free(dev)
    if control:
        ctl = MlaReference(wl, w, dev, "fp8")
        ctl.prefill(ids)
        c_routes = []
        _, best = ctl.decode(inputs, [], routes=c_routes)
        c_cents = torch.stack([st["cent"] for st in ctl.state])
        c_codes = torch.stack([st["own_codes"] for st in ctl.state])
        del ctl
        _free(dev)
        ref = MlaReference(wl, w, dev)
        ref.prefill(ids, c_cents, c_codes)
        c_checks, _ = da.judge(wl, ref, c_codes, inputs, best, c_routes)
        res.update(control="fp8",
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
        bad += (not r["correct"]) + bool(r.get("control_correct"))
    print(f"{bad} reading(s) on the wrong side of the limits "
          f"{wl['limits']}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
