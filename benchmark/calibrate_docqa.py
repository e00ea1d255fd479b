"""The readings that the document-QA cell's limits are set from: the
program's on many seeds, and the control's (``calibrate.py``'s method for
``drivers/docqa_prefix.py``).

    python3 benchmark/calibrate_docqa.py --workload <cell> --seeds 1 2 3 [--control N] [--seconds S]

Per seed, in one process: the program's set-up, a window of ``--seconds``
at the cell's rate and its judged requests' codebooks and codes as they
were admitted, the program freed, then per judged request the reference
as a run takes it (``docqa_prefix.judge``'s numbers, the worst request's,
with ``iters0_excess``, the fit of a k-means with no Lloyd step, beside
them). On the first N seeds also the control: the reference in the
program's place in the next format below the configuration's
(``calibrate.control_mode``), prefilling the document and the question
with its own codebooks, teacher-forced on the served answer, judged as a
run judges the program: the gap of the token it puts first at each step,
its codes and codebooks. One JSON line per seed; exits non-zero when a
program reading fails its limit or a control passes them all.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import weights as bench_weights  # noqa: E402
from benchmark.calibrate import _free, _values, control_mode  # noqa: E402
from benchmark.common import rng, workload  # noqa: E402
from benchmark.drivers import decode_turns as dt  # noqa: E402
from benchmark.drivers import docqa_prefix as dq  # noqa: E402
from benchmark.reference.pqcache import Reference  # noqa: E402


def worst(rows: list) -> dict:
    """Each number's largest value over the judged requests."""
    return {k: max(r[k] for r in rows) for k in rows[0]}


def readings(wl: dict, seed: int, dev, control: bool,
             seconds: float) -> dict:
    t0 = time.perf_counter()
    prog = dq.Program(wl, seed, dev)
    V = wl["model"]["vocab_size"]
    prog.serve([(-1 - i, rng(seed, 5).integers(0, V, wl["question_max"]
                                                - i)) for i in range(2)], {})
    reqs, arrivals = dq.requests(wl, seed, seconds)
    first = min(wl["judge_from"], len(reqs))
    picks = rng(seed, 3).choice(first, min(wl["judged"], first),
                                replace=False).tolist()
    out, _ = prog.serve(reqs, arrivals, picks)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prog.free()
    t1 = time.perf_counter()
    sw = dq.shape(wl)
    w = bench_weights.draw(wl["model"], seed, dev)
    mine, ctl_rows, iters0 = [], [], []
    for sid in sorted(prog.kept):
        cents, codes = prog.kept[sid]
        ans = np.asarray(out[sid], np.int64)
        inputs, served = ans[None, :-1], ans[None, 1:]
        ids = np.concatenate([prog.doc, reqs[sid][1]])
        ref = Reference(sw, w, dev)
        ref.probe_iters = 0
        ref.prefill(ids, cents, codes)
        checks, _ = dt.judge(sw, ref, codes, inputs, served)
        mine.append(_values(checks))
        iters0.append(max(st["fit"]["probe"] / st["fit"]["own"] - 1.0
                          for st in ref.state))
        del ref
        _free(dev)
        if control:
            ctl = Reference(sw, w, dev, control_mode(wl))
            ctl.prefill(ids)
            _, best = ctl.decode(inputs, [])
            c_cents = torch.stack([st["cent"] for st in ctl.state]).reshape(
                ctl.L, ctl.Hkv, ctl.S, ctl.C, -1)
            c_codes = torch.stack([st["own_codes"] for st in ctl.state])
            del ctl
            _free(dev)
            ref = Reference(sw, w, dev)
            ref.prefill(ids, c_cents, c_codes)
            c_checks, _ = dt.judge(sw, ref, c_codes, inputs, best)
            ctl_rows.append(_values(c_checks))
            del ref
            _free(dev)
    lim = wl["limits"]
    res = dict(seed=seed, requests=len(reqs), judged=sorted(prog.kept),
               memory_peak_bytes=peak, **worst(mine),
               iters0_excess=max(iters0), program_s=t1 - t0,
               reference_s=time.perf_counter() - t1)
    res["correct"] = all(res[k] <= lim[k] for k in lim)
    if ctl_rows:
        c = worst(ctl_rows)
        res.update(control=control_mode(wl),
                   control_correct=all(c[k] <= lim[k] for k in lim),
                   **{f"control_{k}": v for k, v in c.items()})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="read the control on the first N seeds too")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    wl = workload(args.workload)
    dev = torch.device("cuda")
    bad = 0
    for i, s in enumerate(args.seeds):
        r = readings(wl, s, dev, i < args.control, args.seconds)
        print(json.dumps(r), flush=True)
        bad += (not r["correct"]) + bool(r.get("control_correct"))
    print(f"{bad} reading(s) on the wrong side of the limits "
          f"{wl['limits']}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
