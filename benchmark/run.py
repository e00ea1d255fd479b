"""One run of one benchmark cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Reads the cell from ``BENCHMARK.json`` and ``benchmark/workloads/<cell>.json``
(its configuration from ``benchmark/configs/<config>.json``), runs the
cell's driver (``benchmark/drivers/<driver>.py``), and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``, each read by
``benchmark/layer_metrics/<name>.py``), ``device`` and, traced,
``breakdown``; last, ``checks``: each number compared with its limit,
which also end standard error. Exits non-zero, printing no result,
without as many CUDA devices as the cell asks for, or when the JAX package
was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FORBIDDEN = ("jax", "jaxlib", "flax", "pqcache_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's or JAX's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metric entries of ``kind`` ("end_to_end" or "per_layer") that
    this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    mod = name.replace(".", "_").replace("-", "_")
    return importlib.import_module(f"benchmark.layer_metrics.{mod}").read


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import pqcache_tpu_torch  # noqa: F401  (the system under test)
    from benchmark.common import card_info, load_json, workload
    bench = load_json(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    wl = workload(args.workload)
    import torch
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA device(s); {n} available",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    driver = importlib.import_module(f"benchmark.drivers.{wl['driver']}")
    res = driver.run(dict(workload=wl, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=dev, t0=T0))
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    metrics = {}
    if args.trace:
        for m in cell_metrics(bench, args.workload, "per_layer"):
            v = reader(m["name"])(res["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": res["metrics"][m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": all(c["ok"] for c in res["checks"]),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if args.trace:
        from benchmark.tracing import breakdown
        device["busy_s"] = res["record"]["busy_s"]
        device["window_s"] = res["record"]["window_s"]
        out["breakdown"] = breakdown(res["record"])
    print(f"card: {card_info()}; window {res['window_s']} s, "
          f"{res['tokens']} tokens, {res['judged']} judged; end-to-end: "
          f"{json.dumps(res['metrics'])}; ms a step by chunk: "
          f"{res['paces']}", file=sys.stderr)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in res["checks"]}
    for c in res["checks"]:
        print(f"check {c['name']}: {c['value']} (limit {c['limit']}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
