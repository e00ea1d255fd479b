"""The traced slice of a run: replayed decode steps split by the port's
scopes, from ``torch.profiler``.

A frozen copy of the reduction of ``pqcache_tpu_torch/harness/trace.py``
(``classify``, the scope path of a launch, the replayed steps joined to an
eager step by launch order), so that the yardstick does not move with the
program. From the program it takes only the spans: the ``scope:`` ranges
that ``runtime/stages.recording()`` switches on.

``trace_decode`` runs, in one chunk of the decoder from a fresh turn: one
eager step, two eager steps profiled with the scopes on (the second names
every kernel of a step and its scope, in launch order), then ``steps`` + 2
replayed steps profiled (the first and the last lead in and out and are
left out), then the chunk's flush. Each replayed kernel takes the eager
kernel's name and scope at its index; the two sequences must agree.
"""

from __future__ import annotations

import collections
import contextlib
import re
import time

import numpy as np
import torch

_PQ_SCOPES = ("pq_score", "pq_select", "pq_append", "pq_kmeans")
_TRANSFER = ("Memcpy", "Memset", "memcpy", "memset", "nccl")
SCOPE_PREFIX = "scope:"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
FENCE, STEP = "bench:fence", "bench:step"


def classify(kernel: str, scope: str) -> str:
    """pq / fetch / transfer / model of a device event by its name and
    its launch's scope path (outermost first, "/"-joined)."""
    if kernel.startswith(_TRANSFER):
        return "transfer"
    parts = scope.split("/")
    if "pq_fetch" in parts:
        return "fetch"
    if any(s in parts for s in _PQ_SCOPES):
        return "pq"
    return "model"


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


def _scope_path(op) -> str:
    names, p = [], op
    while p is not None:
        if p.name.startswith(SCOPE_PREFIX):
            names.append(p.name[len(SCOPE_PREFIX):])
        elif p is op:
            names.append(op.name)
        p = p.cpu_parent
    return "/".join(reversed(names))


def _ancestor(op, name: str):
    while op is not None and op.name != name:
        op = op.cpu_parent
    return op


def _runtime(events) -> dict:
    """Host calls into CUDA by correlation id."""
    return {e.id: e for e in events if not _is_device(e) and not e.is_async
            and _RUNTIME.match(e.name)}


def _device_events(events, runtime) -> list:
    """Kernels, copies and fills in start order, the fence's left out."""
    fenced = {i for i, r in runtime.items()
              if _ancestor(r, FENCE) is not None}
    return sorted((e for e in events if _is_device(e) and e.id not in fenced
                   and not e.name.startswith(("stage:", "scope:", "bench:"))),
                  key=lambda e: (e.time_range.start, e.id))


def _steps(dev, runtime) -> list:
    """The device events of each STEP range, ranges in time order."""
    by = collections.defaultdict(list)
    for e in dev:
        r = runtime.get(e.id)
        st = None if r is None else _ancestor(r, STEP)
        if st is not None:
            by[(st.time_range.start, st.id)].append(e)
    return [by[k] for k in sorted(by)]


def _same_launch(eager: str, replayed: str) -> bool:
    if eager == replayed:
        return True
    low = replayed.lower()
    return ((eager.startswith("Memcpy") and low.startswith("memcpy"))
            or (eager.startswith("Memset") and low.startswith("memset")))


def profiled(run, record: bool):
    """torch.profiler over run(), with the port's scopes on when
    ``record``; a fence kernel, a sync and 5 ms open the trace (CUPTI can
    lose the first kernels of a trace)."""
    from torch.profiler import ProfilerActivity, profile

    from pqcache_tpu_torch.runtime import stages
    marks = stages.recording() if record else contextlib.nullcontext()
    with marks, profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(FENCE):
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            time.sleep(0.005)
        run()
        torch.cuda.synchronize()
    return prof


def _in_steps(fn, n: int):
    def run():
        for _ in range(n):
            with torch.profiler.record_function(STEP):
                fn()
    return run


def _union_us(spans) -> float:
    """Length of the union of [start, end) spans."""
    total, cur0, cur1 = 0.0, None, None
    for a, b in sorted(spans):
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    return total + (0.0 if cur1 is None else cur1 - cur0)


def trace_decode(prog, steps: int) -> dict:
    """The record of a traced slice of ``prog`` (a decode_turns Program):
    every counted device event as (name, bucket, µs), the steps, the ring
    positions of the counted steps, the device's busy and window seconds,
    the longest idle gaps named by the kernel that ends each, and the
    cell's shapes for the roofline. The replayed profile leads in and out
    with one step each (CUPTI can lose a trace's first and last kernels);
    a profile whose counted steps do not all join is taken once more."""
    dec, wl = prog.decoder, prog.wl
    B, P = wl["batch"], wl["prompt_tokens"]
    n = 3 + 2 * (steps + 2)
    if n > dec.chunk:
        raise ValueError(f"{n} traced steps do not fit a chunk of "
                         f"{dec.chunk}")
    prog.reset()
    tok = torch.from_numpy(prog.first_tokens().astype(np.int32)).to(
        prog.dev)
    pos = torch.full((B,), P, dtype=torch.int32, device=prog.dev)
    dec.begin(tok, pos)
    dec.step(eager=True)
    torch.cuda.synchronize()
    eager = profiled(_in_steps(lambda: dec.step(eager=True), 2), True)
    e_evs = eager.events()
    e_rt = _runtime(e_evs)
    e_steps = _steps(_device_events(e_evs, e_rt), e_rt)
    if len(e_steps) != 2:
        raise RuntimeError(f"{len(e_steps)} eager steps in a profile of 2")
    ref = [(e.name, _scope_path(e_rt[e.id].cpu_parent)
            if e_rt[e.id].cpu_parent is not None else "")
           for e in e_steps[1]]
    done = 3
    for attempt in range(2):
        replay = profiled(_in_steps(dec.step, steps + 2), False)
        try:
            rec = _replayed(replay.events(), ref, steps)
            break
        except RuntimeError:
            if attempt:
                raise
        finally:
            done += steps + 2
    dec.finish(done)
    torch.cuda.synchronize()
    first = done - steps - 1     # the ring position of the first counted
    rec.update(steps=steps, ring=list(range(first, first + steps)),
               batch=B, prompt_tokens=P, model=wl["model"])
    return rec


def _replayed(events, ref, steps: int) -> dict:
    """The counted steps of a replayed profile (all but its first and
    last), each kernel joined to the eager step's at its index."""
    rt = _runtime(events)
    dev = _device_events(events, rt)
    r_steps = _steps(dev, rt)
    if len(r_steps) != steps + 2:
        raise RuntimeError(f"{len(r_steps)} replayed steps in a profile of "
                           f"{steps + 2}")
    graph = {i for i, r in rt.items() if "GraphLaunch" in r.name}
    out, spans = [], []
    for s, evs in enumerate(r_steps[1:-1]):
        seq = [e for e in evs if e.id in graph]
        if len(seq) != len(ref):
            raise RuntimeError(f"replayed step {s}: {len(seq)} kernels, the "
                               f"eager step launched {len(ref)}")
        for i, e in enumerate(seq):
            name, scope = ref[i]
            if not _same_launch(name, e.name):
                raise RuntimeError(f"replayed step {s}, kernel {i}: "
                                   f"{e.name[:120]!r}, eager {name[:120]!r}")
            out.append((name, classify(name, scope),
                        float(e.time_range.end - e.time_range.start)))
        for e in evs:
            if e.id not in graph:      # launched by the host around a replay
                out.append((e.name, classify(e.name, ""),
                            float(e.time_range.end - e.time_range.start)))
            spans.append((float(e.time_range.start),
                          float(e.time_range.end)))
    t0 = min(a for a, _ in spans)
    t1 = max(b for _, b in spans)
    at = {float(e.time_range.start): e.name for e in dev}
    gaps = collections.Counter()
    cur = None
    for a, b in sorted(spans):
        if cur is not None and a > cur:
            gaps["before " + _short(at.get(a, "?"))] += a - cur
        cur = b if cur is None else max(cur, b)
    return dict(events=out, busy_s=_union_us(spans) / 1e6,
                window_s=(t1 - t0) / 1e6,
                idle_gaps=[(k, v / 1e6) for k, v in gaps.most_common(10)])


def _short(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = name[5:] if name.startswith("void ") else name
    return name.replace("(anonymous namespace)::", "").split("(")[0][:80]


def breakdown(record: dict) -> dict:
    """The traced slice's ten longest device operations (seconds summed
    over the counted steps) and ten longest idle gaps."""
    by = collections.Counter()
    for name, _, us in record["events"]:
        by[_short(name)] += us / 1e6
    return {"device_ops": [[k, v] for k, v in by.most_common(10)],
            "idle_gaps": [[k, v] for k, v in record["idle_gaps"]]}
