"""Decode-step decomposition into pq / fetch / transfer / model from a
torch.profiler trace.

Counterpart of ``pqcache_tpu/harness/trace.py``. The reference's global
timer (global_timer.py:33-54) brackets every PQ compute region and transfer
with paired CUDA events and reports pq / non-pq / transfer milliseconds per
decode step. Here the same split comes from one profiled run:

  1. The retrieval functions run inside ``runtime/stages.scope`` ranges
     (``core/pq.py``, ``ops/adc.py``, ``ops/gather.py``,
     ``ops/block_attn.py``): pq_score / pq_select / pq_fetch / pq_append /
     pq_kmeans, the JAX package's ``jax.named_scope`` names at the same
     functions. The ranges exist only under ``stages.recording()``.
  2. Each device event (a kernel, a copy, a fill) is joined to the host
     call that launched it through the profiler's correlation id, and the
     ``cpu_parent`` chain of that call gives its scope path
     (``scope_map``). On the CPU there are no kernels: the ``aten::`` ops
     stand in, each with its self CPU time (nested ops count once), as the
     JAX package's CPU backend stands its HLO ops in.
  3. Summing the events' durations by bucket gives ms per step
     (``decompose_events``).

A step replayed from a CUDA graph (``runtime/decode_graph.BatchedDecoder``,
the counterpart of the one program JAX compiles) runs no host code, so its
kernels have no launch to join: ``decompose_replayed`` profiles one eager
step of the same decoder for the kernels' names and scopes in launch order
and gives the i-th kernel of every replayed step the i-th eager kernel's
scope, and raises where the two sequences differ.

Buckets (the reference's, get_decode_time_parts, global_timer.py:33-54):
  pq        ADC LUT / scores / joint histogram, top-k selection, encode
            and append, k-means
  fetch     the selected rows' fetch: K1's block attention, the row gather
            K6 (the reference's "transfer": the PCIe fetch's analog)
  transfer  copies, fills and collectives, whatever their scope
  model     everything else: the weights, the segment merge, the LM head

Usage:  python -m pqcache_tpu_torch.harness.trace [policy ...] [--device cpu]
Env: CTX (4096), LAYERS (2), STEPS (8), BLOCK (1), TRACE_DIR (each
policy's Chrome trace under <TRACE_DIR>/<policy>-block<BLOCK>). One JSON line
per policy with the JAX CLI's keys plus ``device`` and ``gpu_name_power``
(``nvidia-smi --query-gpu=name,power.limit``). Library use:
``decompose(fn, steps=N)`` for any callable that runs N decode steps,
``decompose_replayed(decoder, tokens, pos, steps=N)`` for a decoder.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import (Any, Callable, Dict, Hashable, Iterable, List, Optional,
                    Sequence, Tuple)

import torch

from pqcache_tpu_torch.runtime import stages

BUCKETS = ("pq", "fetch", "transfer", "model")
_PQ_SCOPES = ("pq_score", "pq_select", "pq_append", "pq_kmeans")
# data movement whatever its scope: copies and fills on the card (a graph
# runs its copy nodes as kernels of their own: memcpy32_post ...), NCCL's
# kernels, and the collectives' host ops where the CPU stands in (gloo)
_TRANSFER = ("Memcpy", "Memset", "memcpy", "memset", "nccl", "c10d::",
             "gloo", "record_param_comms")
# the host calls into CUDA (cuda*, cu*) that put work on the card
# (cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, cudaGraphLaunch, ...)
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
# host ranges of the tracer's own: the fence kernel that opens each trace
# (``profiled``) and each step of ``decompose_replayed``'s eager profile
FENCE = "trace:fence"
STEP = "trace:step"


def classify(kernel_name: str, scope: str) -> str:
    """The bucket of a device event by its name and its launch's scope
    path ("pq_select/pq_select/aten::sort": scopes outermost first, then
    the launching op)."""
    if kernel_name.startswith(_TRANSFER):
        return "transfer"
    parts = scope.split("/")
    if "pq_fetch" in parts:
        return "fetch"
    if any(s in parts for s in _PQ_SCOPES):
        return "pq"
    return "model"


def is_mark(name: str) -> bool:
    """A stage or scope range (runtime/stages.py) or one of the tracer's
    own (FENCE, STEP), host or device side."""
    return name.startswith((stages.PREFIX, stages.SCOPE_PREFIX, "trace:"))


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


def _dur(e) -> float:
    """An event's duration in µs."""
    return float(e.time_range.end - e.time_range.start)


def _scope_path(op) -> str:
    """The scope names around a host op (itself included, where the op is
    a scope's range), outermost first, then its name."""
    names, p = [], op
    while p is not None:
        if p.name.startswith(stages.SCOPE_PREFIX):
            names.append(p.name[len(stages.SCOPE_PREFIX):])
        elif p is op:
            names.append(op.name)
        p = p.cpu_parent
    return "/".join(reversed(names))


def _launcher_path(r) -> str:
    """The scope path of a runtime call (cudaLaunchKernel ...), named by
    the op that made it."""
    return _scope_path(r.cpu_parent) if r.cpu_parent is not None else r.name


def _ancestor(op, name: str):
    """The range named ``name`` that holds a host op (itself included), or
    None."""
    while op is not None and op.name != name:
        op = op.cpu_parent
    return op


def _fenced(runtime: Dict[int, Any]) -> set:
    """The correlation ids of the fence's launches."""
    return {i for i, r in runtime.items() if _ancestor(r, FENCE) is not None}


def _runtime_calls(events) -> Dict[int, Any]:
    """The host calls into CUDA (cuda*, cu*), by correlation id."""
    return {e.id: e for e in events if not _is_device(e) and not e.is_async
            and _RUNTIME.match(e.name)}


def _launches(events):
    """(the device events as (key, name, µs) in start order, {key: scope
    path of the runtime call that launched it, joined by correlation id},
    the events by key). Device events are kernels, copies and fills (the
    marks' own device ranges and the fence's launch left out); with none,
    the ``aten::`` ops stand in with their self CPU time and their own
    scope paths."""
    runtime = _runtime_calls(events)
    fenced = _fenced(runtime)
    dev = sorted((e for e in events if _is_device(e) and not is_mark(e.name)
                  and e.id not in fenced),
                 key=lambda e: (e.time_range.start, e.id))
    if not dev:
        ops = sorted((e for e in events if e.name.startswith("aten::")),
                     key=lambda e: e.time_range.start)
        return ([(i, e.name, float(e.self_cpu_time_total))
                 for i, e in enumerate(ops)],
                {i: _scope_path(e) for i, e in enumerate(ops)}, ops)
    smap = {i: _launcher_path(runtime[e.id]) for i, e in enumerate(dev)
            if e.id in runtime}
    return [(i, e.name, _dur(e)) for i, e in enumerate(dev)], smap, dev


def scope_map(events) -> Dict[int, str]:
    """Counterpart of ``hlo_scope_map``: the key of each device event of a
    profile (its index in start order) -> the scope path of its launching
    host op. A device event with no host launch to join is left out
    (unmapped)."""
    return _launches(events)[1]


def decompose_events(events: Iterable[Tuple[Hashable, str, float]],
                     scope_map: Dict[Hashable, str],
                     steps: int) -> Dict[str, Any]:
    """Aggregate (key, name, duration µs) device events into per-step
    bucket milliseconds (the JAX package's ``decompose_ops``): pq_ms,
    fetch_ms, transfer_ms, model_ms, total_ms, non_pq_ms (= model_ms, the
    reference's report) and unmapped_ms (events with no host launch; they
    are classified by name with an empty scope)."""
    buckets = collections.Counter()
    unmapped_us = 0.0
    for key, name, dur in events:
        scope = scope_map.get(key)
        if scope is None:
            unmapped_us += dur
        buckets[classify(name, scope or "")] += dur
    r = {f"{k}_ms": buckets[k] / steps / 1e3 for k in BUCKETS}
    r["total_ms"] = sum(buckets.values()) / steps / 1e3
    r["non_pq_ms"] = r["model_ms"]
    r["unmapped_ms"] = unmapped_us / steps / 1e3
    return r


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profiled(run: Callable[[], Any], *, record: bool = True):
    """torch.profiler (host, and the card where there is one) over run()
    and a device synchronization; with ``record`` the stage and scope
    marks are on. On the card a fence kernel, a synchronization and a
    pause of 5 ms open the trace: CUPTI can lose the kernels that finish
    in the first moments of a trace, and the fence (left out of every
    count) takes that place. Returns the profile."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    marks = stages.recording() if record else contextlib.nullcontext()
    with marks, profile(activities=acts) as prof:
        if cuda:
            with torch.profiler.record_function(FENCE):
                torch.zeros(1, device="cuda")
                torch.cuda.synchronize()
                time.sleep(0.005)
        run()
        _sync()
    return prof


def summarize(events, steps: int, skip=frozenset()) -> Dict[str, Any]:
    """The launches and device time of a profile of ``steps`` decode steps:
    device kernels per step (copies, fills and the marks' device ranges
    left out) and their device ms per step, copies and fills per step and
    their ms, the kernels that take the most time, host launches per step
    (kernel and graph launches) attributed to the stage ranges that hold
    them (``runtime/stages.py``), and device ms per step attributed to the
    stage ranges' device spans that hold each kernel's start (marked steps
    only: an eager run under ``recording()``). Launches with a correlation
    id in ``skip`` (and the fence's) are left out."""
    skip = _fenced(_runtime_calls(events)) | set(skip)
    dev = [e for e in events if _is_device(e) and not is_mark(e.name)
           and e.id not in skip]
    kern = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    by_name = collections.Counter(e.name for e in kern)
    ranges = sorted((e.time_range.start, e.time_range.end,
                     e.name[len(stages.PREFIX):]) for e in events
                    if not _is_device(e) and e.name.startswith(stages.PREFIX))
    starts = [r[0] for r in ranges]
    by_stage, graph_launches = collections.Counter(), 0
    for e in events:
        if _is_device(e):
            continue
        if e.id in skip:
            continue
        if "GraphLaunch" in e.name:
            graph_launches += 1
        if "LaunchKernel" not in e.name:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        by_stage[ranges[i][2] if i >= 0 and e.time_range.start < ranges[i][1]
                 else "other"] += 1
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len(stages.PREFIX):]) for e in events
                   if _is_device(e) and e.name.startswith(stages.PREFIX))
    span_starts = [r[0] for r in spans]
    dev_stage = collections.Counter()
    for e in kern:
        i = bisect.bisect_right(span_starts, e.time_range.start) - 1
        dev_stage[spans[i][2] if i >= 0 and e.time_range.start < spans[i][1]
                  else "other"] += _dur(e)
    top = collections.Counter()
    for e in kern:
        top[e.name] += _dur(e)
    return dict(
        kernels=len(kern) / steps,
        dev_ms=sum(_dur(e) for e in kern) / 1e3 / steps,
        copies=len(copies) / steps,
        copy_ms=sum(_dur(e) for e in copies) / 1e3 / steps,
        top="; ".join(f"{k[:56]} {v / 1e3 / steps:.3f}"
                      for k, v in top.most_common(8)),
        host_launches=sum(by_stage.values()) / steps,
        graph_launches=graph_launches / steps,
        by_stage={k: v / steps for k, v in sorted(by_stage.items())},
        dev_stage={k: v / 1e3 / steps for k, v in sorted(dev_stage.items())},
        by_name=dict(by_name))


def _export(prof, trace_dir: Optional[str], name: str) -> str:
    tdir = trace_dir or tempfile.mkdtemp(prefix="pqtrace_")
    os.makedirs(tdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(tdir, name))
    return tdir


def decompose(fn: Callable[[], Any], *, steps: int,
              trace_dir: Optional[str] = None) -> Dict[str, Any]:
    """Run ``fn`` once warm, profile one more run under ``recording()``
    (the device synchronized at its end), write the Chrome trace to
    ``trace_dir`` (a new temporary directory when None) and return the
    per-step pq / fetch / transfer / model split (the JAX package's
    ``decompose_jitted``). ``steps``: the decode steps one run of ``fn``
    covers. Adds ``trace_dir``, ``kernels`` (device events per step) and
    ``summary`` (``summarize`` of the profile)."""
    fn()
    _sync()
    prof = profiled(fn)
    evs = prof.events()
    ops, smap, _ = _launches(evs)
    res = decompose_events(ops, smap, steps)
    res["kernels"] = len(ops) / steps
    res["trace_dir"] = _export(prof, trace_dir, "decode.json")
    res["summary"] = summarize(evs, steps)
    return res


def same_launch(eager: str, replayed: str) -> bool:
    """Whether a replayed device event is the eager step's at its index:
    the same kernel, or a copy or fill, which a graph runs as a kernel of
    its own (an eager "Memcpy DtoD" replays as "memcpy32_post")."""
    if eager == replayed:
        return True
    low = replayed.lower()
    return ((eager.startswith("Memcpy") and low.startswith("memcpy"))
            or (eager.startswith("Memset") and low.startswith("memset")))


def _parting(eager, seq) -> str:
    """What one replayed step launched that the eager step did not, and
    the reverse (by name), for an error message."""
    def key(name):
        low = name.lower()
        return ("copy" if low.startswith("memcpy") else
                "fill" if low.startswith("memset") else name[:80])
    got = collections.Counter(key(n) for n, _ in seq)
    want = collections.Counter(key(n) for n, _ in eager)
    return (f"; the step's extra launches {dict(got - want)}, missing "
            f"{dict(want - got)}")


def join_replayed(eager: Sequence[Tuple[str, Optional[str]]],
                  replayed: Sequence[Sequence[Tuple[str, float]]]
                  ) -> List[Tuple[str, Optional[str], float]]:
    """Scopes for the device events of replayed steps by launch order:
    eager [(name, scope or None)] of one eager step, replayed, per step,
    [(name, duration)]. The i-th event of each replayed step takes the
    i-th eager event's name and scope (``same_launch``). Raises ValueError,
    naming the step and the first index where the two part or one ends,
    unless every replayed step is the eager step. Returns [(name, scope,
    duration)]."""
    n, out = len(eager), []
    for s, seq in enumerate(replayed):
        for i, (name, dur) in enumerate(seq):
            if i >= n or not same_launch(eager[i][0], name):
                want = (repr(eager[i][0][:200]) if i < n
                        else f"nothing there ({n} events)")
                raise ValueError(
                    f"replayed step {s}, device event {i}: {name[:200]!r}; "
                    f"the eager step launched {want}" + _parting(eager, seq))
            out.append((eager[i][0], eager[i][1], dur))
        if len(seq) != n:
            raise ValueError(
                f"replayed step {s} ends at device event {len(seq)}; the "
                f"eager step launched {n}" + _parting(eager, seq))
    return out


def _in_steps(run_step: Callable[[], Any], n: int) -> Callable[[], None]:
    """n calls of run_step, each inside a STEP range."""
    def run():
        for _ in range(n):
            with torch.profiler.record_function(STEP):
                run_step()
    return run


def decompose_replayed(decoder, tokens: torch.Tensor, pos: torch.Tensor, *,
                       steps: int,
                       trace_dir: Optional[str] = None) -> Dict[str, Any]:
    """The split of ``steps`` steps of a ``BatchedDecoder`` replayed from
    its CUDA graph: the counterpart of ``decompose_jitted`` on
    ``decode_loop_batched``. One chunk from tokens and positions [B]: the
    capture if the decoder has none yet, one eager step (its first on this
    stream sets up what a steady step does not), two eager steps profiled
    under ``recording()``, the second of which gives each kernel's name
    and scope in launch order, then steps + 1 replayed steps profiled, the
    first left out, and the ring's flush, unprofiled (each profile's first
    step only leads in: a kernel that CUPTI loses at a trace's start
    cannot shorten a counted step). The kernels of each graph launch (the
    device events that carry its correlation id) are joined to the eager
    step by order (``join_replayed``); device events that the host
    launched around the replays (``torch.cuda.CUDAGraph.replay``'s own,
    where it has any) join their host op as in ``decompose``, each counted
    with the replay it precedes. On the CPU (an eager decoder, no graph)
    each step's ``aten::`` ops are joined by order in the same way. Takes
    steps + 4 (+1 for the capture) steps of the decoder's room and of one
    chunk. Adds ``trace_dir``, ``kernels`` (device events of the eager
    step), ``joined`` (replayed device events joined by order),
    ``launched`` (device events the host launched around the counted
    replays) and ``summary`` (``summarize`` of the counted replays)."""
    n = steps + 4 + int(decoder.use_graph and decoder.graph is None)
    if n > decoder.chunk:
        raise ValueError(f"{n} steps do not fit a chunk of {decoder.chunk}")
    decoder.begin(tokens, pos)
    if decoder.use_graph and decoder.graph is None:
        decoder.step()
    decoder.step(eager=True)
    _sync()
    eager = profiled(_in_steps(lambda: decoder.step(eager=True), 2))
    replay = profiled(_in_steps(decoder.step, steps + 1), record=False)
    decoder.finish(n)
    e_ops, e_map, e_dev = _launches(eager.events())
    r_evs = replay.events()
    r_ops, r_map, r_dev = _launches(r_evs)
    cpu = not (r_dev and _is_device(r_dev[0]))
    if cpu:
        # the stand-in ops: each step's ops are those under its range
        def step_of(e):
            return _ancestor(e, STEP)
    else:
        runtime = {**_runtime_calls(eager.events()), **_runtime_calls(r_evs)}

        def step_of(e):
            r = runtime.get(e.id)
            return None if r is None else _ancestor(r, STEP)
    e_steps = _steps(e_dev, step_of)
    if len(e_steps) != 2:
        raise ValueError(f"{len(e_steps)} eager steps in the profile of 2")
    ref = [(e_ops[k][1], e_map.get(k)) for k in e_steps[1]]
    r_steps = _steps(r_dev, step_of)
    if len(r_steps) != steps + 1:
        raise ValueError(f"{len(r_steps)} replayed steps in the profile of "
                         f"{steps + 1}")
    skip = {r_dev[k].id for k in r_steps[0]}
    if cpu:
        seqs, host = r_steps[1:], []
    else:
        # a step's graph kernels carry its graph launch's correlation id;
        # the rest of its device events the host launched
        graph = {i for i, r in runtime.items() if "GraphLaunch" in r.name}
        seqs = [[k for k in ks if r_dev[k].id in graph] for ks in r_steps[1:]]
        host = [k for ks in r_steps[1:] for k in ks
                if r_dev[k].id not in graph]
    joined = join_replayed(ref, [[(r_ops[k][1], r_ops[k][2]) for k in ks]
                                 for ks in seqs])
    events = [(("r", i), name, dur) for i, (name, _, dur) in
              enumerate(joined)] + [(("h", k), r_ops[k][1], r_ops[k][2])
                                    for k in host]
    smap = {("r", i): sc for i, (_, sc, _) in enumerate(joined)
            if sc is not None}
    smap.update({("h", k): r_map[k] for k in host if k in r_map})
    res = decompose_events(events, smap, steps)
    res["kernels"] = len(ref)
    res["joined"] = len(joined)
    res["launched"] = len(host)
    tdir = _export(eager, trace_dir, "eager_steps.json")
    res["trace_dir"] = _export(replay, tdir, "replayed.json")
    res["summary"] = summarize(r_evs, steps, skip=skip)
    return res


def _steps(dev, step_of) -> List[List[int]]:
    """The keys of the device events of each STEP range, ranges in time
    order (an event under none is left out)."""
    by = collections.defaultdict(list)
    for k, e in enumerate(dev):
        st = step_of(e)
        if st is not None:
            by[(st.time_range.start, st.id)].append(k)
    return [by[key] for key in sorted(by)]


# ---------------------------------------------------------------------------
# CLI: decode-step decomposition on the profile_decode model

def gpu_name_power(device: torch.device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them (None off
    the card)."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv: Optional[List[str]] = None, env=None) -> List[dict]:
    """The command line: one JSON line per policy (milliseconds rounded to
    3 places). Returns the lines' dicts unrounded."""
    from pqcache_tpu_torch import resolve_device
    from pqcache_tpu_torch.core.budget import compute_budget
    from pqcache_tpu_torch.harness import profile_decode as pdec
    from pqcache_tpu_torch.models import llama
    from pqcache_tpu_torch.policies.base import get_policy

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("policies", nargs="*", default=["pq_search"])
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu runs the plain versions)")
    args = ap.parse_args(argv)
    env = os.environ if env is None else env
    ctx = int(env.get("CTX", "4096"))
    layers = int(env.get("LAYERS", "2"))
    steps = int(env.get("STEPS", "8"))
    block = int(env.get("BLOCK", "1"))
    dev = resolve_device(args.device)
    model = pdec.model_config(layers, "trace")
    params = llama.init_params(
        model, torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev)
    card = gpu_name_power(dev)
    lines = []
    for name in args.policies or ["pq_search"]:
        cfg = pdec.engine_config(model, name, ctx, block)
        budget = compute_budget(cfg.budget, ctx, pdec.MAX_NEW)
        policy = get_policy(cfg, budget, device=dev)
        state = policy.init_state(torch.bfloat16)
        pdec.randomize_state(state, budget, ctx, name, cfg.pq.n_centroids)
        tok = torch.tensor(3, device=dev)
        calls = iter(range(10 ** 9))
        t0 = time.perf_counter()
        tdir = env.get("TRACE_DIR")
        res = decompose(
            lambda: llama.decode_loop(model, params, policy, state, tok,
                                      ctx + steps * next(calls), steps),
            steps=steps,
            trace_dir=tdir and os.path.join(tdir, f"{name}-block{block}"))
        res.pop("summary")
        res.pop("kernels")
        res.update(policy=name, ctx=ctx, layers=layers, steps=steps,
                   block=block, wall_s=round(time.perf_counter() - t0, 1),
                   device=str(dev), gpu_name_power=card)
        print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                          for k, v in res.items()}), flush=True)
        lines.append(res)
        del policy, state
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
