"""Closed-loop decode turns over one long prefilled prompt, for an AFMoE
model (Arcee's Trinity: sliding-window layers beside full layers, experts
on most layers).

Set-up, window and judgement as ``decode_turns.py`` has them: the weights
from the seed (``benchmark/weights_afmoe.py``), one prompt of
``prompt_tokens`` ids prefilled once in slabs of ``prefill_chunk`` through
``pqcache_tpu_torch/models/afmoe.py`` and the ``pq_search`` policy (PQ
retrieval on the full layers, a window ring on the others), its state
inserted into ``batch`` slots, a ``BatchedDecoder`` replayed from its CUDA
graph, turns until ``--seconds`` have passed.

``correct`` holds, against the plain reference
(``benchmark/reference/afmoe.py``) prefilled on the program's codebooks
and codes: ``code_mismatch`` and ``codebook_excess`` of the full layers,
``logit_gap`` of the served tokens of ``sample_turns`` finished slot-turns
drawn from the seed, teacher-forced, and ``route_mismatch``: the share of
(token, MoE layer) whose selected experts differ between the program and
the reference, the reference teacher-forced on those slot-turns' tokens
(the program's experts as served: each sampled turn stepped again
eagerly at the full batch on its served tokens before the state is
freed, an eager step being the replayed step's computation bit for bit;
where the pass's greedy tokens are not the served ones it is not what was
timed, ``route_mismatch`` is left unread and the run is not correct).
Near ties of the router's scores flip at rounding, so the share is
bounded, not zero; the reference computes the program's experts of those
steps (weighted by its own scores), as it selects blocks by the
program's codes, so that ``logit_gap`` judges the rest of the step.

The model module is imported first: a tree without it fails at once.
"""

from __future__ import annotations

import collections
import functools
import sys
import time

import numpy as np
import torch

from pqcache_tpu_torch.models import afmoe  # noqa: F401  (fails early)

from benchmark import weights_afmoe
from benchmark.common import pacing_gaps, percentile, rng, window_rate
from benchmark.drivers import decode_turns as dt


def engine_config(wl: dict):
    """The port's EngineConfig (its model an ``AfmoeConfig`` read from the
    configuration's own keys) and budget of a cell."""
    from pqcache_tpu_torch.config import (BudgetConfig, EngineConfig,
                                          ModelConfig, PQConfig,
                                          RuntimeConfig)
    from pqcache_tpu_torch.core.budget import compute_budget
    m = wl["model"]
    P, turn = wl["prompt_tokens"], wl["turn_tokens"]
    pq, bud = m["pq"], m["budget"]
    cfg = EngineConfig(
        model=ModelConfig.from_hf_config(m, m["name"]),
        pq=PQConfig(n_subvec_per_head=pq["n_subvec"],
                    n_subbits=pq["n_subbits"],
                    kmeans_iters=pq["kmeans_iters"],
                    kmeans_seed=pq["kmeans_seed"],
                    select_block=pq["select_block"],
                    fetch_par=pq["fetch_par"], ring_cap=wl["chunk"]),
        budget=BudgetConfig(compress_ratio=bud["compress_ratio"],
                            recent_ratio=bud["recent_ratio"],
                            sink_size=bud["sink"]),
        runtime=RuntimeConfig(policy="pq_search", max_new_tokens=turn,
                              max_seq_len=P + turn,
                              prefill_chunk=wl.get("prefill_chunk", 0)))
    return cfg, compute_budget(cfg.budget, P, turn)


class Program(dt.Program):
    """The system under test at one seed (``decode_turns.Program`` with
    this model's configuration, weights and prefill)."""

    def __init__(self, wl: dict, seed: int, device, graph: bool):
        from pqcache_tpu_torch.policies.base import get_policy
        from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
        self.wl, self.dev = wl, torch.device(device)
        cfg, budget = engine_config(wl)
        self.model, self.budget = cfg.model, budget
        self.policy = get_policy(cfg, budget, self.dev)
        self.params = weights_afmoe.draw(wl["model"], seed, self.dev)
        P, ch = wl["prompt_tokens"], wl.get("prefill_chunk", 0)
        self.ids = rng(seed, 1).integers(0, self.model.vocab_size, P)
        toks = torch.from_numpy(self.ids).to(self.dev)
        self.state = self.policy.init_state(torch.bfloat16)
        afmoe.prefill_chunked(self.model, self.params, self.policy,
                              self.state, toks, 0, P,
                              chunk=ch if ch and P > ch else P)
        self.bstate = self.policy.init_batched_state(wl["batch"])
        self.reset()
        self.decoder = BatchedDecoder(
            self.model, self.params, self.policy, self.bstate,
            chunk=wl["chunk"], graph=graph, device=self.dev,
            check_room=False)
        self.firsts = rng(seed, 2)

    def routes(self, turns: list, picks: list) -> tuple:
        """The program's experts of the picked (turn, slot) pairs as they
        were served: each picked turn stepped again eagerly from its reset
        at the full batch, every slot fed its served tokens, the ring
        flushed every ``chunk`` steps as the turn did. Each step's greedy
        token must be the one the replayed graph served in every picked
        slot, else the pass is not the timed computation. Returns (per step
        the MoE layers' selected experts [n, k], rows in pick order; the
        count of (step, picked slot)s whose greedy token is not the served
        one, each such count also told on standard error with the largest
        gap of the eager logits' max over the served token's)."""
        B, P, chunk = (self.wl["batch"], self.wl["prompt_tokens"],
                       self.wl["chunk"])
        pos = torch.full((B,), P, dtype=torch.int32, device=self.dev)
        seen, unserved = {}, 0
        for i in sorted({i for i, _ in picks}):
            first, toks = turns[i]
            self.reset()
            feed = torch.from_numpy(np.concatenate(
                [first[None], toks[:-1]]).astype(np.int32)).to(self.dev)
            slots = [s for t, s in picks if t == i]
            want = torch.from_numpy(toks[:, slots].astype(np.int64)).to(
                self.dev)
            seen[i], argmax, gaps = [], [], []
            for j in range(toks.shape[0]):
                step = []
                logits = afmoe.decode_step_batched(
                    self.model, self.params, self.policy, self.bstate,
                    feed[j], pos + j, routes=step)[slots]
                top = logits.max(-1)
                argmax.append(top.indices)
                gaps.append(top.values - logits.gather(
                    1, want[j][:, None])[:, 0])
                seen[i].append(step)
                if (j + 1) % chunk == 0:
                    self.policy.flush_ring_batched(self.bstate)
            bad = int((torch.stack(argmax) != want).sum())
            if bad:
                print(f"turn {i}: the eager pass's greedy tokens differ from "
                      f"the served ones in {bad} of {want.numel()} (step, "
                      f"picked slot)s, the served token's logit at most "
                      f"{float(torch.stack(gaps).max())} below the max",
                      file=sys.stderr)
            unserved += bad
        steps = len(seen[picks[0][0]])
        return [[torch.stack([seen[i][j][m][s] for i, s in picks])
                 for m in range(len(seen[picks[0][0]][0]))]
                for j in range(steps)], unserved


# -- the traced slice, with each kernel's scopes ------------------------------


def trace_decode(prog, steps: int) -> dict:
    """``benchmark/tracing.trace_decode`` (a frozen copy of its join) with
    two more keys: ``scopes``, each counted event's scope path beside
    ``events`` (outermost first, "/"-joined; "" for a kernel the host
    launched around a replay), and ``hit``, the number of distinct experts
    each MoE layer selected over the batch at the first eager step."""
    from benchmark import tracing as tr
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
    routes = []
    step_fn = dec.step_fn
    dec.step_fn = functools.partial(afmoe.decode_step_batched, routes=routes)
    try:
        dec.step(eager=True)
    finally:
        dec.step_fn = step_fn
    hit = [int(torch.unique(r).numel()) for r in routes]
    torch.cuda.synchronize()
    eager = tr.profiled(tr._in_steps(lambda: dec.step(eager=True), 2), True)
    e_evs = eager.events()
    e_rt = tr._runtime(e_evs)
    e_steps = tr._steps(tr._device_events(e_evs, e_rt), e_rt)
    if len(e_steps) != 2:
        raise RuntimeError(f"{len(e_steps)} eager steps in a profile of 2")
    ref = [(e.name, tr._scope_path(e_rt[e.id].cpu_parent)
            if e_rt[e.id].cpu_parent is not None else "")
           for e in e_steps[1]]
    done = 3
    for attempt in range(2):
        replay = tr.profiled(tr._in_steps(dec.step, steps + 2), False)
        try:
            rec = _replayed(tr, replay.events(), ref, steps)
            break
        except RuntimeError:
            if attempt:
                raise
        finally:
            done += steps + 2
    dec.finish(done)
    torch.cuda.synchronize()
    first = done - steps - 1
    rec.update(steps=steps, ring=list(range(first, first + steps)),
               batch=B, prompt_tokens=P, model=wl["model"], hit=hit)
    return rec


def _replayed(tr, events, ref, steps: int) -> dict:
    """``tracing._replayed`` keeping each counted event's scope path."""
    rt = tr._runtime(events)
    dev = tr._device_events(events, rt)
    r_steps = tr._steps(dev, rt)
    if len(r_steps) != steps + 2:
        raise RuntimeError(f"{len(r_steps)} replayed steps in a profile of "
                           f"{steps + 2}")
    graph = {i for i, r in rt.items() if "GraphLaunch" in r.name}
    out, scopes, spans = [], [], []
    for s, evs in enumerate(r_steps[1:-1]):
        seq = [e for e in evs if e.id in graph]
        if len(seq) != len(ref):
            raise RuntimeError(f"replayed step {s}: {len(seq)} kernels, the "
                               f"eager step launched {len(ref)}")
        for i, e in enumerate(seq):
            name, scope = ref[i]
            if not tr._same_launch(name, e.name):
                raise RuntimeError(f"replayed step {s}, kernel {i}: "
                                   f"{e.name[:120]!r}, eager {name[:120]!r}")
            out.append((name, tr.classify(name, scope),
                        float(e.time_range.end - e.time_range.start)))
            scopes.append(scope)
        for e in evs:
            if e.id not in graph:
                out.append((e.name, tr.classify(e.name, ""),
                            float(e.time_range.end - e.time_range.start)))
                scopes.append("")
            spans.append((float(e.time_range.start),
                          float(e.time_range.end)))
    t0 = min(a for a, _ in spans)
    t1 = max(b for _, b in spans)
    at = {float(e.time_range.start): e.name for e in dev}
    gaps = collections.Counter()
    cur = None
    for a, b in sorted(spans):
        if cur is not None and a > cur:
            gaps["before " + tr._short(at.get(a, "?"))] += a - cur
        cur = b if cur is None else max(cur, b)
    return dict(events=out, scopes=scopes, busy_s=tr._union_us(spans) / 1e6,
                window_s=(t1 - t0) / 1e6,
                idle_gaps=[(k, v / 1e6) for k, v in gaps.most_common(10)])


# -- judgement ----------------------------------------------------------------


def judge(wl: dict, ref, codes: torch.Tensor, inputs=None, out=None,
          routes=None, unserved: int = 0) -> tuple:
    """``decode_turns.judge``'s three numbers and ``route_mismatch``
    (``routes``: the program's teacher-forced experts of ``inputs``; left
    unread, and so not ok, where ``unserved`` counts tokens that the pass
    giving them did not serve), each beside its limit. Returns (checks,
    the count of tokens judged)."""
    from benchmark.reference.afmoe import route_mismatch
    lim = wl["limits"]
    vals = dict(code_mismatch=dt.code_mismatch(ref, codes),
                codebook_excess=dt.codebook_excess(ref), logit_gap=None,
                route_mismatch=None)
    n = 0
    if inputs is not None:
        mine = []
        gaps = ref.decode(inputs, [out], routes=mine, given=routes)[0][0]
        n, vals["logit_gap"] = int(gaps.size), float(gaps.max())
        if routes is not None and not unserved:
            vals["route_mismatch"] = route_mismatch(routes, mine)
    return [dict(name=k, value=v, limit=lim[k],
                 ok=v is not None and v <= lim[k])
            for k, v in vals.items()], n


def run(ctx: dict) -> dict:
    """One run of a decode_turns_afmoe cell (``benchmark/run.py`` gives
    ctx)."""
    wl, seed, dev = ctx["workload"], ctx["seed"], ctx["device"]
    graph = dev.type == "cuda"
    prog = Program(wl, seed, dev, graph)
    prog.turn(deadline=0.0)
    if graph:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx["t0"]
    turns, ends, counts = [], [], []
    t_start = time.perf_counter()
    deadline = t_start + ctx["seconds"]

    def on_chunk(n):
        ends.append(time.perf_counter())
        counts.append(n)
    while time.perf_counter() < deadline:
        turns.append(prog.turn(deadline, on_chunk))
    elapsed = ends[-1] - t_start
    tokens = int(sum(counts)) * wl["batch"]
    peak = torch.cuda.max_memory_allocated(dev) if graph else 0
    record = trace_decode(prog, wl["trace_steps"]) if ctx["trace"] else None
    picks = dt.sample(turns, wl, seed)
    served = dt.served(turns, picks) if picks else ()
    routes, unserved = prog.routes(turns, picks) if picks else (None, 0)
    ids = prog.ids
    cents = prog.state.centroids.float().clone()
    codes = prog.state.codes.clone()
    prog.free()
    from benchmark.reference.afmoe import AfmoeReference
    ref = AfmoeReference(wl, weights_afmoe.draw(wl["model"], seed, dev), dev)
    ref.prefill(ids, cents, codes)
    checks, n_judged = judge(wl, ref, codes, *served, routes=routes,
                             unserved=unserved)
    gaps_tbt = pacing_gaps([t_start] + ends, counts)
    paces = [round((b - a) / n * 1e3, 4) for a, b, n in
             zip([t_start] + ends, ends, counts)]
    return dict(
        metrics={"setup_s": setup_s,
                 "tok_s": window_rate(t_start, ends, counts, wl["batch"]),
                 "tbt_p99_ms": percentile(gaps_tbt, 99) * 1e3},
        attempted=len(turns) * wl["batch"], failed=0,
        checks=checks, memory_peak_bytes=peak, record=record,
        window_s=elapsed, tokens=tokens, judged=n_judged, paces=paces)
