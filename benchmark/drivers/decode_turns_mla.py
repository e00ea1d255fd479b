"""Closed-loop decode turns over one long prefilled prompt, for a DeepSeek-V2
model (multi-head latent attention over a latent cache, experts on every
layer after the first).

Set-up, window and judgement as ``decode_turns_afmoe.py`` has them: the
weights from the seed (``benchmark/weights_deepseek_v2.py``), one prompt of
``prompt_tokens`` ids prefilled once in slabs of ``prefill_chunk``
through ``pqcache_tpu_torch/models/deepseek_v2.py`` and the ``pq_search``
policy (PQ retrieval over each layer's latent rows), its state inserted
into ``batch`` slots, a ``BatchedDecoder`` replayed from its CUDA graph,
turns until ``--seconds`` have passed.

``correct`` holds the same four numbers against the plain reference
(``benchmark/reference/deepseek_v2.py``) prefilled on the program's
codebooks and codes: ``code_mismatch`` and ``codebook_excess`` of the
latent rows' codes, ``logit_gap`` of the served tokens of
``sample_turns`` finished slot-turns drawn from the seed, teacher-forced,
and ``route_mismatch`` of the program's experts as served (each sampled
turn stepped again eagerly at the full batch, ``Program.routes``).

The model module is imported first: a tree without it fails at once.
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np
import torch

from pqcache_tpu_torch.models import deepseek_v2  # noqa: F401  (fails early)

from benchmark import weights_deepseek_v2
from benchmark.common import pacing_gaps, percentile, rng, window_rate
from benchmark.drivers import decode_turns as dt
from benchmark.drivers import decode_turns_afmoe as da


class Program(da.Program):
    """The system under test at one seed (``decode_turns.Program`` with
    this model's configuration, weights and prefill)."""

    def __init__(self, wl: dict, seed: int, device, graph: bool):
        from pqcache_tpu_torch.policies.base import get_policy
        from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
        self.wl, self.dev = wl, torch.device(device)
        cfg, budget = da.engine_config(wl)
        self.model, self.budget = cfg.model, budget
        self.policy = get_policy(cfg, budget, self.dev)
        self.params = weights_deepseek_v2.draw(wl["model"], seed, self.dev)
        P, ch = wl["prompt_tokens"], wl.get("prefill_chunk", 0)
        self.ids = rng(seed, 1).integers(0, self.model.vocab_size, P)
        toks = torch.from_numpy(self.ids).to(self.dev)
        self.state = self.policy.init_state(torch.bfloat16)
        deepseek_v2.prefill_chunked(self.model, self.params, self.policy,
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
        """``decode_turns_afmoe.Program.routes`` through this model's
        eager step."""
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
                logits = deepseek_v2.decode_step_batched(
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


def trace_decode(prog, steps: int) -> dict:
    """``decode_turns_afmoe.trace_decode`` through this model's eager
    step: the record with each counted event's scope path (``scopes``) and
    each MoE layer's distinct experts at the first eager step (``hit``)."""
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
    dec.step_fn = functools.partial(deepseek_v2.decode_step_batched,
                                    routes=routes)
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
            rec = da._replayed(tr, replay.events(), ref, steps)
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


def run(ctx: dict) -> dict:
    """One run of a decode_turns_mla cell (``benchmark/run.py`` gives
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
    from benchmark.reference.deepseek_v2 import MlaReference
    ref = MlaReference(wl, weights_deepseek_v2.draw(wl["model"], seed, dev),
                       dev)
    ref.prefill(ids, cents, codes)
    checks, n_judged = da.judge(wl, ref, codes, *served, routes=routes,
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
