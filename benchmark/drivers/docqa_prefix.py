"""Open-loop question answering over one long shared document, through the
serving engine's prefix cache.

Set-up: the weights from the seed (W8 where the configuration states it),
one document of ``prefix_tokens`` ids from the seed prefilled once
(``Engine.prefill_prefix``: its per-layer K/V kept as a ``PrefixCache``),
and a ``BatchEngine`` of ``pool`` slots over it (``prefix=``: every
request is a question prefilled against the cached document, its
PQCache state built over the document and the question, then inserted
into a free slot). Two warm-up requests capture the decode graph and run
the admission's shapes (every question is right-padded to the pool's
suffix room).

Window: requests arrive by a Poisson process at ``rate`` requests a second
(exponential gaps from the seed) for ``--seconds``; each asks a question of
``question_min`` to ``question_max`` ids, drawn uniformly from the seed,
and is answered with ``answer_tokens`` greedy tokens. ``BatchEngine.run``
admits arrived requests between decode chunks of ``chunk`` steps, in
arrival order; the window ends when the last request is answered. Its
end-to-end metric is the tail of the time between tokens, by chunk pacing
(each chunk's tokens share its time), every request's tokens pooled.

Then ``correct`` (``decode_turns.judge``'s three numbers) on ``judged``
requests drawn from the seed among the first ``judge_from``: each one's
codebooks and codes are copied when it is admitted, and after the window
the plain reference (``benchmark/reference/pqcache.py``) prefills the
document and the question on them and decodes the served answer
teacher-forced; a request's worst number counts.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import weights as bench_weights
from benchmark.common import pacing_gaps, percentile, rng
from benchmark.drivers import decode_turns as dt


def shape(wl: dict) -> dict:
    """The workload as ``decode_turns.engine_config`` reads it: the pool's
    prefill length (document + the longest question), the answer, the
    decode chunk (the ring's cap)."""
    return dict(wl, prompt_tokens=wl["prefix_tokens"] + wl["question_max"],
                turn_tokens=wl["answer_tokens"])


def requests(wl: dict, seed: int, seconds: float) -> tuple:
    """The window's requests [(id, question ids)] and their arrival times
    {id: s}, a Poisson process at ``rate`` over ``seconds``."""
    r = rng(seed, 4)
    V = wl["model"]["vocab_size"]
    out, at, t = [], {}, 0.0
    while True:
        t += r.exponential(1.0 / wl["rate"])
        if t >= seconds:
            return out, at
        n = int(r.integers(wl["question_min"], wl["question_max"] + 1))
        out.append((len(out), r.integers(0, V, n)))
        at[len(out) - 1] = t


class Program:
    """The system under test at one seed: weights, the document's prefix
    cache and the serving engine over it."""

    def __init__(self, wl: dict, seed: int, device):
        from pqcache_tpu_torch.core import quant
        from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
        from pqcache_tpu_torch.runtime.generate import Engine
        self.wl, self.dev = shape(wl), torch.device(device)
        cfg, _ = dt.engine_config(self.wl)
        self.cfg = cfg
        params = bench_weights.draw(wl["model"], seed, self.dev)
        if wl["model"]["precision"]["weights"] == "int8":
            params = quant.quantize_weight_tree(params)
        self.doc = rng(seed, 1).integers(0, cfg.model.vocab_size,
                                         wl["prefix_tokens"])
        self.prefix = Engine(cfg, params, device=self.dev).prefill_prefix(
            self.doc)
        self.engine = BatchEngine(
            cfg, params, batch_size=wl["pool"],
            prefill_len=self.wl["prompt_tokens"],
            max_new_tokens=wl["answer_tokens"], prefix=self.prefix,
            device=self.dev)
        self.kept = {}
        self._place = self.engine._place
        self.engine._place = self._keep

    def _keep(self, seq_id, state, first, pos0):
        """The engine's slot insert, copying the codebooks and codes of a
        request to be judged first."""
        if seq_id in self.judged:
            self.kept[seq_id] = (state.centroids.float().clone(),
                                 state.codes.clone())
        return self._place(seq_id, state, first, pos0)

    def serve(self, reqs, arrivals, judged=()) -> tuple:
        """reqs answered under their arrivals; returns (answers, timing)."""
        self.judged = set(judged)
        timing = {}
        out = self.engine.run(reqs, chunk=self.wl["chunk"],
                              arrivals=arrivals, timing=timing)
        return out, timing

    def free(self) -> None:
        self.engine = self.prefix = self._place = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()


def tbt_gaps(timing: dict) -> list:
    """Every request's time between tokens by chunk pacing: the tokens of a
    chunk (one completion time) share the chunk's time since the last."""
    gaps = []
    for ev in timing.values():
        tt = ev.get("token_times", [])
        times, counts = [tt[0]] if tt else [], []
        for t in tt[1:]:
            if t != times[-1]:
                times.append(t)
                counts.append(1)
            else:
                counts[-1] += 1
        gaps.extend(pacing_gaps(times, counts))
    return gaps


def judge(wl: dict, prog: Program, reqs: list, out: dict, seed: int,
          dev) -> tuple:
    """``decode_turns.judge`` on each judged request (its document and
    question prefilled by the reference on its codebooks and codes, its
    answer after the first token teacher-forced); each number the worst
    over the requests. Returns (checks, tokens judged)."""
    from benchmark.reference.pqcache import Reference
    w = bench_weights.draw(wl["model"], seed, dev)
    worst, n = {}, 0
    for sid in sorted(prog.kept):
        cents, codes = prog.kept[sid]
        ans = np.asarray(out.get(sid, []), np.int64)
        ids = np.concatenate([prog.doc, reqs[sid][1]])
        ref = Reference(wl, w, dev)
        ref.prefill(ids, cents, codes)
        args = ((ans[None, :-1], ans[None, 1:]) if ans.size > 1 else ())
        checks, k = dt.judge(wl, ref, codes, *args)
        n += k
        for c in checks:
            v = worst.get(c["name"], 0.0)
            worst[c["name"]] = (None if v is None or c["value"] is None
                                else max(v, c["value"]))
        del ref
    lim = wl["limits"]
    if len(prog.kept) < wl["judged"]:
        worst = {k: None for k in lim}
    return [dict(name=k, value=worst.get(k), limit=lim[k],
                 ok=worst.get(k) is not None and worst[k] <= lim[k])
            for k in ("code_mismatch", "codebook_excess", "logit_gap")], n


def trace(prog: Program, steps: int) -> dict:
    """``benchmark/tracing.trace_decode`` of the engine's decoder over the
    slots as the window left them (a pool whose last requests finished
    decodes on in their rows, as a serving pool does between requests)."""
    from benchmark.tracing import trace_decode
    eng = prog.engine

    class Pool:
        decoder, dev = eng.decoder, prog.dev
        wl = dict(batch=eng.B, prompt_tokens=eng.P, model=prog.wl["model"])

        @staticmethod
        def reset():
            pass

        @staticmethod
        def first_tokens():
            return np.asarray([s.next_tok for s in eng.slots], np.int64)
    return trace_decode(Pool, steps)


def run(ctx: dict) -> dict:
    """One run of a docqa_prefix cell (``benchmark/run.py`` gives ctx)."""
    wl, seed, dev = ctx["workload"], ctx["seed"], ctx["device"]
    prog = Program(wl, seed, dev)
    V = wl["model"]["vocab_size"]
    warm = [(-1 - i, rng(seed, 5).integers(0, V, wl["question_max"] - i))
            for i in range(2)]
    prog.serve(warm, {})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx["t0"]
    reqs, arrivals = requests(wl, seed, ctx["seconds"])
    first = min(wl["judge_from"], len(reqs))
    picks = (rng(seed, 3).choice(first, min(wl["judged"], first),
                                 replace=False).tolist() if first else [])
    t_start = time.perf_counter()
    out, timing = prog.serve(reqs, arrivals, picks)
    elapsed = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    record = trace(prog, wl["trace_steps"]) if ctx["trace"] else None
    prog.free()
    checks, n_judged = judge(shape(wl), prog, reqs, out, seed, dev)
    done = [s for s, _ in reqs if len(out.get(s, [])) == wl["answer_tokens"]]
    gaps = tbt_gaps({s: timing[s] for s in done})
    firsts = [timing[s]["first"] - timing[s]["arrive"] for s in done]
    return dict(
        metrics={"setup_s": setup_s,
                 "tbt_p99_ms": percentile(gaps, 99) * 1e3 if gaps else None},
        attempted=len(reqs), failed=len(reqs) - len(done), checks=checks,
        memory_peak_bytes=peak, record=record, window_s=elapsed,
        tokens=sum(len(out.get(s, [])) for s in done), judged=n_judged,
        paces=dict(requests=len(reqs),
                   ttft_p50_s=percentile(firsts, 50) if firsts else None,
                   ttft_p95_s=percentile(firsts, 95) if firsts else None))
