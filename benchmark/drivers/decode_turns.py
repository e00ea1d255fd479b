"""Closed-loop decode turns over one long prefilled prompt.

Set-up: the weights from the seed, one prompt of ``prompt_tokens`` ids from
the seed prefilled once (chunked at ``prefill_chunk`` where that is set),
its state inserted into ``batch`` slots of a batched state, and a
``BatchedDecoder`` replayed from its CUDA graph (``check_room=False``, as
``BatchEngine`` builds it: the driver checks each turn's room). A warm-up
turn captures the graph and runs every shape of the window.

Window: turns until ``--seconds`` have passed, each ending at a chunk's
end. A turn resets every slot from the prefilled state in place
(``policy.insert_slot``), gives each slot its own first token from the
seed at position ``prompt_tokens``, and decodes ``turn_tokens`` tokens in
chunks of ``chunk`` steps. Every chunk's tokens are read back (the chunk's
one wait for the card).

Then ``correct`` (``judge``), after the program's state is freed: the plain
reference (``benchmark/reference/pqcache.py``) prefills the prompt on the
program's codebooks and codes, and holds each to a limit: the share of the
codes that are not the nearest centroid of its keys, the codebooks' fit to
its keys against its own k-means, and, decoding a sample drawn from the
seed of ``sample_turns`` finished slot-turns teacher-forced on the served
tokens, the widest gap of a served token below its best logit.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import weights as bench_weights
from benchmark.common import (model_shape, pacing_gaps, percentile, rng,
                              window_rate)


def engine_config(wl: dict):
    """The port's EngineConfig, model config and budget of a cell."""
    from pqcache_tpu_torch.config import (BudgetConfig, CacheConfig,
                                          EngineConfig, ModelConfig, PQConfig,
                                          RuntimeConfig)
    from pqcache_tpu_torch.core.budget import compute_budget
    m, s = wl["model"], model_shape(wl["model"])
    P, turn = wl["prompt_tokens"], wl["turn_tokens"]
    model = ModelConfig(
        name=m["name"], vocab_size=s["V"], hidden_size=s["E"],
        intermediate_size=s["I"], num_layers=s["L"], num_heads=s["H"],
        num_kv_heads=s["Hkv"], head_dim=s["D"], rms_norm_eps=s["eps"],
        rope_theta=s["theta"],
        max_position_embeddings=m["max_position_embeddings"],
        tie_word_embeddings=bool(m.get("tie_word_embeddings", False)),
        mlp_chunk=m["runtime"]["mlp_chunk"])
    pq, bud = m["pq"], m["budget"]
    cfg = EngineConfig(
        model=model,
        pq=PQConfig(n_subvec_per_head=pq["n_subvec"],
                    n_subbits=pq["n_subbits"],
                    kmeans_iters=pq["kmeans_iters"],
                    kmeans_seed=pq["kmeans_seed"],
                    select_block=pq["select_block"],
                    fetch_par=pq["fetch_par"], ring_cap=wl["chunk"]),
        budget=BudgetConfig(compress_ratio=bud["compress_ratio"],
                            recent_ratio=bud["recent_ratio"],
                            sink_size=bud["sink"]),
        cache=CacheConfig(kv_dtype=m["precision"]["kv_tail"]),
        runtime=RuntimeConfig(policy="pq_search", max_new_tokens=turn,
                              max_seq_len=P + turn,
                              prefill_chunk=wl.get("prefill_chunk", 0)))
    return cfg, compute_budget(cfg.budget, P, turn)


class Program:
    """The system under test at one seed: weights, prefill, the batched
    state and its replayed decoder."""

    def __init__(self, wl: dict, seed: int, device, graph: bool):
        from pqcache_tpu_torch.core import quant
        from pqcache_tpu_torch.models import llama
        from pqcache_tpu_torch.policies.base import get_policy
        from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
        self.wl, self.dev = wl, torch.device(device)
        cfg, budget = engine_config(wl)
        self.model, self.budget = cfg.model, budget
        self.policy = get_policy(cfg, budget, self.dev)
        params = bench_weights.draw(wl["model"], seed, self.dev)
        if wl["model"]["precision"]["weights"] == "int8":
            params = quant.quantize_weight_tree(params)
        self.params = params
        P, ch = wl["prompt_tokens"], wl.get("prefill_chunk", 0)
        self.ids = rng(seed, 1).integers(0, self.model.vocab_size, P)
        toks = torch.from_numpy(self.ids).to(self.dev)
        self.state = self.policy.init_state(torch.bfloat16)
        if ch and P > ch:
            llama.prefill_chunked(self.model, params, self.policy,
                                  self.state, toks, 0, P, chunk=ch)
        else:
            llama.prefill(self.model, params, self.policy, self.state, toks,
                          0, P)
        B = wl["batch"]
        self.bstate = self.policy.init_batched_state(B)
        self.reset()
        self.decoder = BatchedDecoder(
            self.model, params, self.policy, self.bstate, chunk=wl["chunk"],
            graph=graph, device=self.dev, check_room=False)
        self.firsts = rng(seed, 2)

    def reset(self) -> None:
        """Every slot back to the prefilled prompt, in place."""
        for s in range(self.wl["batch"]):
            self.policy.insert_slot(self.bstate, self.state, s)

    def first_tokens(self) -> np.ndarray:
        return self.firsts.integers(0, self.model.vocab_size,
                                    self.wl["batch"])

    def turn(self, deadline=None, on_chunk=None):
        """One turn: reset, then chunks until turn_tokens or, once a chunk
        ends past ``deadline`` (perf_counter seconds), that chunk. Returns
        (first tokens [B], tokens [steps, B] on the host)."""
        wl, dev = self.wl, self.dev
        B, chunk, P = wl["batch"], wl["chunk"], wl["prompt_tokens"]
        first = self.first_tokens()
        self.reset()
        tok = torch.from_numpy(first.astype(np.int32)).to(dev)
        pos = torch.full((B,), P, dtype=torch.int32, device=dev)
        outs, done = [], 0
        while done < wl["turn_tokens"]:
            if done + chunk > self.budget.max_new_tokens:
                raise RuntimeError(f"a turn of {done + chunk} steps exceeds "
                                   f"the slots' room "
                                   f"{self.budget.max_new_tokens}")
            out = self.decoder.decode(tok, pos + done, chunk)
            outs.append(out.cpu().numpy())
            done += chunk
            tok = out[-1]
            if on_chunk is not None:
                on_chunk(chunk)
            if deadline is not None and time.perf_counter() >= deadline:
                break
        return first, np.concatenate(outs)

    def free(self) -> None:
        for name in ("decoder", "bstate", "state", "params", "policy"):
            setattr(self, name, None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()


def sample(turns: list, wl: dict, seed: int) -> list:
    """(turn, slot) pairs of finished turns, drawn from the seed."""
    full = [i for i, (_, t) in enumerate(turns)
            if t.shape[0] == wl["turn_tokens"]]
    pairs = [(i, s) for i in full for s in range(wl["batch"])]
    if not pairs:
        return []
    pick = rng(seed, 3).choice(len(pairs), min(wl["sample_turns"],
                                               len(pairs)), replace=False)
    return [pairs[k] for k in sorted(pick)]


def served(turns: list, picks: list):
    """(inputs, served tokens) [n, T] of the picked slot-turns: each step's
    input is the turn's first token or the token served before it."""
    out = np.stack([turns[i][1][:, s] for i, s in picks])
    firsts = np.stack([turns[i][0][s] for i, s in picks])
    return np.concatenate([firsts[:, None], out[:, :-1]], 1), out


def code_mismatch(ref, codes: torch.Tensor) -> float:
    """The share of the program's tail codes [L, Hkv, S, >= N] that are
    not the nearest centroid of the reference's keys."""
    n = bad = 0
    for i, st in enumerate(ref.state):
        r = st["own_codes"]
        p = codes[i, ..., :r.shape[-1]].to(r.device).long()
        bad += int((p != r).sum())
        n += r.numel()
    return bad / n


def codebook_excess(ref) -> float:
    """The worst layer's excess of the codebook and codes in use over the
    reference's own k-means of its keys: mean squared distance of each tail
    key to its coded centroid, as a share above the reference's."""
    return max(st["fit"]["used"] / st["fit"]["own"] - 1.0
               for st in ref.state)


def judge(wl: dict, ref, codes: torch.Tensor, inputs=None,
          out=None) -> tuple:
    """The numbers compared with the cell's limits, each beside its limit,
    for a reference prefilled on the codebooks and codes judged: the
    codes, the codebooks' fit, and the widest gap of the served tokens out
    [n, T] (fed inputs [n, T]) below the reference's best logit. Returns
    (checks, the count of tokens judged)."""
    lim = wl["limits"]
    vals = dict(code_mismatch=code_mismatch(ref, codes),
                codebook_excess=codebook_excess(ref), logit_gap=None)
    n = 0
    if inputs is not None:
        gaps = ref.decode(inputs, [out])[0][0]
        n, vals["logit_gap"] = int(gaps.size), float(gaps.max())
    return [dict(name=k, value=v, limit=lim[k],
                 ok=v is not None and v <= lim[k])
            for k, v in vals.items()], n


def run(ctx: dict) -> dict:
    """One run of a decode_turns cell (``benchmark/run.py`` gives ctx)."""
    wl, seed, dev = ctx["workload"], ctx["seed"], ctx["device"]
    graph = dev.type == "cuda"
    prog = Program(wl, seed, dev, graph)
    prog.turn(deadline=0.0)          # warm-up: capture, reset, a chunk
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
    peak = (torch.cuda.max_memory_allocated(dev) if graph else 0)
    record = None
    if ctx["trace"]:
        from benchmark.tracing import trace_decode
        record = trace_decode(prog, wl["trace_steps"])
    ids = prog.ids
    cents = prog.state.centroids.float().clone()
    codes = prog.state.codes.clone()
    prog.free()
    picks = sample(turns, wl, seed)
    from benchmark.reference.pqcache import Reference
    ref = Reference(wl, bench_weights.draw(wl["model"], seed, dev), dev)
    ref.prefill(ids, cents, codes)
    # no finished turn: no token judged, and logit_gap fails
    checks, n_judged = judge(wl, ref, codes,
                             *(served(turns, picks) if picks else ()))
    # chunk pacing: every stream of the pool receives a chunk's tokens
    # when the chunk ends
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
