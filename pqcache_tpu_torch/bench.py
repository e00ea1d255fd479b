"""bench.py's protocol through the port: pq_search against full-attention
decode throughput at long context, on one GPU.

    python -m pqcache_tpu_torch.bench

Reads the root ``bench.py``'s variables with its defaults: BENCH_CTX
(32768), BENCH_GEN (128), BENCH_RING (128), BENCH_LAYERS (8), BENCH_BATCH
(8), BENCH_PQ_BLOCK (256), BENCH_FETCH_PAR (32), BENCH_W_INT8 (1),
BENCH_PREFILL_CHUNK (32768 past 98304 tokens, else 0), BENCH_FETCH_PAIR
(0), BENCH_SKIP_BASE (0), BENCH_KV_INT8 (1), BENCH_MLP_CHUNK (16384).
Prints bench.py's one JSON line, with the card's name in its metric.

Per arm (pq_search, then the bf16 `original` baseline unless skipped), at
Llama-3.1-8B width and BENCH_LAYERS layers with random weights from a seed:
one prompt prefilled twice (chunked past BENCH_PREFILL_CHUNK), the second
timed; then at B > 1 the prefilled state inserted into B slots and decoded
by ``BatchedDecoder`` replayed from its CUDA graph (a warm chunk, then 3
timed reps of whole chunks, the fastest kept), at B = 1 by
``llama.decode_loop`` (a warm call and 3 timed reps). Weight-only int8 goes
to the pq arm only; each arm's weights and state are freed before the next
arm allocates its own. The budget reserves exactly the steps decoded (the
warm chunk and the reps), where bench.py reserved gen + 2 and decoded four
times that.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import (BudgetConfig, CacheConfig, EngineConfig,
                                      ModelConfig, PQConfig, RuntimeConfig)
from pqcache_tpu_torch.core import quant
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
from pqcache_tpu_torch.runtime.generate import chunk_plan


def bench_model(layers: int = 8, mlp_chunk: int = 16384) -> ModelConfig:
    """bench.py's model: Llama-3.1 widths at ``layers`` layers."""
    return ModelConfig(
        name=f"llama31-{layers}L-bench", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=layers, num_heads=32,
        num_kv_heads=8, head_dim=128, rope_theta=500000.0,
        rope_scaling_factor=8.0, max_position_embeddings=131072,
        mlp_chunk=mlp_chunk)


def settings(env=None) -> dict:
    """bench.py's variables from ``env`` (os.environ unless given): the
    model's depth and MLP chunk, and run()'s keywords."""
    env = os.environ if env is None else env

    def num(name, default):
        return int(env.get(name, default))

    def flag(name, default):
        return env.get(name, default) == "1"
    ctx = num("BENCH_CTX", "32768")
    return dict(
        layers=num("BENCH_LAYERS", "8"), mlp_chunk=num("BENCH_MLP_CHUNK",
                                                       "16384"),
        ctx=ctx, gen=num("BENCH_GEN", "128"), ring=num("BENCH_RING", "128"),
        batch=num("BENCH_BATCH", "8"), pq_block=num("BENCH_PQ_BLOCK", "256"),
        fetch_par=num("BENCH_FETCH_PAR", "32"),
        w_int8=flag("BENCH_W_INT8", "1"),
        prefill_chunk=num("BENCH_PREFILL_CHUNK",
                          "32768" if ctx > 98304 else "0"),
        fetch_pair=flag("BENCH_FETCH_PAIR", "0"),
        skip_base=flag("BENCH_SKIP_BASE", "0"),
        kv_int8=flag("BENCH_KV_INT8", "1"))


def decoded_steps(gen: int, batch: int, ring_k: int) -> tuple[int, int, int]:
    """(chunk, steps per rep, steps decoded in all): B = 1 decodes gen
    steps per call; B > 1 whole chunks of min(gen, ring_k), a rep rounding
    gen up to them. A warm call and 3 reps."""
    chunk = gen if batch == 1 else min(gen, ring_k or gen)
    steps = -(-gen // chunk) * chunk
    return chunk, steps, chunk + 3 * steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _params(model, seed: int, quantized: bool, dev) -> dict:
    p = llama.init_params(model, torch.Generator(device=dev).manual_seed(seed),
                          dtype=torch.bfloat16, device=dev)
    return quant.quantize_weight_tree(p) if quantized else p


def _arm(model, policy_name: str, *, ctx, gen, ring, batch, pq_block,
         fetch_par, w_int8, prefill_chunk, fetch_pair, kv_int8, seed, dev,
         graph) -> dict:
    """One arm: tok/s, ms per step and the timed prefill's seconds."""
    P, ch = (chunk_plan(ctx, prefill_chunk) if prefill_chunk
             and ctx > prefill_chunk else (ctx, 0))
    pad = P - ctx
    ids = np.random.default_rng(seed).integers(0, model.vocab_size, ctx)
    toks = np.zeros(P, np.int64)
    toks[pad:] = ids
    toks = torch.from_numpy(toks).to(dev)
    pq_arm = policy_name == "pq_search"

    def cfg_for(max_new):
        return EngineConfig(
            model=model,
            pq=PQConfig(n_subvec_per_head=2, n_subbits=6, kmeans_iters=6,
                        select_block=pq_block, fetch_par=fetch_par,
                        fetch_pair=fetch_pair, ring_cap=ring),
            budget=BudgetConfig(compress_ratio=0.2, recent_ratio=0.5,
                                sink_size=32),
            cache=CacheConfig(kv_dtype="int8" if pq_arm and kv_int8
                              else "bf16"),
            runtime=RuntimeConfig(policy=policy_name, prefill_bucket=1024,
                                  max_new_tokens=max_new,
                                  max_seq_len=P + 2048, prefill_chunk=ch))

    # the ring's size depends on the budget's local window, not on the
    # reservation: read it, then reserve exactly the steps decoded
    probe = cfg_for(gen + 2)
    ring_k = getattr(get_policy(probe, compute_budget(probe.budget, P,
                                                      gen + 2), dev),
                     "ring_k", 0)
    chunk, steps, total = decoded_steps(gen, batch, ring_k)
    cfg = cfg_for(total)
    policy = get_policy(cfg, compute_budget(cfg.budget, P, total), dev)
    params = _params(model, seed, w_int8 and pq_arm, dev)

    def prefill():
        state = policy.init_state(torch.bfloat16)
        if ch:
            logits = llama.prefill_chunked(model, params, policy, state, toks,
                                           pad, ctx, chunk=ch)
        else:
            logits = llama.prefill(model, params, policy, state, toks, pad,
                                   ctx)
        return int(torch.argmax(logits)), state

    prefill()                            # the first run: kernels, caches
    _sync(dev)
    t0 = time.perf_counter()
    first, state = prefill()
    prefill_s = time.perf_counter() - t0

    times = []
    if batch == 1:
        tok0 = torch.full((), first, device=dev)
        llama.decode_loop(model, params, policy, state, tok0, ctx,
                          gen).cpu()                          # warm
        for rep in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            llama.decode_loop(model, params, policy, state, tok0,
                              ctx + gen * (rep + 1), gen).cpu()
            times.append(time.perf_counter() - t0)
    else:
        bstate = policy.init_batched_state(batch)
        for slot in range(batch):
            policy.insert_slot(bstate, state, slot)
        del state
        dec = BatchedDecoder(model, params, policy, bstate, chunk=chunk,
                             graph=graph, device=dev)
        tok = torch.full((batch,), first, dtype=torch.int32, device=dev)
        pos = torch.full((batch,), ctx, dtype=torch.int32, device=dev)
        dec.decode(tok, pos, chunk).cpu()                   # warm, capture
        for rep in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            for done in range(0, steps, chunk):
                out = dec.decode(tok, pos + (chunk + steps * rep + done),
                                 chunk)
            out.cpu()
            times.append(time.perf_counter() - t0)
        if dec.steps_left != 0:
            raise RuntimeError(f"{dec.steps_left} reserved steps not decoded")
    dt = min(times)
    return {"tok_s": batch * steps / dt, "per_step_ms": dt / steps * 1e3,
            "prefill_s": prefill_s}


def run(model: ModelConfig, *, ctx: int = 32768, gen: int = 128,
        ring: int = 128, batch: int = 8, pq_block: int = 256,
        fetch_par: int = 32, w_int8: bool = True, prefill_chunk=None,
        fetch_pair: bool = False, skip_base: bool = False,
        kv_int8: bool = True, seed: int = 0, device=None,
        graph: bool = True) -> dict:
    """bench.py's protocol on ``model`` (bench_model() for bench.py's
    widths); returns the dict of its JSON line. device: cuda unless given
    (raises without CUDA); ``graph=False`` decodes B > 1 eagerly, the only
    mode the CPU takes. prefill_chunk None: bench.py's default."""
    dev = resolve_device(device)
    if graph and dev.type != "cuda":
        raise RuntimeError(f"the replayed decode needs a CUDA device, not "
                           f"{dev}: pass graph=False to run on the cpu")
    if prefill_chunk is None:
        prefill_chunk = 32768 if ctx > 98304 else 0
    kw = dict(ctx=ctx, gen=gen, ring=ring, batch=batch, pq_block=pq_block,
              fetch_par=fetch_par, w_int8=w_int8,
              prefill_chunk=prefill_chunk, fetch_pair=fetch_pair,
              kv_int8=kv_int8, seed=seed, dev=dev, graph=graph)
    results = {}
    for name in ("pq_search",) if skip_base else ("pq_search", "original"):
        results[name] = _arm(model, name, **kw)
        if dev.type == "cuda":
            torch.cuda.empty_cache()     # the arm's weights and state
    pq, base = results["pq_search"], results.get("original")
    kv_dtype = "int8" if kv_int8 else "bf16"
    label = "decode tok/s" if batch == 1 else \
        f"aggregate decode tok/s, B={batch}"
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {
        "metric": (f"pq_search {label} @ {ctx} ctx ({model.num_layers}L "
                   f"llama31-width, bf16 model, {kv_dtype} pq tail, single "
                   f"{card})"),
        "value": round(pq["tok_s"], 2),
        "unit": "tok/s",
        "vs_baseline": (round(pq["tok_s"] / base["tok_s"], 3) if base
                        else None),
        "detail": {
            "baseline_full_attn_tok_s": (round(base["tok_s"], 2) if base
                                         else "OOM (skipped)"),
            "pq_step_ms": round(pq["per_step_ms"], 2),
            "base_step_ms": (round(base["per_step_ms"], 2) if base
                             else None),
            "pq_prefill_s": round(pq["prefill_s"], 3),
            "base_prefill_s": (round(base["prefill_s"], 3) if base
                               else None),
            "ctx": ctx, "layers": model.num_layers, "batch": batch,
            "select_block": pq_block, "pq_kv_dtype": kv_dtype,
            "w_int8": w_int8,
        },
    }


def main() -> None:
    s = settings()
    model = bench_model(s.pop("layers"), s.pop("mlp_chunk"))
    print(json.dumps(run(model, **s)))


if __name__ == "__main__":
    main()
