"""Serving-latency harness: TTFT and inter-token latency percentiles under
concurrent load on the slot-pool engine (``runtime/batch_engine.py``).

Counterpart of ``pqcache_tpu/harness/serving.py``. N requests are
submitted against a B-slot pool on an (optionally staggered) arrival
schedule; per policy it reports:

  * ttft_p50/p95_s   first token on the host minus arrival (queue wait +
                     prefill; admissions share the loop with decode chunks)
  * wait_p50/p95_s   admission delay (queue + chunk-boundary latency)
  * tbt_p50/p95_ms   time between tokens from chunk-completion pacing
                     (each chunk's wall time divided by the tokens it
                     delivered)
  * agg_tok_s        generated tokens / wall time
  * e2e_p95_s        request completion minus arrival

Usage (on the card; ``--tiny --device cpu`` runs toy widths on the CPU):

  python -m pqcache_tpu_torch.harness.serving --ctx 32768 --pool 8 \\
      --requests 16 --gen 64 [--stagger 0.2] [--policies pq_search]

Random weights from ``torch.Generator(device).manual_seed(0)`` at
Llama-3.1-8B widths (``--layers`` deep); ``--weight-int8`` quantizes them
on the device and frees the bf16 copy. Emits one JSON line per policy.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch


def _pct(vals, q):
    return float(np.percentile(np.asarray(vals, np.float64), q))


def summarize(timing: dict, wall_s: float) -> dict:
    """Aggregate a BatchEngine.run timing dict into percentile metrics."""
    ttft, wait, e2e, tbt = [], [], [], []
    n_tokens = 0
    for ev in timing.values():
        ttft.append(ev["first"] - ev["arrive"])
        wait.append(ev["admit"] - ev["arrive"])
        if "done" in ev:
            e2e.append(ev["done"] - ev["arrive"])
        tt = ev.get("token_times", [])
        n_tokens += len(tt)
        # chunk pacing: consecutive DISTINCT completion times bound a chunk;
        # per-token time = chunk wall time / tokens delivered in it
        prev_t, prev_i = tt[0] if tt else 0.0, 0
        for i in range(1, len(tt)):
            if tt[i] != prev_t:
                tbt.extend([(tt[i] - prev_t) / (i - prev_i)] * (i - prev_i))
                prev_t, prev_i = tt[i], i
    out = {
        "ttft_p50_s": round(_pct(ttft, 50), 4),
        "ttft_p95_s": round(_pct(ttft, 95), 4),
        "wait_p50_s": round(_pct(wait, 50), 4),
        "wait_p95_s": round(_pct(wait, 95), 4),
        "e2e_p95_s": round(_pct(e2e, 95), 4) if e2e else None,
        "agg_tok_s": round(n_tokens / wall_s, 2),
    }
    if tbt:
        out["tbt_p50_ms"] = round(_pct(tbt, 50) * 1e3, 3)
        out["tbt_p95_ms"] = round(_pct(tbt, 95) * 1e3, 3)
    return out


def build_params(model, weight_int8: bool, device) -> dict:
    """Random weights (seed 0) on ``device``; with ``weight_int8`` the
    weight-only int8 tree, quantized there, the float copy freed."""
    from pqcache_tpu_torch.core import quant
    from pqcache_tpu_torch.models import llama
    params = llama.init_params(
        model, torch.Generator(device=device).manual_seed(0),
        dtype=torch.bfloat16, device=device)
    if weight_int8:
        params = quant.quantize_weight_tree(params)
    return params


def free_device_memory(device) -> None:
    """Drop what the caller released, and the allocator's cache on cuda."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(args) -> list[dict]:
    from pqcache_tpu_torch import resolve_device
    from pqcache_tpu_torch.bench import bench_model
    from pqcache_tpu_torch.config import (BudgetConfig, CacheConfig,
                                          EngineConfig, PQConfig,
                                          RuntimeConfig, tiny_model_config)
    from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
    from pqcache_tpu_torch.runtime.generate import Engine

    device = resolve_device(args.device)
    if args.tiny:
        # toy widths: the whole serving path (prefix capture, admission
        # waves, percentile summary) on the CPU
        model = tiny_model_config(max_position_embeddings=args.ctx + 2048)
    else:
        model = bench_model(args.layers)          # Llama-3.1-8B widths
    params = build_params(model, args.weight_int8, device)
    rng = np.random.default_rng(0)
    if args.mixed_prompts:
        lens = rng.integers(args.ctx // 4, args.ctx + 1,
                            size=args.requests)
    else:
        lens = np.full((args.requests,), args.ctx)
    prompts = [rng.integers(0, model.vocab_size, size=int(n))
               .astype(np.int64) for n in lens]
    arrivals = {i: i * args.stagger for i in range(args.requests)}

    rows = []
    # the shared prefix's K/V are policy-independent: captured once, the
    # same prefix tokens for every policy row
    prefix = None
    if args.prefix_len:
        pre_ids = rng.integers(0, model.vocab_size,
                               size=args.prefix_len).astype(np.int64)
        cap_cfg = EngineConfig(
            model=model,
            runtime=RuntimeConfig(policy="original", prefill_bucket=1024,
                                  max_new_tokens=args.gen,
                                  max_seq_len=args.ctx + 2048))
        prefix = Engine(cap_cfg, params, device=device).prefill_prefix(
            pre_ids)
        prompts = [p[: args.ctx - args.prefix_len] for p in prompts]
    for policy in args.policies:
        cfg = EngineConfig(
            model=model,
            pq=PQConfig(n_subvec_per_head=2, n_subbits=6, kmeans_iters=6,
                        select_block=args.select_block,
                        fetch_par=args.fetch_par),
            cache=CacheConfig(
                kv_dtype=(args.kv_dtype if policy == "pq_search"
                          else "bf16")),
            budget=BudgetConfig(compress_ratio=args.compress,
                                recent_ratio=0.5, sink_size=32),
            runtime=RuntimeConfig(policy=policy, prefill_bucket=1024,
                                  max_new_tokens=args.gen,
                                  max_seq_len=args.ctx + 2048,
                                  prefill_chunk=args.prefill_chunk),
        )
        eng = BatchEngine(cfg, params, batch_size=args.pool,
                          prefill_len=args.ctx, max_new_tokens=args.gen,
                          prefix=prefix, interleave=args.interleave,
                          device=device)
        # warm-up: builds the kernels and captures the decode step
        eng.run([(10_000, prompts[0])], chunk=args.chunk)

        timing: dict = {}
        t0 = time.perf_counter()
        res = eng.run(list(enumerate(prompts)), chunk=args.chunk,
                      arrivals=arrivals, timing=timing,
                      admission=args.admission)
        wall = time.perf_counter() - t0
        assert set(res) == set(range(args.requests))

        row = {"policy": policy, "ctx": args.ctx, "pool": args.pool,
               "requests": args.requests, "gen": args.gen,
               "chunk": args.chunk, "stagger_s": args.stagger,
               "prefix_len": args.prefix_len,
               "interleave": eng.interleave,
               "admission": args.admission,
               "weight_int8": args.weight_int8,
               "kv_dtype": cfg.cache.kv_dtype,
               "wall_s": round(wall, 3), **summarize(timing, wall)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del eng
        free_device_memory(device)
    return rows


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ctx", type=int, default=32768)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--pool", type=int, default=8, help="slot-pool size B")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--gen", type=int, default=64)
    p.add_argument("--chunk", type=int, default=16,
                   help="decode chunk (bounds admission latency)")
    p.add_argument("--stagger", type=float, default=0.0,
                   help="seconds between request arrivals (0 = burst)")
    p.add_argument("--admission", default="fifo", choices=["fifo", "spf"],
                   help="queue discipline among arrived requests: fifo, "
                        "or spf (shortest prompt first)")
    p.add_argument("--mixed-prompts", dest="mixed_prompts",
                   action="store_true",
                   help="draw prompt lengths uniformly from [ctx/4, ctx] "
                        "instead of all-equal")
    p.add_argument("--prefix-len", dest="prefix_len", type=int, default=0,
                   help="shared system-prompt prefix length (prefilled "
                        "once, reused by every request; 0 = off)")
    p.add_argument("--prefill-chunk", dest="prefill_chunk", type=int,
                   default=8192,
                   help="admission prefill slab (0 = unchunked); ignored "
                        "with --prefix-len, whose admissions prefill only "
                        "the suffix")
    p.add_argument("--compress", type=float, default=0.2)
    p.add_argument("--kv-dtype", dest="kv_dtype", default="bf16",
                   choices=["bf16", "int8"],
                   help="pq_search tail dtype (int8 halves the pool state)")
    p.add_argument("--interleave", default="auto",
                   choices=["auto", "on", "off"],
                   help="admission interleaving: 'auto' = on for chunked "
                        "non-prefix configs that fit; 'off' = monolithic "
                        "layer-major admission")
    p.add_argument("--select-block", type=int, default=256)
    p.add_argument("--fetch-par", type=int, default=16)
    p.add_argument("--policies", nargs="*",
                   default=["pq_search", "original"])
    p.add_argument("--weight-int8", dest="weight_int8",
                   action="store_true",
                   help="weight-only int8 (quantize_weight_tree, on the "
                        "device): decode products through the W8 kernel")
    p.add_argument("--tiny", action="store_true",
                   help="toy model widths (with --device cpu: a CPU smoke "
                        "run of the harness)")
    p.add_argument("--device", default=None,
                   help="cuda unless given (cpu for the tests)")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
