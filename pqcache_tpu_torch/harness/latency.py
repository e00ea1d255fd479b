"""Latency harness: TTFT, TT2T and steady per-token decode across context
lengths, one sequence at a time through ``runtime/generate.Engine``.

Counterpart of ``pqcache_tpu/harness/latency.py`` (the reference's
test_latency.py:74-141 protocol): per (ctx, policy), after warm-up
requests, TTFT is the prefill of a 1-token request, TT2T the decode time
of a 2-token request, and the per-token time the decode time of a
30-token request over its 29 decode steps.

Each policy is an arm with its own weights: with ``--weight-int8`` the pq
arm streams weight-only int8, the dense baseline keeps bf16. An arm's
weights are built on the device when the arm starts and freed before the
next arm builds its own, so one weight tree is resident at a time.

Usage: python -m pqcache_tpu_torch.harness.latency [--ctx 4096 8192 ...]
(on the card; ``--device cpu`` with a small ``--tiny`` model for the
tests). Emits one JSON line per (ctx, policy).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from pqcache_tpu_torch.bench import bench_model
from pqcache_tpu_torch.harness.serving import (build_params,
                                               free_device_memory)


def run(args) -> list[dict]:
    from pqcache_tpu_torch import resolve_device
    from pqcache_tpu_torch.config import (BudgetConfig, CacheConfig,
                                          EngineConfig, PQConfig,
                                          RuntimeConfig, tiny_model_config)
    from pqcache_tpu_torch.runtime.generate import Engine

    device = resolve_device(args.device)
    model = (tiny_model_config(max_position_embeddings=max(args.ctx) + 2048)
             if args.tiny else bench_model(args.layers))
    rng = np.random.default_rng(0)

    rows = []
    for policy in args.policies:
        w8 = bool(args.weight_int8 and policy != "original")
        params = build_params(model, w8, device)
        for ctx in args.ctx:
            cfg = EngineConfig(
                model=model,
                pq=PQConfig(n_subvec_per_head=2, n_subbits=6, kmeans_iters=6,
                            select_block=args.select_block),
                budget=BudgetConfig(compress_ratio=args.compress,
                                    recent_ratio=0.5, sink_size=32),
                cache=CacheConfig(
                    kv_dtype=(args.kv_dtype if policy != "original"
                              else "bf16")),
                runtime=RuntimeConfig(policy=policy, prefill_bucket=1024,
                                      max_new_tokens=32,
                                      max_seq_len=max(args.ctx) + 2048,
                                      prefill_chunk=args.prefill_chunk),
            )
            eng = Engine(cfg, params, device=device)
            ids = rng.integers(0, model.vocab_size, size=ctx).astype(np.int64)

            # warm-up: builds the kernels, both decode chunk lengths
            eng.generate(ids, max_new_tokens=2)
            eng.generate(ids, max_new_tokens=30)
            ttft = eng.generate(ids, max_new_tokens=1).prefill_seconds
            tt2t = eng.generate(ids, max_new_tokens=2).decode_seconds
            r30 = eng.generate(ids, max_new_tokens=30)
            per_token = r30.decode_seconds / max(len(r30.tokens) - 1, 1)
            row = {"policy": policy, "ctx": ctx, "ttft_s": round(ttft, 4),
                   "tt2t_s": round(tt2t, 4),
                   "per_token_ms": round(per_token * 1e3, 3),
                   "decode_tok_s": round(1.0 / per_token, 2),
                   "kv_dtype": cfg.cache.kv_dtype,
                   "select_block": args.select_block,
                   "weight_int8": w8}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del eng
        del params
        free_device_memory(device)
    return rows


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ctx", type=int, nargs="*",
                   default=[4096, 8192, 16384, 24576])
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--compress", type=float, default=0.2)
    p.add_argument("--select-block", type=int, default=1,
                   help="retrieval granularity (1 = per-token top-k with "
                        "K5; 256 = the block path with K1)")
    p.add_argument("--policies", nargs="*",
                   default=["pq_search", "original"])
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked (activation-bounded) prefill slab; "
                        "0 = full-length")
    p.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                   help="pq tail dtype (the baseline stays bf16)")
    p.add_argument("--weight-int8", dest="weight_int8",
                   action="store_true",
                   help="weight-only int8 for the pq arm; the dense "
                        "baseline keeps bf16 weights")
    p.add_argument("--tiny", action="store_true",
                   help="toy model widths (a CPU smoke run)")
    p.add_argument("--device", default=None,
                   help="cuda unless given (cpu for the tests)")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
