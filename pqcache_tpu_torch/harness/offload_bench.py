"""Host-offload tier benchmark: step time, hit rate, the step's wall time
split into host work and device wait, and the tier's transfers.

Counterpart of ``pqcache_tpu/harness/offload_bench.py``: the offload engine
(KV in pinned host memory, a device block cache, the native LFU) against
the device-resident engine at the same configuration, the analog of the
reference's latency split for its CPU-offload hierarchy (test_latency.py,
global_timer's pq / non-pq / transfer parts). The decode's own retrieval
gives the block reuse the LFU exploits (consecutive queries of a sequence
select overlapping blocks).

    python -m pqcache_tpu_torch.harness.offload_bench

Prints one JSON line. Environment, as the JAX bench reads it: CTX (32768),
LAYERS (8), GEN (24), CACHE_TOKENS (8192), BLOCK (128), PREFILL_CHUNK (0:
one pass), SKIP_HBM (1: no device-tier arm, for contexts it cannot hold),
KV_INT8 (1: int8 store), BATCH (> 1: ``BatchOffloadEngine``), REQUESTS (>
BATCH with BATCH > 1: continuous ``serve``), STALE (1: one-step-stale
selection). Besides the JAX bench's keys it prints the staged bytes per
step, the H2D (staging) and D2H (prefill and tail writes) rates over the
copies' device time, the pinned bytes, the pinned allocation's seconds
and whether the LFU is the native library (``lfu_native``).
``wait_s`` is the host blocked on the card (the block ids of each layer in
exact mode, one pull a step in stale mode); ``host_s`` the classify, LFU
and staging work. DEVICE (cuda) and TINY (1: a toy model) run it on the
CPU.

Model: Llama-3.1-8B widths (hidden 4096, 32 / 8 heads, head_dim 128, vocab
128256) at LAYERS layers, random bf16 weights from seed 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from pqcache_tpu_torch import config
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.runtime.generate import Engine
from pqcache_tpu_torch.runtime.offload_batch import BatchOffloadEngine
from pqcache_tpu_torch.runtime.offload_engine import OffloadEngine


def settings(env=None) -> dict:
    env = os.environ if env is None else env
    return dict(
        ctx=int(env.get("CTX", "32768")), layers=int(env.get("LAYERS", "8")),
        gen=int(env.get("GEN", "24")),
        cache_tokens=int(env.get("CACHE_TOKENS", "8192")),
        block=int(env.get("BLOCK", "128")),
        prefill_chunk=int(env.get("PREFILL_CHUNK", "0")),
        skip_hbm=env.get("SKIP_HBM", "0") == "1",
        kv="int8" if env.get("KV_INT8", "0") == "1" else "bf16",
        batch=int(env.get("BATCH", "1")),
        requests=int(env.get("REQUESTS", "0")),
        stale=env.get("STALE", "0") == "1",
        device=env.get("DEVICE", "cuda"), tiny=env.get("TINY", "0") == "1")


def bench_config(s: dict) -> config.EngineConfig:
    """The JAX bench's configuration: PQ 2 subvectors x 6 bits, 6 k-means
    iterations; budget 0.2 / 0.5 / sink 32; top 64 blocks admitted a step."""
    if s["tiny"]:
        model = config.tiny_model_config(num_layers=s["layers"])
    else:
        model = config.ModelConfig(
            name=f"off{s['layers']}L", vocab_size=128256, hidden_size=4096,
            intermediate_size=14336, num_layers=s["layers"], num_heads=32,
            num_kv_heads=8, head_dim=128, rope_theta=500000.0,
            rope_scaling_factor=8.0, max_position_embeddings=131072)
    return config.EngineConfig(
        model=model,
        pq=config.PQConfig(n_subvec_per_head=2, n_subbits=6, kmeans_iters=6),
        budget=config.BudgetConfig(compress_ratio=0.2, recent_ratio=0.5,
                                   sink_size=32),
        cache=config.CacheConfig(
            offload=True, block_size=s["block"],
            hbm_cache_tokens=s["cache_tokens"], cache_topk_blocks=64,
            kv_dtype=s["kv"], stale_select=s["stale"]),
        runtime=config.RuntimeConfig(
            policy="pq_search", prefill_bucket=1024,
            max_new_tokens=s["gen"] + 2, max_seq_len=s["ctx"] + 2048,
            prefill_chunk=s["prefill_chunk"]))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def transfer_keys(store, steps: int) -> dict:
    """The store's transfer figures for the JSON line."""
    t = store.transfer_stats()
    rate = lambda b, s: (round(b / s / 1e9, 3) if s else None)  # noqa
    return dict(
        staged_bytes_per_step=round(t["h2d_bytes"] / max(steps, 1)),
        h2d_copies=t["h2d_copies"], h2d_gb_s=rate(t["h2d_bytes"],
                                                   t["h2d_s"]),
        d2h_bytes=t["d2h_bytes"], d2h_gb_s=rate(t["d2h_bytes"], t["d2h_s"]),
        pinned_bytes=t["pinned_bytes"],
        pinned_alloc_s=round(t["alloc_s"], 4),
        lfu_native=all(c.native for c in store.lfu))


def run(s: dict) -> dict:
    dev = torch.device(s["device"])
    cfg = bench_config(s)
    model = cfg.model
    params = llama.init_params(
        model, torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev)
    ids = np.random.default_rng(0).integers(0, model.vocab_size,
                                            size=s["ctx"])
    CTX, LAYERS, GEN, B = s["ctx"], s["layers"], s["gen"], s["batch"]
    common = {"cache_tokens": s["cache_tokens"], "block": s["block"],
              "kv_dtype": s["kv"], "stale": s["stale"],
              "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu")}

    hbm_ms = None
    if not s["skip_hbm"]:
        cfg_hbm = dataclasses.replace(
            cfg, cache=dataclasses.replace(cfg.cache, offload=False))
        hbm = Engine(cfg_hbm, params, device=dev)
        hbm.generate(ids, GEN)                          # warm-up
        r = hbm.generate(ids, GEN)
        hbm_ms = r.decode_seconds / max(len(r.tokens) - 1, 1) * 1e3
        del hbm, r
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    if B > 1 and s["requests"] > B:
        be = BatchOffloadEngine(cfg, params, batch_size=B, device=dev)
        reqs = [(i, ids) for i in range(s["requests"])]
        be.serve(reqs[:B], max_new_tokens=GEN)          # warm-up
        timing: dict = {}
        _sync(dev)
        t0 = time.perf_counter()
        outs = be.serve(reqs, max_new_tokens=GEN, timing=timing)
        dt = time.perf_counter() - t0
        tm = be.timings
        steps = max(tm["steps"], 1)
        n_tok = sum(len(o) for o in outs.values())
        diffs = [np.diff(v["token_times"]) for v in timing.values()
                 if len(v.get("token_times", [])) > 1]
        tbt = np.concatenate(diffs) if diffs else np.zeros((0,))
        ttft = np.asarray([v["first"] - v["arrive"]
                           for v in timing.values()])
        pct = lambda a, p: (float(np.percentile(a, p)) if a.size  # noqa
                            else None)
        return dict({
            "metric": (f"continuous offload serving @ {CTX} ctx "
                       f"({LAYERS}L, pool={B}, requests={s['requests']})"),
            "per_step_ms": tm["decode_s"] / steps * 1e3,
            "agg_tok_s": n_tok / dt,
            "tbt_p50_ms": None if not tbt.size else pct(tbt, 50) * 1e3,
            "tbt_p95_ms": None if not tbt.size else pct(tbt, 95) * 1e3,
            "ttft_p50_s": pct(ttft, 50), "ttft_p95_s": pct(ttft, 95),
            "hit_rate": be.store.hit_rate,
            "host_ms_per_step": tm["host_s"] / steps * 1e3,
            "device_wait_ms_per_step": tm["wait_s"] / steps * 1e3,
            "batch": B, "requests": s["requests"], "tokens": n_tok,
            "total_s": dt}, **common, **transfer_keys(be.store, steps))
    if B > 1:
        be = BatchOffloadEngine(cfg, params, batch_size=B, device=dev)
        prompts = [ids] * B
        be.generate_batch(prompts, max_new_tokens=GEN)  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        outs = be.generate_batch(prompts, max_new_tokens=GEN)
        dt = time.perf_counter() - t0
        tm = be.timings
        steps = max(tm["steps"], 1)
        n_tok = sum(len(o) for o in outs)
        return dict({
            "metric": (f"batched offload-tier decode @ {CTX} ctx "
                       f"({LAYERS}L, B={B})"),
            "per_step_ms": tm["decode_s"] / steps * 1e3,
            "agg_tok_s": n_tok / dt, "hbm_tier_per_step_ms": hbm_ms,
            "hit_rate": be.store.hit_rate,
            "host_ms_per_step": tm["host_s"] / steps * 1e3,
            "device_wait_ms_per_step": tm["wait_s"] / steps * 1e3,
            "batch": B, "tokens": n_tok, "total_s": dt},
            **common, **transfer_keys(be.store, steps))
    off = OffloadEngine(cfg, params, device=dev)
    off.generate(ids, GEN)                              # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    toks = off.generate(ids, GEN)
    dt = time.perf_counter() - t0
    tm = off.timings
    steps = max(tm["steps"], 1)
    return dict({
        "metric": f"offload-tier decode @ {CTX} ctx ({LAYERS}L)",
        "per_step_ms": tm["decode_s"] / steps * 1e3,
        "hbm_tier_per_step_ms": hbm_ms, "hit_rate": off.store.hit_rate,
        "host_ms_per_step": tm["host_s"] / steps * 1e3,
        "device_wait_ms_per_step": tm["wait_s"] / steps * 1e3,
        "tokens": len(toks), "total_s": dt},
        **common, **transfer_keys(off.store, steps))


def main(env=None) -> dict:
    line = run(settings(env))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
