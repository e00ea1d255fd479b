"""Quickest proof that the PyTorch port runs on an NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pqcache_tpu_torch/csrc``, holds each
(K1–K6) against its plain PyTorch version at the main path's shapes (K2
also on the serving path's admission slabs at q_offset and on the 128k
chunked prefill's slabs against 131072 keys), serves requests
through ``Engine.generate`` at Llama-3.1-8B width and 8 layers (random
weights from a seeded generator) on the block path (joint-histogram scorer + K1),
the per-token path (select_block 1: K5, and K6 with gather_mode "pallas"),
the fused block-scorer path (K3 + K1) and the score-reading policies h2o
("sum" and "max") and infllm (K2 + K4 at prefill), checks that each request
launched exactly the kernels of its path. The trace phase then splits a few
decode steps of five paths (block, per-token, K3, h2o, infllm) at 32000
tokens into pq / fetch / transfer / model device time with
``harness/trace.py`` (the JAX package's scopes around each launch; the
buckets must add up, every device event must join a host launch, fetch
time shows only on the block paths and pq time on no dense policy), with
their device time, launches and top kernels per step, and runs the trace
and profile_decode command lines at their defaults on the card. Then the
kernels are held against the plain versions end to end at reduced depth.
Then bench.py's batched protocol at 8 layers: one 32k prompt inserted
into B = 8 and B = 1 slots, pq_search (int8 tail, K1 with the local window), its per-token arm
(BENCH_PQ_BLOCK=1: K5 at 64 folded heads) and `original`, one chunk
decoded eagerly and replayed from a CUDA graph with identical tokens and
states, launches per step by stage, the replayed steps split into pq /
fetch / transfer / model (``trace.decompose_replayed``: each replayed
kernel takes the scope of the eager step's kernel at its index; every
replayed device event joined, the split's total the profile's device
time), device busy share, capture time and peak memory; K1 at the
batched shapes, K3 at B 8, and 2-layer batched kernels-vs-plain checks. The W8 kernel (weight-only int8 decode products)
is held against its plain version at every weight shape of the path and at
its two groups of one launch (q/k/v, gate/up) at M 1 and 8, each launch
timed by graph replay, and timed per batched step (4 launches a layer); the Engine also serves a W8 request, a
chunked-prefill request (K2 at q_offset) and a prefix request, held to the
one-pass requests' first-token logits; the batched phase adds bench.py's
default W8 arm. The serving phase drives ``BatchEngine`` under load
through ``harness/serving.py`` at its defaults (8 layers, 32k prompts,
pool 8, a burst of 16 requests, 64 new tokens, interleaved admission: K2
at q_offset, K1 replayed from the decode graph) for `pq_search`,
`original` and the W8 + int8-tail arm, with each row's launches, peak
memory and its split into admission slabs, tails and decode chunks; holds
interleaved admission to the monolithic one (identical token streams),
sampled decode replayed from the graph to eager decode from one seed, and
runs ``harness/latency.py`` at 32k (K5 on the pq arm). The offload
phase runs the host-offload tier at 8 layers: the device-tier Engine
(select_block 128) against ``OffloadEngine`` with a bf16 store, exact
selection, on a 32k prompt (first-token logits within LOGIT_TOL; fed the
twin's tokens, every step's logits within OFFLOAD_LOGIT_TOL, greedy tokens
equal on 80% of the steps, each parting at a near tie; hits; the same hold
must reject a planted fault, a wrong block assembled for each cache hit),
then an int8 store with stale
selection, ``BatchOffloadEngine`` at B 4 and serving 8 requests over 4
slots, and a 128k prompt (int8, stale, chunked prefill) through
``harness/offload_bench.py``, with K2 the only kernel of its prefills and
the native LFU built. The evaluation phase writes a 2-layer checkpoint at
Llama-3.1-8B widths with its own safetensors writer and loads it through
``models/loader.py`` (every tensor bit for bit; a block-path request's
first-token logits equal to those of the same params in memory), runs
six more 2-layer self-checks (pq_search with the ip metric on the block
path and per token, gqa=False and the masked fetch; no_drop_lb and
sparq_f), the LongBench command line at ``random:llama-3.1`` (32 layers)
on two ~8k-token synthetic passage_count samples for seven policies, a
resume that writes nothing and ``score``, and synth_quality (the copy
model trained on the card and held to its quality gate). The parallel
phase runs the tensor-, data- and sequence-parallel engines with ranks as
processes that share the card over gloo (``parallel/launch.py``): K1, K2
and K3 at a tp 2 shard's shapes against their plain versions;
``TPEngine`` tp 2 on a 32k prompt, ``generate_ring`` sp 2, the K3 and K5
decode arms, ``BatchTPEngine`` dp 2 x tp 2 over 4 slots and
``ShardedOffloadEngine`` tp 2, each held to its single-process twin
teacher-forced at budget 1.0, a planted fault that the same hold must
reject, and TPEngine's decode at budget 0.2 from the single process's
prefill state (bf16, and float32 on the plain route), with each rank's
launches, collectives (route, calls, bytes; host seconds in the one
timed run) and peak memory. The self-checks
hold greedy tokens at every step, teacher-forced, a parting allowed only
at a near tie, and count each route's launches. Then the port's
bench driver runs at bench.py's defaults (and at its 128k chunked-prefill
case when time allows) and prints its JSON line. The kernels line takes K1 and K5 at the batched shapes and W8
per batched step. Any failure exits non-zero. Without CUDA it exits 1 and
prints no result.

Output: the card's name and power limit, per-phase results, a
``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pqcache_tpu_torch import bench, config
from pqcache_tpu_torch.core import pq, quant
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.harness import profile_decode, trace
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.native import lfu_cache
from pqcache_tpu_torch.ops import _build, adc, block_attn, dispatch, w8
from pqcache_tpu_torch.ops.adc import (adc_block_scores, adc_block_scores_ref,
                                       adc_scores, adc_scores_ref)
from pqcache_tpu_torch.ops.attention_ref import (chunked_attention,
                                                 flash_scores_ref)
from pqcache_tpu_torch.ops.block_attn import (block_topk_attention,
                                              block_topk_attention_ref)
from pqcache_tpu_torch.ops.flash_attention import flash_attention
from pqcache_tpu_torch.ops.flash_scores import flash_scores
from pqcache_tpu_torch.ops.gather import gather_rows, gather_rows_ref
from pqcache_tpu_torch.parallel import workers
from pqcache_tpu_torch.policies import h2o, infllm
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime import offload_engine
from pqcache_tpu_torch.runtime.generate import (Engine, bucket_length,
                                                params_to)
from pqcache_tpu_torch.runtime.offload_engine import OffloadEngine
from pqcache_tpu_torch.runtime.state import per_head

# published H100 SXM peaks (dense): bf16 tensor cores, f32 outside them, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

SEED = 0
# depth of the Engine request phase: cut from Llama-3.1-8B's 32 to
# bench.py's 8 to make room for the serving phase in the script's time
LAYERS = 8
NEW_TOKENS = 32
# The engines of the main path: policy (pq_search unless named), kv tail
# dtype, PQConfig overrides, score_func. "block" is the joint-histogram
# scorer + K1; "token" the per-token path (select_block 1, the default
# PQConfig) with K5, "token-pallas" adds K6; "k3" the fused ADC block scorer
# + K1 (select_block 512 would need a tail that is a multiple of 512, and
# 33024 is not); h2o and infllm read K4's scores at prefill. "block-w8" is
# bench.py's pq arm (weight-only int8 through the W8 kernel, an int8 tail);
# "chunked" prefills in chunks of 8192 (K2 at q_offset).
ENGINES = {
    "block-bf16": dict(kv="bf16", pq=dict(select_block=256)),
    "block-int8": dict(kv="int8", pq=dict(select_block=256)),
    "token": dict(kv="bf16", pq=dict(select_block=1, adc_mode="v2")),
    "token-pallas": dict(kv="int8", pq=dict(select_block=1, adc_mode="v1",
                                            gather_mode="pallas")),
    "k3": dict(kv="bf16", pq=dict(select_block=256, scorer="kernel")),
    "h2o-sum": dict(policy="h2o", score_func="sum"),
    "h2o-max": dict(policy="h2o", score_func="max"),
    "infllm": dict(policy="infllm"),
    "block-w8": dict(kv="int8", pq=dict(select_block=256), w8=True),
    "chunked": dict(kv="bf16", pq=dict(select_block=256),
                    prefill_chunk=8192),
    # the evaluation path's branches (the evaluation phase's self-checks):
    # the ip metric on the block path (K5, then K1) and per token (K5),
    # per-q-head retrieval (gqa=False) and the masked fetch (K5), and the
    # oracle and SparQ baselines (K2 at prefill)
    "ip-block": dict(kv="bf16", pq=dict(select_block=256, metric="ip")),
    "ip-token": dict(kv="bf16", pq=dict(select_block=1, metric="ip")),
    "nogqa": dict(kv="bf16", pq=dict(select_block=1), gqa=False),
    "masked": dict(kv="bf16", pq=dict(select_block=1, fetch_mode="masked")),
    "no_drop_lb": dict(policy="no_drop_lb"),
    "sparq_f": dict(policy="sparq_f"),
}
SCORE_POLICIES = ("h2o", "infllm")
# (prompt tokens, engine): the 100-token request is short enough that the
# engine falls back to the dense `original` policy
REQUESTS = [(2000, "block-bf16"), (16000, "block-int8"),
            (32000, "block-bf16"), (100, "block-bf16"),
            (32000, "token"), (16000, "token-pallas"), (32000, "k3"),
            (32000, "h2o-sum"), (16000, "h2o-max"), (32000, "infllm")]
# the prefill family on the prompt of the (32000, "block-bf16") request:
# "block-w8" and "chunked" (four chunks, K2 at q_offset 0, 8192, 16384 and
# 24576; first-token logits within LOGIT_TOL of the one-pass request's);
# then a prefix request, a PREFIX-token prefill_prefix continued by a
# SUFFIX-token suffix, held to LOGIT_TOL of the one-shot request of the
# joined prompt (both bucket to 32768: the same budget)
PREFIX, SUFFIX = 16384, 16000
# K2 is held row by row: ||out - ref|| / ||ref|| of each query row. Rounding
# P to bf16 for PV and the output to bf16 costs a few 1e-3 there at any
# depth, while a key tile of 64 dropped from a row that sees n keys moves it
# by about sqrt(64 / n): 4.5% at n = 32k. An absolute limit would not see
# that: the deep rows' entries are ~0.01.
K2_TOL = 1e-2
# the serving path's interleaved admission: slabs of SLAB rows; K2 is held
# at the first and the deepest slab of a 32k prompt
SLAB, SLAB_OFFSETS = 8192, (0, 24576)
# the offload tier's 128k chunked prefill: slabs of LONG_SLAB query rows
# against LONG_T keys (no pad); K2 is held at the first and the deepest
LONG_T, LONG_SLAB, LONG_OFFSETS = 131072, 32768, (0, 98304)
K1_TOL = 1e-4     # float32 both sides, relative to the largest |entry|
# K3 sums exp terms per block, then rescales, where its plain version takes
# one softmax: float32 summation order, relative to each row's largest entry
K3_TOL = 1e-5
# K4 sums the logits on bf16 tensor cores in another order and uses the
# fast exp: |F - F_ref| relative to each head's largest entry. Dropping one
# q tile of 64 rows from a key's column moves it by far more (PERF.md)
K4_TOL = 1e-4
# K2's row statistics: |m - m_ref| and |l / l_ref - 1| on rows that see a
# key; the same f32 logits summed in another order, base-2 exponentials
STATS_TOL = 1e-4
# main-path decode shapes at 32k (budget 0.2 / recent 0.5 / sink 32)
N_TAIL, N_CAND, TOPK = 33024, 25570, 3273
SELF_LAYERS = 2   # depth of the kernels-vs-plain end-to-end check
SELF_COMPRESS = 1.0   # its budget: top-k selects every candidate
SELF_TOKENS = 16
# |logit| difference, kernels vs plain: the logits are the bf16 lm-head
# output, whose ulp is 0.03125 for |logit| in [4, 8): 4 ulps there
LOGIT_TOL = 0.125
# W8 against its plain version: the same exact bf16 products (int8 is exact
# in bf16) summed in another f32 order, rounded at the same points, so an
# entry near a bf16 rounding boundary lands one bf16 unit (2^-8 relative)
# apart, and the scale's rounding another: |y - ref| relative to the
# largest |ref|
W8_TOL = 2e-2
# the weight products at Llama-3.1-8B width: (K, N of each product of one
# launch). A decode step launches per layer the q/k/v group, wo, the
# gate/up group and down (W8_STEP), then the LM head: 4 L + 1 launches
W8_SHAPES = {"wq/wo": (4096, (4096,)), "wk/wv": (4096, (1024,)),
             "gate/up": (4096, (14336,)), "down": (14336, (4096,)),
             "q/k/v group": (4096, (4096, 1024, 1024)),
             "gate/up group": (4096, (14336, 14336))}
W8_STEP = ("q/k/v group", "wq/wo", "gate/up group", "down")
W8_HEAD = (4096, 128256)


def log(*a):
    print(*a, flush=True)


# the Chrome traces of the trace phase and the batched splits: one
# temporary directory for the run, removed at its end (main)
_TRACES = None


def _trace_dir(label: str) -> str:
    return os.path.join(_TRACES.name, label)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn() with the host taken out: `iters` calls
    captured in one CUDA graph, replayed and timed with CUDA events. For
    kernels of a few microseconds, whose per-call timing would measure the
    Python that launches them."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up's stream: the W8 kernel's scratch is per
    # stream, made at a stream's first eager call
    with torch.cuda.graph(graph, stream=s):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (5 * iters)


def row_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest ||out - ref|| / ||ref|| over rows of the last axis. A row
    whose reference is all zero (a left-pad row, which sees no key) must
    come out exactly zero: it then counts 0, else inf."""
    err = (out.float() - ref.float()).norm(dim=-1)
    nrm = ref.float().norm(dim=-1)
    rel = torch.where(nrm > 0, err / nrm.clamp(min=1e-30),
                      torch.where(err > 0, float("inf"), 0.0))
    return rel.max().item()


@functools.lru_cache(maxsize=1)
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def environment() -> None:
    log(card())
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc '{nvcc[-1]}' "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    _build.build_all(verbose=True)
    log(f"kernel build {_build.build_seconds:.1f} s")
    # the offload tier's native LFU (g++ at first use), built before any
    # request is timed; the offload phase fails unless it is native
    t = time.perf_counter()
    native = lfu_cache.LFUCache(1).native
    log(f"native LFU build {time.perf_counter() - t:.1f} s: native {native}"
        + ("" if native else f" ({lfu_cache.build_error})"))


# ---------------------------------------------------------------------------
# K2 against its plain version

def _qkv(dev, g, L: int, T: int):
    """L layers of bf16 q [32, T, 128], k and v [8, T, 128] at Llama-3.1-8B
    widths."""
    m = config.LLAMA31_8B
    return [torch.randn((L, h, T, m.head_dim), generator=g,
                        device=dev).bfloat16()
            for h in (m.num_heads, m.num_kv_heads, m.num_kv_heads)]


def _stats_err(got, ref) -> tuple[float, float, bool]:
    """K2's row statistics against chunked_attention(return_stats=True):
    the largest |m - m_ref| and |l / l_ref - 1| over rows that see a key,
    and whether every other row is exactly (-1e30, 0)."""
    (m, l), (m_ref, l_ref) = got, ref
    seen = l_ref > 0
    none_ok = bool((m[~seen] == -1e30).all() and (l[~seen] == 0).all())
    return ((m - m_ref)[seen].abs().max().item(),
            (l / l_ref - 1)[seen].abs().max().item(), none_ok)


def k2_phase(dev) -> dict:
    """K2 held row by row against its plain version at T 2048 (pad 48), at
    T 2100 (pad 77: ragged against the 128-row tiles) and at the main
    prefill shape T 32768 (pad 768), with and without its row statistics,
    which are held against chunked_attention(return_stats=True), and at
    32768 on the serving path's admission slabs (8192 rows at q_offset 0
    and 24576, SLAB_OFFSETS), then on the 128k chunked prefill's slabs
    (k2_long_slabs). At 32768
    the device time comes from CUDA-graph replay cycling over 2 layers of
    inputs (768 MB, far above the 50 MB L2). The library yardstick is one
    SDPA call with is_causal on the valid slice [pad:] with GQA-expanded K/V
    (pad rows see no key and are 0; valid rows see only keys >= pad), which
    takes the flash backend; the boolean-mask SDPA of earlier PRs (the
    memory-efficient backend) is printed beside it."""
    m = config.LLAMA31_8B
    H, H_kv, D = m.num_heads, m.num_kv_heads, m.head_dim
    g = torch.Generator(device=dev).manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry = None
    for T, pad in ((2048, 48), (2100, 77), (32768, 768)):
        L = 2 if T == 32768 else 1
        q, k, v = _qkv(dev, g, L, T)
        out, ms_, ls_ = flash_attention(q[0], k[0], v[0], valid_lo=pad,
                                        return_stats=True)
        alone = flash_attention(q[0], k[0], v[0], valid_lo=pad)
        torch.cuda.synchronize()
        ref, m_ref, l_ref = chunked_attention(q[0], k[0], v[0], valid_lo=pad,
                                              return_stats=True)
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(out, ref)
        deep = row_rel_err(out[:, T // 2:], ref[:, T // 2:])
        finite = bool(torch.isfinite(out).all())
        m_err, l_err, none_ok = _stats_err((ms_, ls_), (m_ref, l_ref))
        same = torch.equal(out, alone)
        log(f"K2 T={T} pad={pad}: max_abs_err {err:.3e}, worst row "
            f"||err||/||ref|| {rel:.3e} (tol {K2_TOL}), over the rows "
            f"past T/2 {deep:.3e}; finite {finite}; row stats |m err| "
            f"{m_err:.3e} (tol {STATS_TOL}), |l/l_ref - 1| {l_err:.3e} (tol "
            f"{STATS_TOL}), rows that see no key (-1e30, 0): {none_ok}; "
            f"output with stats identical to without: {same}")
        if (not finite or not rel <= K2_TOL or not m_err <= STATS_TOL
                or not l_err <= STATS_TOL or not none_ok or not same):
            raise SystemExit(f"K2 disagrees with its plain version at T={T}")
        if T < 32768:
            continue
        # the serving path's admission slab: SLAB query rows at q_offset c0
        # against the whole admission buffer (keys past the slab masked by
        # causality), as prefill_chunk_step gives K2
        for c0 in SLAB_OFFSETS:
            qs = q[0][:, c0:c0 + SLAB].contiguous()
            got = flash_attention(qs, k[0], v[0], valid_lo=pad, q_offset=c0)
            torch.cuda.synchronize()
            want = chunked_attention(qs, k[0], v[0], valid_lo=pad,
                                     q_offset=c0)
            s_rel = row_rel_err(got, want)
            s_fin = bool(torch.isfinite(got).all())
            log(f"K2 slab q [{H}, {SLAB}, {D}] at q_offset {c0}, keys T={T} "
                f"pad={pad}: max_abs_err "
                f"{(got.float() - want.float()).abs().max().item():.3e}, "
                f"worst row ||err||/||ref|| {s_rel:.3e} (tol {K2_TOL}); "
                f"finite {s_fin}")
            if not s_fin or not s_rel <= K2_TOL:
                raise SystemExit(f"K2 disagrees with its plain version on "
                                 f"the slab at q_offset {c0}")
            del qs, got, want
        layer = iter(range(10 ** 9))

        def call(stats=False):
            i = next(layer) % L
            return flash_attention(q[i], k[i], v[i], valid_lo=pad,
                                   return_stats=stats)
        ms = graph_ms(call, 2 * L)
        stats_ms = graph_ms(lambda: call(True), 2 * L)
        call_ms = cuda_ms(call, 3, warmup=1)
        plain_ms = cuda_ms(lambda: chunked_attention(q[1], k[1], v[1],
                                                     valid_lo=pad), 1,
                           warmup=0)
        n = T - pad                                    # valid rows and keys
        ops = 4.0 * H * D * n * (n + 1) / 2            # QK^T and PV, causal
        nbytes = 2 * (2 * H * T * D + 2 * H_kv * T * D)
        bound_ms = max(ops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
        # one PyTorch call for the same function (yardstick only)
        qv = q[:, :, pad:].contiguous()
        kr, vr = (x[:, :, pad:].repeat_interleave(H // H_kv, 1).contiguous()
                  for x in (k, v))

        def lib(i=None):
            i = next(layer) % L if i is None else i
            return sdpa(qv[i][None], kr[i][None], vr[i][None],
                        is_causal=True)[0]
        lib_rel = row_rel_err(out[:, pad:], lib(0))
        lib_ms = cuda_ms(lib, 4)
        del qv, kr, vr
        kpos = torch.arange(T, device=dev)
        mask = (kpos[None, :] <= kpos[:, None]) & (kpos[None, :] >= pad)
        kr, vr = (x[1].repeat_interleave(H // H_kv, 0) for x in (k, v))
        mask_ms = cuda_ms(lambda: sdpa(q[1][None], kr[None], vr[None],
                                       attn_mask=mask), 2)
        log(f"K2 T={T}: kernel {ms:.3f} ms of device time "
            f"({ops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of its "
            f"bound), {stats_ms:.3f} ms with the row statistics, "
            f"{call_ms:.3f} ms per call from Python; plain {plain_ms:.1f} "
            f"ms; SDPA is_causal on the valid slice {lib_ms:.3f} ms (worst "
            f"row against the kernel {lib_rel:.3e}); SDPA with a boolean "
            f"mask {mask_ms:.3f} ms; bound {bound_ms:.3f} ms (operations)")
        entry = dict(name="flash_attention", route="cuda",
                     source="pqcache_tpu_torch/csrc/flash_attention.cu",
                     replaces="pqcache_tpu/ops/flash_attention.py:167",
                     max_abs_err=err, max_row_rel_err=rel, ms=ms,
                     call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by="operations", library_ms=lib_ms)
        del q, k, v, out, ref, mask, kr, vr
    k2_long_slabs(dev, g)
    return entry


def k2_long_slabs(dev, g) -> None:
    """K2 row by row against its plain version on the 128k chunked
    prefill's slabs (the offload tier's long-context regime): LONG_SLAB
    query rows at each of LONG_OFFSETS against LONG_T keys, pad 0, as
    llama.attn_mlp_chunk gives K2."""
    m = config.LLAMA31_8B
    H, D = m.num_heads, m.head_dim
    _, k, v = _qkv(dev, g, 1, LONG_T)
    for c0 in LONG_OFFSETS:
        qs = torch.randn((H, LONG_SLAB, D), generator=g,
                         device=dev).bfloat16()
        got = flash_attention(qs, k[0], v[0], valid_lo=0, q_offset=c0)
        torch.cuda.synchronize()
        want = chunked_attention(qs, k[0], v[0], valid_lo=0, q_offset=c0)
        s_rel = row_rel_err(got, want)
        s_fin = bool(torch.isfinite(got).all())
        log(f"K2 slab q [{H}, {LONG_SLAB}, {D}] at q_offset {c0}, keys "
            f"T={LONG_T} pad=0: max_abs_err "
            f"{(got.float() - want.float()).abs().max().item():.3e}, worst "
            f"row ||err||/||ref|| {s_rel:.3e} (tol {K2_TOL}); finite {s_fin}")
        if not s_fin or not s_rel <= K2_TOL:
            raise SystemExit(f"K2 disagrees with its plain version on the "
                             f"{LONG_T}-key slab at q_offset {c0}")
        del qs, got, want


def head_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |out - ref| over each row of the last axis, relative to that
    row's largest |ref| (F of one head)."""
    return ((out - ref).abs().amax(-1)
            / ref.abs().amax(-1).clamp(min=1e-30)).max().item()


# ---------------------------------------------------------------------------
# K4 against its plain version

def k4_phase(dev) -> dict:
    """K4 at the main prefill shapes: q [32, 32768, 128], k [8, 32768, 128]
    bf16, pad 768 (32000 valid rows), "sum" and "max", in both forms: fed
    with K2's row statistics (the main path's form: the dispatcher runs K2
    with its statistics, then K4's column pass) and standalone (K2's
    stats-only sweep, then the column pass). Each is held per head at
    K4_TOL of the head's largest entry, pad columns exactly 0. Device time
    by CUDA-graph replay cycling over 2 layers of inputs (each call reads
    335 MB, far above the 50 MB L2). The kernels line reports the fed form
    against the bound of one causal sweep; the standalone form is printed
    against two sweeps, and the h2o / infllm prefill pair (K2 with its row
    statistics, then the fed K4) against the pair's bound."""
    m = config.LLAMA31_8B
    H, H_kv, D, T, pad, L = (m.num_heads, m.num_kv_heads, m.head_dim, 32768,
                             768, 2)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    q, k, v = _qkv(dev, g, L, T)
    stats = [flash_attention(q[i], k[i], v[i], valid_lo=pad,
                             return_stats=True)[1:] for i in range(L)]
    n = T - pad
    sweep = 2.0 * H * D * n * (n + 1) / 2    # one causal QK^T sweep
    exps = float(H) * n * (n + 1) / 2         # one exp per pair and sweep
    nbytes = 2 * (H + H_kv) * T * D + 3 * 4 * H * T   # q, k; m, l, F
    bound_ms = max(sweep / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    alone_bound = max(2 * sweep / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    pair_bound = max(3 * sweep / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    entry = None
    for mode in ("sum", "max"):
        layer = iter(range(10 ** 9))

        def call(fed=True, mode=mode):
            i = next(layer) % L
            return flash_scores(q[i], k[i], valid_lo=pad, score_mode=mode,
                                row_stats=stats[i] if fed else None)
        got = flash_scores(q[1], k[1], valid_lo=pad, score_mode=mode,
                           row_stats=stats[1])
        alone = flash_scores(q[1], k[1], valid_lo=pad, score_mode=mode)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        ref = flash_scores_ref(q[1], k[1], pad, score_mode=mode)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        err = (got - ref).abs().max().item()
        rel = head_rel_err(got, ref)
        rel_alone = head_rel_err(alone, ref)
        ok = all(bool(torch.isfinite(x).all() and (x[:, :pad] == 0).all())
                 for x in (got, alone))
        log(f"K4 {mode} T={T} pad={pad}: fed with K2's row statistics "
            f"max_abs_err {err:.3e}, largest |err| per head over its "
            f"largest entry {rel:.3e}; standalone {rel_alone:.3e} (tol "
            f"{K4_TOL}); finite, pad columns 0: {ok}")
        if not ok or not rel <= K4_TOL or not rel_alone <= K4_TOL:
            raise SystemExit(f"K4 ({mode}) disagrees with its plain version")
        ms = graph_ms(call, 2 * L)
        alone_ms = graph_ms(lambda: call(False), 2 * L)
        call_ms = cuda_ms(call, 3, warmup=1)
        log(f"K4 {mode}: fed {ms:.3f} ms of device time per call "
            f"({sweep / ms / 1e9:.1f} TFLOP/s of QK^T, {exps / ms / 1e9:.2f} "
            f"T exp/s, {bound_ms / ms:.1%} of its one-sweep bound "
            f"{bound_ms:.3f} ms), {call_ms:.3f} ms per call from Python; "
            f"standalone {alone_ms:.3f} ms ({alone_bound / alone_ms:.1%} of "
            f"its two-sweep bound {alone_bound:.3f} ms); plain "
            f"{plain_ms:.1f} ms; library call: none")
        if mode == "sum":
            def pair():
                i = next(layer) % L
                _, mi, li = flash_attention(q[i], k[i], v[i], valid_lo=pad,
                                            return_stats=True)
                return flash_scores(q[i], k[i], valid_lo=pad,
                                    row_stats=(mi, li))
            pair_ms = graph_ms(pair, 2 * L)
            log(f"h2o / infllm prefill pair (K2 with row statistics + fed "
                f"K4 \"sum\"): {pair_ms:.3f} ms of device time per layer, "
                f"bound {pair_bound:.3f} ms ({pair_bound / pair_ms:.1%})")
            entry = dict(name="flash_scores", route="cuda",
                         source="pqcache_tpu_torch/csrc/flash_scores.cu",
                         replaces="pqcache_tpu/ops/flash_attention.py:379",
                         max_abs_err=err, max_row_rel_err=rel, ms=ms,
                         call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by="operations",
                         library_ms=None)
        del got, alone, ref
    return entry


# ---------------------------------------------------------------------------
# K1 against its plain version

def k1_phase(dev) -> dict:
    """Main-path shapes at 32k: q [32, 1, 128], tail [L, 8, 33024, 256],
    13 selected 256-row blocks per kv head, the last valid block cut by
    n_cand. The timed launches cycle over 8 layers of the tail (110 MB of
    selected blocks per cycle, above the 50 MB L2), so blocks arrive cold as
    they do in decode. Times are device time from CUDA-graph replay; the
    per-call time from Python is printed beside it."""
    m = config.LLAMA31_8B
    H, H_kv, D, bs, nb_sel, L = m.num_heads, m.num_kv_heads, m.head_dim, 256, 13, 8
    N, n_cand = N_TAIL, N_CAND         # block 99 is cut at row 226 of 256
    rng = np.random.default_rng(SEED)
    blk_np = np.stack([np.sort(np.concatenate([
        [n_cand // bs], rng.choice(n_cand // bs, nb_sel - 1, replace=False)]))
        for _ in range(H_kv)])
    blk = torch.from_numpy(blk_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    entry = None
    for kv_dtype in ("int8", "bf16"):
        if kv_dtype == "bf16":
            kv = torch.randn((L, H_kv, N, 2 * D), generator=gen,
                             device=dev).bfloat16()
            q = torch.randn((H, 1, D), generator=gen, device=dev).bfloat16()
        else:
            kv = torch.randint(-127, 128, (L, H_kv, N, 2 * D), generator=gen,
                               device=dev, dtype=torch.int8)
            q = torch.randn((H, 1, D), generator=gen, device=dev) * 0.01
        got = block_topk_attention(q, kv, 3, blk, n_cand, block=bs)
        torch.cuda.synchronize()
        ref = block_topk_attention_ref(q, kv, 3, blk, n_cand, block=bs)
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        rel = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                  for a, b in zip(got, ref))
        row_rel = row_rel_err(got[2], ref[2])
        log(f"K1 {kv_dtype} tail: max_abs_err {err:.3e}, {rel:.3e} relative "
            f"to the largest entry (tol {K1_TOL}); worst acc row "
            f"||err||/||ref|| {row_rel:.3e}")
        if not rel <= K1_TOL:
            raise SystemExit(f"K1 disagrees with its plain version "
                             f"({kv_dtype} tail)")
        layer = iter(range(10 ** 9))
        ms = graph_ms(lambda: block_topk_attention(
            q, kv, next(layer) % L, blk, n_cand, block=bs), 8 * L)
        plain_ms = graph_ms(lambda: block_topk_attention_ref(
            q, kv, next(layer) % L, blk, n_cand, block=bs), 2 * L)
        call_ms = cuda_ms(lambda: block_topk_attention(
            q, kv, next(layer) % L, blk, n_cand, block=bs), 400, warmup=16)
        rows = int(np.minimum(bs, np.maximum(n_cand - blk_np * bs, 0)).sum())
        nbytes = (rows * 2 * D * kv.element_size() + q.numel() * q.element_size()
                  + H * 4 * (2 + D))
        ops = 4.0 * (H // H_kv) * D * rows
        bound_ms = max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3
        log(f"K1 {kv_dtype} tail: kernel {ms * 1e3:.2f} us of device time "
            f"per call ({nbytes / ms / 1e6:.0f} GB/s, {bound_ms / ms:.1%} of "
            f"its bound), {call_ms * 1e3:.2f} us "
            f"per call from Python; plain {plain_ms:.3f} ms; bound "
            f"{bound_ms * 1e3:.2f} us (bytes); library call: none")
        if kv_dtype == "bf16":
            entry = dict(name="block_topk_attention", route="cuda",
                         source="pqcache_tpu_torch/csrc/block_attn.cu",
                         replaces="pqcache_tpu/ops/block_attn_pallas.py:138",
                         max_abs_err=err, max_row_rel_err=row_rel, ms=ms,
                         call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by="bytes",
                         library_ms=None)
        del kv, q, got, ref
    return entry


# ---------------------------------------------------------------------------
# K5, K3 and K6 against their plain versions

def _lut_codes(dev, L: int, B: int = 1):
    """A LUT at the main path's shapes ([8 kv heads, 4 q heads, 2 subvecs,
    64 centroids], values of the size q . centroid takes) and L layers of
    uint8 codes [8, 2, N_TAIL]; with B > 1 the batched path's, B slots
    folded into the kv-head axis: [8 B, 4, 2, 64] and [8 B, 2,
    N_TAIL_BATCH]."""
    m = config.LLAMA31_8B
    H_kv, g = m.num_kv_heads, m.num_heads // m.num_kv_heads
    T = N_TAIL if B == 1 else N_TAIL_BATCH
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    lut = torch.randn((B * H_kv, g, 2, 64), generator=gen, device=dev) * 8
    codes = torch.randint(0, 64, (L, B * H_kv, 2, T), generator=gen,
                          device=dev, dtype=torch.uint8)
    return lut, codes


def _k5_library(lut, codes, rnd):
    """One PyTorch call for K5's function, its yardstick: embedding_bag
    (sum) over the flat indices h*S*C + s*C + code of each token's S codes,
    with the LUT as a [Hf*S*C, g] weight. Returns (call, scores): call(i)
    runs it on layer i of the codes, whose indices are built here, outside
    any timed region; scores are its output on layer 3, [Hf, g, T]."""
    Hf, g, S, C = lut.shape
    L, T = codes.shape[0], codes.shape[-1]
    base = (torch.arange(Hf, device=lut.device)[:, None, None] * S * C
            + torch.arange(S, device=lut.device)[None, :, None] * C)
    idx = [(codes[i].long() + base).permute(0, 2, 1).reshape(Hf * T, S)
           for i in range(L)]
    w = ((lut.bfloat16().float() if rnd else lut).permute(0, 2, 3, 1)
         .reshape(Hf * S * C, g).contiguous())

    def call(i):
        return torch.nn.functional.embedding_bag(idx[i], w, mode="sum")
    return call, call(3).reshape(Hf, T, g).transpose(1, 2)


def k5_phase(dev) -> dict:
    """K5 at the Engine's 32k decode shapes (8 kv heads, T N_TAIL) and at
    bench.py's batched per-token shapes (B 8 x 8 kv heads folded, T
    N_TAIL_BATCH), v1 (f32 LUT) and v2 (LUT rounded to bf16); exact against
    the plain version (S = 2: one f32 add per score), and the library call
    (embedding_bag) too. Device time by CUDA-graph replay, the codes cycled
    over 32 layers (17 MB) at 8 heads and 16 layers (69 MB) at 64 heads,
    so they arrive cold; the library call cycles over 32 and 8 layers of
    int64 indices (135 and 275 MB). The kernels line takes the 64-head v2
    entry."""
    entry = None
    for B, L in ((1, 32), (8, 16)):
        lut, codes = _lut_codes(dev, L, B)
        Hf, T = lut.shape[0], codes.shape[-1]
        for mode, rnd in (("v1", False), ("v2", True)):
            got = adc_scores(lut, codes[3], round_lut_bf16=rnd)
            torch.cuda.synchronize()
            ref = adc_scores_ref(lut, codes[3], round_lut_bf16=rnd)
            err = (got - ref).abs().max().item()
            lib_L = L if B == 1 else 8
            library, lib_out = _k5_library(lut, codes[:lib_L], rnd)
            lib_same = torch.equal(lib_out, ref)
            log(f"K5 {mode} {Hf} heads T={T}: max_abs_err {err:.3e} (tol 0: "
                f"exact); embedding_bag equal to the plain version: {lib_same}")
            if err != 0 or not torch.isfinite(got).all() or not lib_same:
                raise SystemExit(f"K5 {mode} ({Hf} heads) disagrees with its "
                                 f"plain version")
            layer = iter(range(10 ** 9))
            ms = graph_ms(lambda: adc_scores(lut, codes[next(layer) % L],
                                             round_lut_bf16=rnd), 4 * L)
            plain_ms = graph_ms(lambda: adc_scores_ref(
                lut, codes[next(layer) % L], round_lut_bf16=rnd), 8)
            lib_ms = graph_ms(lambda: library(next(layer) % lib_L), 2 * lib_L)
            call_ms = cuda_ms(lambda: adc_scores(lut, codes[next(layer) % L],
                                                 round_lut_bf16=rnd), 400,
                              warmup=16)
            nbytes = (codes[0].numel() + lut.numel() * 4 + got.numel() * 4)
            bound_ms = nbytes / PEAK_BYTES * 1e3
            log(f"K5 {mode} {Hf} heads: kernel {ms * 1e3:.2f} us of device "
                f"time per call ({nbytes / ms / 1e6:.0f} GB/s, "
                f"{bound_ms / ms:.1%} of its bound), {call_ms * 1e3:.2f} us "
                f"per call from Python; plain {plain_ms * 1e3:.2f} us; library"
                f" (embedding_bag) {lib_ms * 1e3:.2f} us; bound "
                f"{bound_ms * 1e3:.2f} us (bytes)")
            if mode == "v2" and B > 1:
                entry = dict(name="adc_scores", route="cuda",
                             source="pqcache_tpu_torch/csrc/adc.cu",
                             replaces="pqcache_tpu/ops/adc_pallas.py:327",
                             max_abs_err=err,
                             max_row_rel_err=row_rel_err(got, ref), ms=ms,
                             call_ms=call_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by="bytes",
                             library_ms=lib_ms)
            del got, ref, library, lib_out
        del lut, codes
        torch.cuda.empty_cache()
    return entry


def k3_phase(dev) -> dict:
    """K3 at the 32k decode shapes with sel_block 256 and n_cand = N_CAND:
    per-q-head block mass [32, 129], held at K3_TOL relative to each row's
    largest entry, and the block top-k of the main path (13 blocks per kv
    head) must be identical. The timed launches cycle over 128 layers of
    codes (128 x 528 KB = 67.6 MB per cycle, above the 50 MB L2): in decode
    a layer's codes come back cold, after ~250 MB of weights and the other
    layers' KV have passed through L2."""
    L, bs, D = 128, 256, 128
    g = config.LLAMA31_8B.num_heads // config.LLAMA31_8B.num_kv_heads
    lut, codes = _lut_codes(dev, L)
    got = adc_block_scores(lut, codes[3], N_CAND, sel_block=bs, head_dim=D)
    torch.cuda.synchronize()
    ref = adc_block_scores_ref(lut, codes[3], N_CAND, sel_block=bs,
                               head_dim=D)
    err = (got - ref).abs().max().item()
    rel = ((got - ref).abs() / ref.abs().amax(-1, keepdim=True)).max().item()
    same = torch.equal(
        pq.topk_from_block_mass(got, N_CAND, TOPK, group=g, block=bs),
        pq.topk_from_block_mass(ref, N_CAND, TOPK, group=g, block=bs))
    log(f"K3: max_abs_err {err:.3e}, {rel:.3e} relative to each row's "
        f"largest entry (tol {K3_TOL}); block top-k identical: {same}")
    if not rel <= K3_TOL or not same:
        raise SystemExit("K3 disagrees with its plain version")
    layer = iter(range(10 ** 9))
    ms = graph_ms(lambda: adc_block_scores(
        lut, codes[next(layer) % L], N_CAND, sel_block=bs, head_dim=D), 4 * L)
    plain_ms = graph_ms(lambda: adc_block_scores_ref(
        lut, codes[next(layer) % L], N_CAND, sel_block=bs, head_dim=D), 32)
    call_ms = cuda_ms(lambda: adc_block_scores(
        lut, codes[next(layer) % L], N_CAND, sel_block=bs, head_dim=D), 400,
        warmup=16)
    nbytes = codes[0].numel() + lut.numel() * 4 + got.numel() * 4
    bound_ms = nbytes / PEAK_BYTES * 1e3
    log(f"K3: kernel {ms * 1e3:.2f} us of device time per call, codes "
        f"cold ({nbytes / ms / 1e6:.0f} GB/s, {bound_ms / ms:.1%} of its "
        f"bound), {call_ms * 1e3:.2f} us per call from Python; plain "
        f"{plain_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.2f} us (bytes); "
        f"library call: none")
    return dict(name="adc_block_scores", route="cuda",
                source="pqcache_tpu_torch/csrc/adc.cu",
                replaces="pqcache_tpu/ops/adc_pallas.py:255",
                max_abs_err=err, max_row_rel_err=rel, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None)


def k6_phase(dev) -> dict:
    """K6 at the 32k decode shapes: TOPK sorted rows below N_CAND per kv
    head out of the stacked [L * 8, N_TAIL, 256] tail, layer 3 by head
    offset, bf16 and int8 rows; exact. The timed launches cycle over 8
    layers (107 MB of bf16 rows per cycle, above the 50 MB L2). The library
    yardstick is one advanced-index call, src[off + heads[:, None], idx]."""
    m = config.LLAMA31_8B
    H_kv, D, L = m.num_kv_heads, m.head_dim, 8
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    idx = torch.sort(torch.stack([
        torch.randperm(N_CAND, generator=gen, device=dev)[:TOPK]
        for _ in range(H_kv)]), -1).values
    heads = torch.arange(H_kv, device=dev)[:, None]
    entry = None
    for kv_dtype in ("int8", "bf16"):
        if kv_dtype == "bf16":
            src = torch.randn((L * H_kv, N_TAIL, 2 * D), generator=gen,
                              device=dev).bfloat16()
        else:
            src = torch.randint(-127, 128, (L * H_kv, N_TAIL, 2 * D),
                                generator=gen, device=dev, dtype=torch.int8)
        got = gather_rows(src, idx, 3 * H_kv)
        torch.cuda.synchronize()
        ref = gather_rows_ref(src, idx, 3 * H_kv)
        same = torch.equal(got, ref)
        err = (got.float() - ref.float()).abs().max().item()
        log(f"K6 {kv_dtype} rows: identical to the plain version: {same}")
        if not same:
            raise SystemExit(f"K6 disagrees with its plain version "
                             f"({kv_dtype} rows)")
        layer = iter(range(10 ** 9))
        ms = graph_ms(lambda: gather_rows(
            src, idx, (next(layer) % L) * H_kv), 8 * L)
        plain_ms = graph_ms(lambda: gather_rows_ref(
            src, idx, (next(layer) % L) * H_kv), 2 * L)
        lib_ms = graph_ms(lambda: src[(next(layer) % L) * H_kv + heads, idx],
                          8 * L)
        call_ms = cuda_ms(lambda: gather_rows(
            src, idx, (next(layer) % L) * H_kv), 400, warmup=16)
        nbytes = 2 * got.numel() * got.element_size() + idx.numel() * 8
        bound_ms = nbytes / PEAK_BYTES * 1e3
        log(f"K6 {kv_dtype} rows: kernel {ms * 1e3:.2f} us of device time "
            f"per call ({nbytes / ms / 1e6:.0f} GB/s), {call_ms * 1e3:.2f} "
            f"us per call from Python; plain {plain_ms * 1e3:.2f} us; "
            f"library (advanced index) {lib_ms * 1e3:.2f} us; bound "
            f"{bound_ms * 1e3:.2f} us (bytes)")
        if kv_dtype == "bf16":
            entry = dict(name="gather_rows", route="cuda",
                         source="pqcache_tpu_torch/csrc/gather.cu",
                         replaces="pqcache_tpu/ops/gather_pallas.py:71",
                         max_abs_err=err,
                         max_row_rel_err=row_rel_err(got, ref), ms=ms,
                         call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by="bytes",
                         library_ms=lib_ms)
        del src, got, ref
    return entry


# ---------------------------------------------------------------------------
# W8 against its plain version

def _w8_weights(dev, g, K: int, Ns: tuple, copies: int) -> list:
    """`copies` groups of int8 weights [K, N] for N in Ns, as
    quantize_weight_mat makes them (-127..127), with bf16 column scales
    [1, N] of 0.02-scale weights."""
    return [[(torch.randint(-127, 128, (K, N), generator=g, device=dev,
                            dtype=torch.int8),
              (torch.rand((1, N), generator=g, device=dev) * 4e-4
               + 1e-4).bfloat16()) for N in Ns] for _ in range(copies)]


def w8_phase(dev) -> float:
    """The W8 kernel at every weight shape of the decode path (W8_SHAPES:
    each product alone and the q/k/v and gate/up groups of one launch, and
    the LM head) at M = 1 (the Engine) and M = 8 (bench.py's B): held
    against its plain version at W8_TOL, and captured into a CUDA graph
    whose replay must give the eager output bit for bit. Each launch's
    device time by CUDA-graph replay with the weights cycled over at least
    200 MB (past the 50 MB L2), beside the byte bound, the plain route
    (dequantize to a bf16 copy, torch.matmul, scale) and one torch.matmul
    on a bf16 copy of the same weights (the yardstick: bf16 weights, 2
    bytes each; a group's products side by side, [K, sum N]). Returns the
    largest |error|."""
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = [(k, K, Ns, False) for k, (K, Ns) in W8_SHAPES.items()]
    worst = 0.0
    for name, K, Ns, head in shapes + [("lm_head", W8_HEAD[0],
                                        (W8_HEAD[1],), True)]:
        copies = max(2, -(-200 * 2 ** 20 // (K * sum(Ns))))
        ws = _w8_weights(dev, g, K, Ns, copies)
        wb = [torch.cat([w for w, _ in p], 1).to(torch.bfloat16) for p in ws]
        for M in (1, 8):
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            got = w8.w8_matmul_group(x, ws[0], lm_head=head)
            ref = w8.w8_matmul_group_ref(x, ws[0], lm_head=head)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                w8.w8_matmul_group(x, ws[0], lm_head=head)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                replayed = w8.w8_matmul_group(x, ws[0], lm_head=head)
            graph.replay()
            torch.cuda.synchronize()
            err = max((a.float() - r.float()).abs().max().item()
                      for a, r in zip(got, ref))
            rel = max((a.float() - r.float()).abs().max().item()
                      / r.float().abs().max().item() for a, r in zip(got, ref))
            same = all(torch.equal(a, b) for a, b in zip(replayed, got))
            worst = max(worst, err)
            it = iter(range(10 ** 9))

            def cycled(fn):
                def call():
                    return fn(x, ws[next(it) % copies], lm_head=head)
                return call
            ms = graph_ms(cycled(w8.w8_matmul_group), 2 * copies)
            plain_ms = graph_ms(cycled(w8.w8_matmul_group_ref), 2 * copies)
            lib_ms = graph_ms(lambda: x @ wb[next(it) % copies], 2 * copies)
            nbytes = K * sum(Ns) + 2 * (M * K + sum(Ns)) + M * sum(Ns) * (
                4 if head else 2)
            bound_ms = nbytes / PEAK_BYTES * 1e3
            plan = w8.plan_group(M, Ns, K, sms)
            log(f"W8 {name} K={K} N={'+'.join(map(str, Ns))} M={M}: "
                f"max_abs_err {err:.3e}, {rel:.3e} of the largest |entry| "
                f"(tol {W8_TOL}); replayed from a graph identical: {same}; "
                f"kernel {ms * 1e3:.2f} us ({nbytes / ms / 1e6:.0f} GB/s, "
                f"{bound_ms / ms:.1%} of its bound {bound_ms * 1e3:.2f} us, "
                f"bytes; {plan.grid} CTAs over {plan.units} units of "
                f"{w8.BLOCK_ROWS} x {w8.TILE_COLS}); plain route "
                f"{plain_ms * 1e3:.2f} us; torch.matmul bf16 "
                f"{lib_ms * 1e3:.2f} us")
            if not rel <= W8_TOL or not same or not all(
                    torch.isfinite(a).all() for a in got):
                raise SystemExit(f"W8 disagrees with its plain version "
                                 f"({name}, M={M})")
        del ws, wb
        torch.cuda.empty_cache()
    return worst


def w8_step_entry(dev, worst: float) -> dict:
    """One batched decode step's weight products at BATCH_LAYERS layers and
    B 8 (W8_STEP per layer and the LM head: 33 launches, 2.27 GB of int8
    weights, more than the L2 holds), timed by CUDA-graph replay of the
    whole step: the W8 kernel, the plain route (the device ms per step it
    would cost) and torch.matmul on bf16 copies, one per launch. The
    kernels line's W8 entry."""
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    B = 8
    launches = []
    for _ in range(BATCH_LAYERS):
        for name in W8_STEP:
            K, Ns = W8_SHAPES[name]
            launches.append((_w8_weights(dev, g, K, Ns, 1)[0], False))
    launches.append((_w8_weights(dev, g, *W8_HEAD[:1], W8_HEAD[1:], 1)[0],
                     True))
    xs = {K: torch.randn((B, K), generator=g, device=dev).bfloat16()
          for K in (4096, 14336)}
    bf = [torch.cat([w for w, _ in p], 1).to(torch.bfloat16)
          for p, _ in launches]

    def step(fn):
        for prods, head in launches:
            fn(xs[prods[0][0].shape[0]], prods, lm_head=head)
    ms = graph_ms(lambda: step(w8.w8_matmul_group), 1)
    plain_ms = graph_ms(lambda: step(w8.w8_matmul_group_ref), 1)
    lib_ms = graph_ms(lambda: [xs[b.shape[0]] @ b for b in bf], 1)
    nbytes = sum(b.numel() + 2 * (B * b.shape[0] + b.shape[1])
                 + B * b.shape[1] * (4 if head else 2)
                 for b, (_, head) in zip(bf, launches))
    bound_ms = nbytes / PEAK_BYTES * 1e3
    log(f"W8 per batched step (B {B}, {BATCH_LAYERS} layers, {len(launches)} "
        f"launches, {nbytes / 1e9:.2f} GB): kernel {ms:.3f} ms of device "
        f"time ({nbytes / ms / 1e6:.0f} GB/s, {bound_ms / ms:.1%} of its "
        f"bound {bound_ms:.3f} ms, bytes); plain route (dequantize + "
        f"torch.matmul) {plain_ms:.3f} ms; torch.matmul on bf16 copies "
        f"{lib_ms:.3f} ms")
    del launches, bf
    torch.cuda.empty_cache()
    return dict(name="w8_matmul", route="cuda",
                source="pqcache_tpu_torch/csrc/w8_matmul.cu",
                replaces="pqcache_tpu/models/llama.py:69",
                max_abs_err=worst, max_row_rel_err=None, ms=ms,
                call_ms=None, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=lib_ms)


# ---------------------------------------------------------------------------
# The main path through Engine.generate

# each kernel's wrapper by name, and the launch counts the wrappers keep
KERNELS = workers.KERNELS
_counts, _zero_counts = workers._counts, workers._zero_counts


def engine_cfg(model, engine: str, kernels: str = "auto",
               compress_ratio: float = 0.2):
    e = ENGINES[engine]
    return config.EngineConfig(
        model=model,
        pq=config.PQConfig(n_subvec_per_head=2, n_subbits=6, kmeans_iters=6,
                           **e.get("pq", {})),
        budget=config.BudgetConfig(compress_ratio=compress_ratio,
                                   recent_ratio=0.5, sink_size=32),
        cache=config.CacheConfig(kv_dtype=e.get("kv", "bf16")),
        runtime=config.RuntimeConfig(
            policy=e.get("policy", "pq_search"),
            score_func=e.get("score_func", "sum"), prefill_bucket=1024,
            max_new_tokens=64, max_seq_len=33000, kernels=kernels,
            prefill_chunk=e.get("prefill_chunk", 0), gqa=e.get("gqa", True)))


def _expected_launches(engine: str, policy: str, L: int, steps: int,
                       k2: int = 1) -> dict:
    """The launches of one request: K2 k2 times per layer at prefill (the
    chunks of a chunked prefill, or the prefix snapshot and the suffix), K4
    once per layer for the score-reading policies, per layer and decode
    step the kernels of this engine's pq_search decode; with W8 weights
    the W8 kernel for the prefill's LM head row and, per decode step, once
    for each layer's q/k/v, wo, gate/up and down and once for the LM
    head."""
    pq_kw = ENGINES[engine].get("pq", {})
    dec = set()
    if policy == "pq_search" and pq_kw["select_block"] == 1:
        dec = {"adc_scores"} | ({"gather_rows"} if pq_kw.get(
            "gather_mode") == "pallas" else set())
    elif policy == "pq_search":
        # the ip metric has no block scorer: K5 scores per token
        dec = ({"block_topk_attention"}
               | ({"adc_block_scores"} if pq_kw.get("scorer") == "kernel"
                  else set())
               | ({"adc_scores"} if pq_kw.get("metric") == "ip" else set()))
    pre = {"flash_scores"} if policy in SCORE_POLICIES else set()
    out = {k: L * (k in pre) + L * steps * (k in dec) for k in KERNELS}
    out["flash_attention"] = k2 * L
    if ENGINES[engine].get("w8"):
        out["w8_matmul"] = 1 + steps * (4 * L + 1)
    return out


class _PrefillLogits:
    """While active, keeps the logits of the last prefill that
    Engine.generate ran (one pass, chunked or from a prefix) in .last."""
    NAMES = ("prefill", "prefill_chunked", "prefill_with_prefix")

    def __enter__(self):
        self.last, self._orig = None, {n: getattr(llama, n)
                                       for n in self.NAMES}
        for n, fn in self._orig.items():
            def rec(*a, _fn=fn, **kw):
                self.last = _fn(*a, **kw)
                return self.last
            setattr(llama, n, rec)
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(llama, n, fn)


class _DecodeLogits:
    """While active, keeps the logits of every llama.decode_step in
    .seen (Engine.generate's single-sequence decode)."""

    def __enter__(self):
        self.seen, self._orig = [], llama.decode_step

        def rec(*a, **kw):
            out = self._orig(*a, **kw)
            self.seen.append(out.clone())
            return out
        llama.decode_step = rec
        return self

    def __exit__(self, *exc):
        llama.decode_step = self._orig


def _serve(engines, eng: str, ids, L: int, model, total: dict,
           prefix_len: int = 0, k2: int = 1):
    """One request: every kernel count set to 0 just before it and read just
    after; with prefix_len, Engine.prefill_prefix of the first prefix_len
    tokens and the rest as the suffix. Checks the launches, the tokens and
    the policy; adds the launches to ``total``. Returns the result."""
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    w8.w8_dequant_matmul.launches = 0
    t = time.perf_counter()
    engine = engines[eng]
    prefix = engine.prefill_prefix(ids[:prefix_len]) if prefix_len else None
    prefix_s = time.perf_counter() - t
    res = engine.generate(ids[prefix_len:], NEW_TOKENS, prefix=prefix)
    got = _counts()
    steps = len(res.tokens) - 1
    log(f"request prompt={len(ids)}"
        + (f" (prefix {prefix_len} prefilled in {prefix_s * 1e3:.1f} ms, "
           f"suffix {len(ids) - prefix_len})" if prefix_len else "")
        + f" engine={eng} policy={res.policy_name}: TTFT "
        f"{res.prefill_seconds * 1e3:.1f} ms, decode "
        f"{res.decode_seconds / steps * 1e3:.2f} ms/token over {steps} "
        f"steps, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
        f"launches " + " ".join(f"{k} {v}" for k, v in got.items())
        + (f"; prefill products through dequantized copies "
           f"{w8.w8_dequant_matmul.launches}" if ENGINES[eng].get("w8")
           else ""))
    want = _expected_launches(eng, res.policy_name, L, steps, k2)
    if (len(res.tokens) != NEW_TOKENS or got != want
            or not all(0 <= t < model.vocab_size for t in res.tokens)):
        raise SystemExit(f"main path check failed for prompt {len(ids)} "
                         f"({eng}): launches {got}, expected {want}")
    policy = ("original" if len(ids) < 1000
              else ENGINES[eng].get("policy", "pq_search"))
    if res.policy_name != policy:
        raise SystemExit(f"unexpected policy {res.policy_name}")
    for k in total:
        total[k] += got[k]
    return res


def _hold_logits(what: str, got, ref, toks, ref_toks) -> None:
    """First-token logits within LOGIT_TOL of a reference request's; the
    greedy tokens that agree are printed (decode from states built apart
    may part at a near tie)."""
    d = (got - ref).abs().max().item()
    same = next((i for i, (a, b) in enumerate(zip(toks, ref_toks))
                 if a != b), len(toks))
    log(f"{what}: first-token |logit diff| {d:.4f} (tol {LOGIT_TOL}); greedy "
        f"tokens equal for the first {same} of {len(toks)}")
    if not d <= LOGIT_TOL or not torch.isfinite(got).all():
        raise SystemExit(f"{what}: logits disagree")


def main_path(dev, params, model) -> dict:
    """Serves REQUESTS, then the prefill family (PREFIX, SUFFIX); every
    kernel count is set to 0 just before each request and read just after
    it. Returns the launches summed over all requests."""
    L = model.num_layers
    rng = np.random.default_rng(SEED)
    w8_params = quant.quantize_weight_tree(params)
    engines = {e: Engine(engine_cfg(model, e),
                         w8_params if ENGINES[e].get("w8") else params,
                         device=dev) for e in ENGINES}
    total = dict.fromkeys(KERNELS, 0)
    with _PrefillLogits() as rec:
        for n_prompt, eng in REQUESTS:
            ids = rng.integers(0, model.vocab_size, size=n_prompt)
            res = _serve(engines, eng, ids, L, model, total)
            if (n_prompt, eng) == (32000, "block-bf16"):
                base = (ids, rec.last, res.tokens)
        ids, ref, ref_toks = base
        _serve(engines, "block-w8", ids, L, model, total)
        res = _serve(engines, "chunked", ids, L, model, total, k2=4)
        _hold_logits("chunked request (4 chunks of 8192) against one pass",
                     rec.last, ref, res.tokens, ref_toks)
        ids = rng.integers(0, model.vocab_size, size=PREFIX + SUFFIX)
        one = _serve(engines, "block-bf16", ids, L, model, total)
        ref = rec.last
        res = _serve(engines, "block-bf16", ids, L, model, total,
                     prefix_len=PREFIX, k2=2)
        _hold_logits(f"prefix request ({PREFIX} + {SUFFIX}) against the "
                     f"joined prompt in one shot", rec.last, ref, res.tokens,
                     one.tokens)
    del engines, w8_params
    torch.cuda.empty_cache()
    return total


# The engines of the trace phase's eager split (a), and what each must show:
# K1 runs under pq_fetch on the block paths; the per-token path gathers by
# an unscoped index (gather_mode "xla"), as the JAX package does; h2o and
# infllm call no scoped function
TRACE_ENGINES = ("block-bf16", "token", "k3", "h2o-sum", "infllm")
TRACE_STEPS = 4


def _hold_split(what: str, res: dict, fetch: bool, pq_time: bool) -> None:
    """The buckets add up to total_ms, every device event joined a host
    launch, and fetch / pq time is there or not as the path says."""
    parts = sum(res[f"{b}_ms"] for b in trace.BUCKETS)
    ok = (abs(parts - res["total_ms"]) <= 1e-9 * max(1.0, res["total_ms"])
          and res["unmapped_ms"] == 0 and res["total_ms"] > 0
          and (res["fetch_ms"] > 0) == fetch and (res["pq_ms"] > 0) == pq_time)
    if not ok:
        raise SystemExit(f"{what}: the split fails its holds (fetch "
                         f"{'>' if fetch else '='} 0, pq "
                         f"{'>' if pq_time else '='} 0, unmapped 0): {res}")


def _split_line(res: dict) -> str:
    return ", ".join(f"{b} {res[f'{b}_ms']:.3f}" for b in trace.BUCKETS) + (
        f", total {res['total_ms']:.3f}, unmapped {res['unmapped_ms']:.3f} "
        f"ms/step")


def decode_profile(dev, params, model, engine: str, n_prompt: int = 32000,
                   steps: int = TRACE_STEPS) -> None:
    """Where a decode step's time goes: ``harness/trace.decompose`` over
    `steps` decode steps after the prefill of one request (a warm run, then
    a run profiled with the scope marks on). Prints the split into pq /
    fetch / transfer / model device ms per step, the device time per step
    (the device events' own times, one stream, so they do not overlap), the
    kernel launches per step and the kernels that take the most device
    time, beside the profiled wall time per step, and holds the split
    (``_hold_split``). The profiler adds host time per op, so the device's
    busy share is read against the unprofiled decode ms/token of the main
    path."""
    eng = Engine(engine_cfg(model, engine), params, device=dev)
    ids = np.random.default_rng(SEED + 2).integers(0, model.vocab_size,
                                                   n_prompt)
    it = eng.generate_stream(ids, 2 * steps + 1, chunk=steps)
    next(it)                                  # prefill and the first token
    torch.cuda.synchronize()
    toks, walls = [], []

    def run():
        t = time.perf_counter()
        toks.extend(next(it) for _ in range(steps))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3 / steps)
    res = trace.decompose(run, steps=steps, trace_dir=_trace_dir(engine))
    s = res["summary"]
    if len(toks) != 2 * steps or s["dev_ms"] <= 0:
        raise SystemExit(f"decode profile ({engine}): {len(toks)} tokens, "
                         f"device {s['dev_ms']} ms")
    log(f"decode profile {engine} prompt={n_prompt}: split "
        + _split_line(res) + f"; device {s['dev_ms']:.3f} ms/step in "
        f"{s['kernels']:.0f} kernel launches/step (+ {s['copies']:.0f} "
        f"copies, {s['copy_ms']:.3f} ms); wall under the profiler "
        f"{walls[-1]:.2f} ms/step; top kernels (ms/step): {s['top']}")
    _hold_split(f"decode profile {engine}", res,
                fetch=engine in ("block-bf16", "k3"),
                pq_time=engine in ("block-bf16", "k3", "token"))


def trace_clis(dev) -> None:
    """The two command lines at their defaults, in process: the trace CLI
    for pq_search at BLOCK 1 and 256 and for `original` (each JSON line's
    split held as the eager split is), profile_decode for `original` and
    pq_search from the randomized state and with PREFILL=1."""
    t = time.perf_counter()
    for env, names, fetch in ((dict(), ["pq_search", "original"], False),
                              (dict(BLOCK="256"), ["pq_search"], True)):
        env["TRACE_DIR"] = _trace_dir(f"cli-{env.get('BLOCK', '1')}")
        for line in trace.main(names, env=env):
            pq_path = line["policy"] == "pq_search"
            _hold_split(f"trace CLI {line['policy']} BLOCK "
                        f"{line['block']}", line, fetch and pq_path, pq_path)
            if line["device"] != "cuda" or not line["gpu_name_power"]:
                raise SystemExit(f"trace CLI line off the card: {line}")
        torch.cuda.empty_cache()
    for env in (dict(), dict(PREFILL="1")):
        got = profile_decode.main([], env=env)
        for name, loops in got.items():
            if len(loops) != 4 or not all(
                    bool(((x >= 0) & (x < 128256)).all()) for x in loops):
                raise SystemExit(f"profile_decode {env} {name}: {loops}")
        torch.cuda.empty_cache()
    log(f"trace and profile_decode command lines: "
        f"{time.perf_counter() - t:.1f} s")


def _policy(model, engine: str, kernels: str, n_prompt: int, dev,
            compress: float = SELF_COMPRESS):
    cfg = engine_cfg(model, engine, kernels, compress)
    P = bucket_length(n_prompt, cfg.runtime.prefill_bucket)
    return get_policy(cfg, compute_budget(cfg.budget, P,
                                          cfg.runtime.max_new_tokens), dev), P


def _prefill(model, params, pol, P, ids, dev, dtype=torch.bfloat16):
    state = pol.init_state(dtype)
    toks = np.zeros(P, np.int64)
    toks[P - len(ids):] = ids
    logits = llama.prefill(model, params, pol, state,
                           torch.from_numpy(toks).to(dev), P - len(ids),
                           len(ids))
    return logits, state


def _decode_forced(model, params, pol, state, n_prompt, tokens, dev):
    """Decode with the given tokens fed back (teacher forcing): the logits
    after each of tokens[:-1]."""
    return torch.stack([
        llama.decode_step(model, params, pol, state,
                          torch.full((), t, device=dev), n_prompt + i)
        for i, t in enumerate(tokens[:-1])])


class _Selections:
    """Records the per-token top-k of every decode step (pq.mips_topk, which
    the policy looks up at each call) while active."""

    def __enter__(self):
        self.seen, self._orig = [], pq.mips_topk

        def rec(*a, **kw):
            out = self._orig(*a, **kw)
            self.seen.append(out[0].clone())
            return out
        pq.mips_topk = rec
        return self

    def __exit__(self, *exc):
        pq.mips_topk = self._orig


def self_check(dev, params, model, engine: str = "block-bf16",
               shared_compress: float = SELF_COMPRESS) -> dict:
    """kernels="auto" against kernels="xla" (the plain versions) at reduced
    depth. Held to LOGIT_TOL: the prefill logits (K2 against its plain
    version) and the logits of each decode step taken from one shared state
    (same codebooks and tail), at budget ``shared_compress``. Greedy tokens
    are held at every step with both routes teacher-forced with the plain
    route's tokens (``_check_greedy``: a parting only at a near tie); each
    run trains its own codebooks on its own prefill K, so logits may part
    further there.

    Random weights give nearly uniform block masses, so a block top-k of 2
    of 12 blocks parts at near ties that are noise, not kernel error. The
    whole-run comparison therefore uses a budget (compress 1.0, a
    3072-token prompt, 15 decode steps) whose top-k selects every candidate
    at every step; for block selection the last block is cut by n_cand, so
    K1 still masks rows. On the per-token path K5 and K6 are exact, so the
    shared-state steps run at the main path's budget 0.2 and their per-token
    selections must be identical. Returns the kernel route's request's
    launches (held to its path's)."""
    small, sp, ids = _small(model, params)
    toks, own, P, counted = _both_routes(small, sp, ids, engine,
                                         SELF_COMPRESS, dev)
    ref = toks["xla"]
    pre_diff = (own["auto"][0] - own["xla"][0]).abs().max().item()
    # each decode step from one shared state: the auto run's state before
    # the step, cloned for the plain run
    shared = {k: _policy(small, engine, k, len(ids), dev, shared_compress)[0]
              for k in ("auto", "xla")}
    _, state = _prefill(small, sp, shared["auto"], P, ids, dev)
    dec_diff, sel_same = [], True
    for i, t in enumerate(ref[:-1]):
        tok = torch.full((), t, device=dev)
        with _Selections() as sx:
            lx = llama.decode_step(small, sp, shared["xla"],
                                   copy.deepcopy(state), tok, len(ids) + i)
        with _Selections() as sa:
            la = llama.decode_step(small, sp, shared["auto"], state, tok,
                                   len(ids) + i)
        sel_same &= (len(sa.seen) == len(sx.seen) and all(
            torch.equal(a, b) for a, b in zip(sa.seen, sx.seen)))
        dec_diff.append((la - lx).abs().max().item())
    dec_diff = torch.tensor(dec_diff)
    per_token = ENGINES[engine].get("pq", {}).get("select_block") == 1
    log(f"self-check {engine} ({SELF_LAYERS} layers): prefill |logit diff| "
        f"{pre_diff:.4f}; decode from a shared state at budget "
        f"{shared_compress}: max |logit diff| {dec_diff.max().item():.4f} "
        f"(tol {LOGIT_TOL}), per step "
        f"{[round(x, 4) for x in dec_diff.tolist()[:8]]}..."
        + (f"; per-token selections identical: {sel_same}" if per_token
           else ""))
    _check_greedy(engine, toks, own)
    if (pre_diff > LOGIT_TOL or dec_diff.max().item() > LOGIT_TOL
            or not torch.isfinite(own["auto"]).all()
            or (per_token and not sel_same)):
        raise SystemExit(f"kernels disagree with the plain versions end to "
                         f"end ({engine})")
    return counted


def _small(model, params):
    """The model cut to SELF_LAYERS layers, its params, and the 3072-token
    prompt of the self-checks."""
    small = dataclasses.replace(model, num_layers=SELF_LAYERS)
    sp = dict(params, layers={k: v[:SELF_LAYERS]
                              for k, v in params["layers"].items()})
    ids = np.random.default_rng(SEED + 1).integers(0, model.vocab_size, 3072)
    return small, sp, ids


def _both_routes(small, sp, ids, engine: str, compress: float, dev,
                 on_prefill=None):
    """Engine.generate's greedy tokens on the kernel ("auto") and plain
    ("xla") routes, and each route's own logits: prefill, then teacher
    forcing with the plain route's tokens, and the kernel route's request's
    launches. on_prefill(kernels) is a context manager entered around each
    route's prefill."""
    toks, own = {}, {}
    policy = ENGINES[engine].get("policy", "pq_search")
    for kernels in ("auto", "xla"):
        cfg = engine_cfg(small, engine, kernels, compress)
        _zero_counts()
        res = Engine(cfg, sp, device=dev).generate(ids, SELF_TOKENS)
        if res.policy_name != policy:
            raise SystemExit(f"self-check must run the {policy} path")
        toks[kernels] = res.tokens
        # the kernel route launches exactly its path's kernels, the plain
        # route none
        want = (_expected_launches(engine, policy, SELF_LAYERS,
                                   len(res.tokens) - 1)
                if kernels == "auto" else dict.fromkeys(KERNELS, 0))
        if _counts() != want:
            raise SystemExit(f"self-check {engine} ({kernels}): launches "
                             f"{_counts()}, expected {want}")
        if kernels == "auto":
            counted = want
    for kernels in ("auto", "xla"):
        pol, P = _policy(small, engine, kernels, len(ids), dev, compress)
        with on_prefill(kernels) if on_prefill else contextlib.nullcontext():
            lg, st = _prefill(small, sp, pol, P, ids, dev)
        own[kernels] = torch.cat([lg[None], _decode_forced(
            small, sp, pol, st, len(ids), toks["xla"], dev)])
    return toks, own, P, counted


def _step_diffs(got, ref) -> list:
    """Per step of logits got[i] against ref[i] of the same inputs: (the
    largest |logit difference|, whether the argmaxes agree, ref's top-2
    gap)."""
    out = []
    for g, r in zip(got, ref):
        g, r = g.float(), r.float().to(g.device)
        top2 = r.topk(2).values
        out.append(((g - r).abs().max().item(),
                    int(g.argmax()) == int(r.argmax()),
                    (top2[0] - top2[1]).item()))
    return out


def _verdict(diffs: list, limit) -> tuple:
    """The greedy hold over _step_diffs: every step's largest |logit
    difference| d within ``limit`` (None: no limit), and each parting a
    near tie (ref's top-2 gap at most 2 d there, so at most 2 limit).
    Returns (the partings, the largest d, the first breach or None)."""
    parts, diff = 0, 0.0
    for i, (d, same, gap) in enumerate(diffs):
        diff = max(diff, d)
        if limit is not None and d > limit:
            return parts, diff, (f"|logit difference| {d:.4f} at step {i} "
                                 f"(limit {limit})")
        if same:
            continue
        if gap > 2 * d:
            return parts, diff, (f"greedy tokens differ at step {i} away "
                                 f"from a near tie (top-2 gap {gap:.4f}, "
                                 f"logit difference {d:.4f})")
        parts += 1
    return parts, diff, None


def _partings(what: str, got, ref, limit) -> tuple:
    """Steps whose greedy tokens part, logits got[i] against ref[i] of the
    same inputs, held by _verdict (SystemExit on a breach). Returns (the
    partings, the largest |logit difference| over all steps)."""
    parts, diff, breach = _verdict(_step_diffs(got, ref), limit)
    if breach:
        raise SystemExit(f"{what}: {breach}")
    return parts, diff


def _check_greedy(engine: str, toks: dict, own: dict,
                  limit=LOGIT_TOL) -> None:
    """Greedy tokens at every step, past any tie: both routes are
    teacher-forced with the plain route's tokens (own[k][i] is route k's
    logits before token i), and at each step the kernel route's argmax must
    be the plain route's unless that step's top-2 gap is at most twice the
    routes' logit difference there (a near tie), and that difference is held
    to ``limit`` at every step (None: the routes' caches may part, so no
    limit). Prints the steps compared, the ties, and how far the
    free-running tokens of the two routes agree."""
    ref = toks["xla"]
    plain = own["xla"]
    ties, diff = _partings(f"self-check {engine}", own["auto"], plain,
                           limit)
    same = next((i for i, (a, b) in enumerate(zip(toks["auto"], ref))
                 if a != b), len(ref))
    log(f"self-check {engine}: greedy tokens compared at {plain.shape[0]} "
        f"steps, teacher-forced with the plain route's tokens: "
        f"{plain.shape[0] - ties} equal, {ties} near ties (top-2 gap within "
        f"twice the logit difference; largest |logit diff| {diff:.4f}, tol "
        f"{limit}); free-running tokens equal for the first {same} of "
        f"{len(ref)}")


class _ScoreErrors:
    """While active, holds K4's output at each prefill layer of h2o and
    infllm against flash_scores_ref on that layer's own q and k, and
    records the largest error relative to each head's largest entry."""

    def __enter__(self):
        self.rel, self._orig = [], dispatch.dense_prefill_attention

        def rec(q, k, v, pad_len, **kw):
            out, F = self._orig(q, k, v, pad_len, **kw)
            if F is not None and kw.get("use_kernel", True):
                ref = flash_scores_ref(q, k, pad_len,
                                       score_mode=kw.get("score_mode", "sum"))
                self.rel.append(head_rel_err(F, ref))
            return out, F
        h2o.dense_prefill_attention = infllm.dense_prefill_attention = rec
        return self

    def __exit__(self, *exc):
        h2o.dense_prefill_attention = self._orig
        infllm.dense_prefill_attention = self._orig


def score_self_check(dev, params, model, engine: str):
    """h2o / infllm, kernels="auto" against kernels="xla" at reduced depth
    and the main path's budget 0.2 (the keep-mask and the block selection
    prune): the prefill logits within LOGIT_TOL, K4 at every prefill layer
    within K4_TOL of its plain version on the layer's own inputs, and the
    greedy tokens under the near-tie rule. Decode runs no kernel on these
    policies; its logits part only through the prefill state, but there
    they part without a limit: K4's scores, which agree with the plain
    version's to 1e-6, order the evictions and the block choice, so a
    near-equal pair may keep another token (a 0.379 |logit diff| at step 13 for h2o-sum, PERF.md)."""
    small, sp, ids = _small(model, params)
    errs = {}

    def on_prefill(kernels):
        errs[kernels] = _ScoreErrors()
        return errs[kernels]
    toks, own, _, _ = _both_routes(small, sp, ids, engine, 0.2, dev,
                                on_prefill)
    pre_diff = (own["auto"][0] - own["xla"][0]).abs().max().item()
    k4 = errs["auto"].rel
    log(f"self-check {engine} ({SELF_LAYERS} layers): prefill |logit diff| "
        f"{pre_diff:.4f} (tol {LOGIT_TOL}); K4 per prefill layer, largest "
        f"|err| per head over its largest entry "
        f"{[f'{x:.2e}' for x in k4]} (tol {K4_TOL})")
    _check_greedy(engine, toks, own, limit=None)
    if (pre_diff > LOGIT_TOL or len(k4) != SELF_LAYERS or errs["xla"].rel
            or not max(k4) <= K4_TOL or not torch.isfinite(own["auto"]).all()):
        raise SystemExit(f"kernels disagree with the plain versions end to "
                         f"end ({engine})")


# ---------------------------------------------------------------------------
# The batched decode, bench.py's protocol, eager and replayed from a CUDA graph

BATCH_LAYERS = 8          # bench.py's depth at Llama-3.1-8B widths
BATCH_CTX = 32768         # bench.py's prompt: one 32k prompt, no pad
BATCH_GEN = 128           # bench.py's gen: one chunk of ring_k = 128 steps
BATCH_PROFILE = 4         # profiled steps (a short chunk of its own)
# the most steps the phase decodes on one batched state (two chunks, the
# profiled steps with trace.decompose_replayed's three eager steps and its
# leading replay, a whole profiled chunk), reserved as max_new_tokens
BATCH_STEPS = 3 * BATCH_GEN + BATCH_PROFILE + 4
BATCH_SEGMENT = 16        # steps per profile of a whole replayed chunk
# the batched arms: bench.py's default (select_block 256, the jhist scorer,
# K1), the same with bench.py's default W8 weights (BENCH_W_INT8=1: the W8
# kernel for every weight product), its BENCH_PQ_BLOCK=1 per-token arm (K5,
# GQA top-k, advanced-index row gather) and `original`; policy, PQConfig
# overrides, path kernels (W8 weights where w8_matmul is one)
BATCH_ARMS = {
    "pq_search": ("pq_search", {}, ("block_topk_attention",)),
    "pq_search-w8": ("pq_search", {}, ("block_topk_attention",
                                       "w8_matmul")),
    "pq_search-token": ("pq_search", dict(select_block=1, adc_mode="v2",
                                          gather_mode="xla"),
                        ("adc_scores",)),
    "original": ("original", {}, ()),
}
# the batched tail: the budget's rows (prompt - sink + the reserved steps,
# rounded up to 256) plus the ring pad (ring_k 128 rounded up to 256)
N_TAIL_BATCH = 33536
DEVICE_NAMES = {"block_topk_attention": "::block_attn_kernel<",
                "adc_block_scores": "::block_scores_kernel<",
                "adc_scores": "::adc_scores_kernel<",
                "gather_rows": "::gather_kernel<",
                "w8_matmul": "::w8_kernel<"}


def _per_step(kernel: str, L: int) -> int:
    """Launches of a path kernel per batched decode step: once per layer,
    the W8 kernel 4 times per layer (q/k/v, wo, gate/up, down) and once
    for the LM head."""
    return 4 * L + 1 if kernel == "w8_matmul" else L


def batched_cfg(model, policy: str, kernels: str = "auto",
                compress: float = 0.2, **pq_kw):
    """bench.py's configuration: select_block 256 with the joint-histogram
    scorer, an int8 tail for pq_search (bf16 for `original`), ring_cap 128,
    jhist_defer "auto", fetch_par 32 (accepted, no effect on the card),
    budget 0.2 / 0.5 / sink 32. Where bench.py reserves gen + 2 new
    tokens, this reserves the BATCH_STEPS the phase decodes."""
    kw = dict(n_subvec_per_head=2, n_subbits=6, kmeans_iters=6,
              select_block=256, fetch_par=32, ring_cap=128)
    kw.update(pq_kw)
    return config.EngineConfig(
        model=model, pq=config.PQConfig(**kw),
        budget=config.BudgetConfig(compress_ratio=compress, recent_ratio=0.5,
                                   sink_size=32),
        cache=config.CacheConfig(
            kv_dtype="int8" if policy == "pq_search" else "bf16"),
        runtime=config.RuntimeConfig(
            policy=policy, prefill_bucket=1024, max_new_tokens=BATCH_STEPS,
            max_seq_len=BATCH_CTX + 2048, kernels=kernels))


def _profile(run, steps: int, record: bool = False) -> dict:
    """torch.profiler over run() (`steps` steps), summarized by
    ``harness/trace.summarize``: device kernels per step by name and their
    device ms per step; host launches per step attributed to the stage
    ranges that hold them, and device ms per step to the stage ranges'
    device spans (with ``record``: an eager run with its stages marked)."""
    return trace.summarize(trace.profiled(run, record=record).events(),
                           steps)


def _same_state(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a)
               if isinstance(getattr(a, f.name), torch.Tensor))


def batched_run(dev, model, params, pol, state, first: int, B: int,
                name: str) -> dict:
    """One arm at batch B: the prefilled state inserted into B slots, one
    chunk of BATCH_GEN steps eagerly (on a copy of the batched state) and
    the same chunk replayed from a CUDA graph (its first step eager, then
    the capture); tokens and the states after the flush must be identical.
    A second replayed chunk is timed; profiles of BATCH_PROFILE steps
    attribute the launches by stage (eager) and count the replayed path
    kernels on the card, which must be BATCH_PROFILE x their launches per
    step while the wrappers' counters stay at 0. Kernel counts are zeroed before and read
    after the eager chunk and the capture; the replayed launches are the
    replays times the profiled launches per step."""
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    L = model.num_layers
    torch.cuda.reset_peak_memory_stats()
    bstate = pol.init_batched_state(B)
    for slot in range(B):
        pol.insert_slot(bstate, state, slot)
    twin = copy.deepcopy(bstate)
    tok = torch.full((B,), first, dtype=torch.int32, device=dev)
    pos = torch.full((B,), BATCH_CTX, dtype=torch.int32, device=dev)
    n = BATCH_GEN
    eager = BatchedDecoder(model, params, pol, twin, chunk=n, graph=False)
    replay = BatchedDecoder(model, params, pol, bstate, chunk=n)

    _zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = eager.decode(tok, pos, n)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t) * 1e3 / n
    eager_counts = _counts()
    _zero_counts()
    t = time.perf_counter()
    got = replay.decode(tok, pos, n)
    torch.cuda.synchronize()
    first_chunk_s = time.perf_counter() - t
    capture_counts = _counts()
    same_tokens = torch.equal(got, want)
    same_state = _same_state(bstate, twin)
    t = time.perf_counter()
    replay.decode(got[-1], pos + n, n)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t) * 1e3 / n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # profiles: a short chunk eagerly with its stages marked, on the copy,
    # and replayed, whose path kernels must number steps x L; then, where
    # the tail has room for it (the pq arm at B 8), a whole replayed chunk
    # of ring_k steps in BATCH_SEGMENT-step profiles, counted per segment
    steps = BATCH_PROFILE
    prof_eager = _profile(lambda: eager.decode(want[-1], pos + n, steps),
                          steps, record=True)
    # the replayed steps split by cause (harness/trace.py): three eager
    # steps of the replaying decoder (the last one's kernels named and
    # scoped in launch order), then the replays, joined to it by order
    _zero_counts()
    split = trace.decompose_replayed(replay, got[-1], pos + 2 * n,
                                     steps=steps,
                                     trace_dir=_trace_dir(f"{name}-B{B}"))
    replay_counted = _counts()
    prof_replay = split["summary"]
    path = BATCH_ARMS[name][2]

    def path_seen(profiles):
        return {k: sum(c for pr in profiles for nm, c in pr["by_name"].items()
                       if DEVICE_NAMES[k] in nm) for k in path}
    seen = path_seen([prof_replay])
    whole = ""
    if name == "pq_search" and B == 8:
        replay.begin(got[-1], pos + 2 * n + steps + 4)
        segs = [_profile(lambda: [replay.step()
                                  for _ in range(BATCH_SEGMENT)],
                         BATCH_SEGMENT) for _ in range(n // BATCH_SEGMENT)]
        replay.finish(n)
        whole = (f"; a whole replayed chunk of {n} steps: path kernels "
                 f"{path_seen(segs)} (per {BATCH_SEGMENT}-step segment "
                 f"{[path_seen([sg]) for sg in segs]}, kernels per segment "
                 f"{[round(sg['kernels'] * BATCH_SEGMENT) for sg in segs]})")
    log(f"batched {name} B={B}: eager {eager_ms:.2f} ms/token "
        f"({B * 1e3 / eager_ms:.1f} tok/s aggregate) over {n} steps; "
        f"replayed {replay_ms:.3f} ms/token ({B * 1e3 / replay_ms:.1f} tok/s "
        f"aggregate, {eager_ms / replay_ms:.2f}x); first replayed chunk "
        f"{first_chunk_s:.2f} s with the eager warm-up step and the capture "
        f"({replay.capture_seconds:.3f} s, graph pool "
        f"{replay.pool_bytes / 2 ** 20:.0f} MiB); joint histogram joins "
        f"deferred: {getattr(pol, '_jhist_defer', lambda s: 'n/a')(bstate)}"
        f"; tokens identical "
        f"{same_tokens}, states identical after the flush {same_state}; "
        f"peak {peak:.2f} GiB")
    log(f"batched {name} B={B} eager profile: {prof_eager['kernels']:.0f} "
        f"kernels/step, {prof_eager['host_launches']:.0f} host launches/step "
        f"by stage " + json.dumps({k: round(v, 2) for k, v in
                                    prof_eager["by_stage"].items()})
        + f"; device under the profiler {prof_eager['dev_ms']:.3f} ms/step, "
        f"by stage (ms/step) " + json.dumps(
            {k: round(v, 3) for k, v in prof_eager["dev_stage"].items()})
        + "; "
        f"busy (the replayed step's device time over the eager step) "
        f"{prof_replay['dev_ms'] / eager_ms:.1%}; top kernels (ms/step): "
        + prof_eager["top"])
    log(f"batched {name} B={B} replayed profile over {steps} steps: "
        f"{prof_replay['kernels']:.0f} kernels/step from "
        f"{prof_replay['graph_launches']:.2f} graph launches and "
        f"{prof_replay['host_launches']:.2f} kernel launches per step on the "
        f"host; device {prof_replay['dev_ms']:.3f} ms/step, "
        f"busy {prof_replay['dev_ms'] / replay_ms:.1%} of the unprofiled "
        f"replayed step; path kernels seen {seen}, counted by the wrappers "
        f"in the split's three eager steps (the replays count none) "
        f"{replay_counted}; top kernels (ms/step): "
        + prof_replay["top"] + whole)
    events = prof_replay["kernels"] + prof_replay["copies"]
    log(f"batched {name} B={B} replayed split over {steps} steps (each "
        f"replayed kernel given the scope of the eager step's kernel at its "
        f"index): " + _split_line(split) + f"; {split['joined']} replayed "
        f"device events joined to an eager step of {split['kernels']}, "
        f"{split['launched']} launched by the host around the replays")
    _hold_split(f"batched {name} B={B} replayed split", split,
                fetch="block_topk_attention" in path,
                pq_time=name.startswith("pq_search"))
    want_eager = {k: n * _per_step(k, L) * (k in path) for k in KERNELS}
    want_capture = {k: 2 * _per_step(k, L) * (k in path) for k in KERNELS}
    want_trace = {k: 3 * _per_step(k, L) * (k in path) for k in KERNELS}
    if (not same_tokens or not same_state or eager_counts != want_eager
            or capture_counts != want_capture
            or any(seen[k] != _per_step(k, L) * steps for k in path)
            or replay_counted != want_trace
            or split["joined"] != split["kernels"] * steps
            or split["joined"] + split["launched"] != round(events * steps)
            or abs(split["total_ms"] - prof_replay["dev_ms"]
                   - prof_replay["copy_ms"]) > 1e-9 * split["total_ms"]
            or not bool(((got >= 0) & (got < model.vocab_size)).all())):
        raise SystemExit(
            f"batched {name} B={B} failed: tokens {same_tokens}, states "
            f"{same_state}, eager launches {eager_counts} (expected "
            f"{want_eager}), capture {capture_counts} (expected "
            f"{want_capture}), replayed path kernels {seen}, launches of "
            f"the split's three eager steps {replay_counted} (expected "
            f"{want_trace}), joined {split['joined']} and launched "
            f"{split['launched']} of {events * steps:.0f} device events, "
            f"split total "
            f"{split['total_ms']} of {prof_replay['dev_ms']} + "
            f"{prof_replay['copy_ms']} ms")
    replayed = {k: replay.replays * seen[k] // steps for k in path}
    out = dict(eager_ms=eager_ms, replay_ms=replay_ms, peak_gib=peak,
               capture_s=replay.capture_seconds, counts=eager_counts,
               replayed=replayed, split=split,
               capture_counts=capture_counts, trace_counts=replay_counted,
               bstate=bstate)
    del twin, eager, replay
    return out


def k1_batched_entry(dev, pol, bstate) -> dict:
    """K1 at the batched shapes of bench.py's path, on the real tail of the
    B = 8 state: 64 folded kv heads, 13 selected blocks of 256 rows below
    each head's n_cand, the local window of 3273 rows from n_cand (win_len
    read from the card), int8 rows, q f32. Timed by CUDA-graph replay
    cycling over the 8 layers (about 108 MB of rows per call, 864 MB per
    cycle), so rows arrive cold."""
    L, Hf, N, D2 = bstate.kv_tail.shape
    D, bs, local = D2 // 2, pol.select_block, pol.budget.local
    g = pol.group
    nb_sel = -(-pol.budget.topk // bs)
    n_c = per_head(bstate.n_cand, pol.H_kv)
    rng = np.random.default_rng(SEED + 7)
    ncn = n_c.cpu().numpy()
    blk_np = np.stack([np.sort(rng.choice(ncn[h] // bs, nb_sel,
                                          replace=False)) for h in range(Hf)])
    blk = torch.from_numpy(blk_np).to(dev)
    q = torch.randn((Hf * g, 1, D), generator=torch.Generator(
        device=dev).manual_seed(SEED + 7), device=dev) * 0.01
    wl = torch.full((), local, dtype=torch.int32, device=dev)
    kw = dict(block=bs, win_len=wl, win_max=local)
    got = block_topk_attention(q, bstate.kv_tail, 3, blk, n_c, **kw)
    ctas = block_attn.last_ctas()
    torch.cuda.synchronize()
    ref = block_topk_attention_ref(q, bstate.kv_tail, 3, blk, n_c, **kw)
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    rel = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
              for a, b in zip(got, ref))
    log(f"K1 batched (64 folded heads, window {local}, int8): max_abs_err "
        f"{err:.3e}, {rel:.3e} relative to the largest entry (tol {K1_TOL});"
        f" {ctas} CTAs per kv head")
    if not rel <= K1_TOL:
        raise SystemExit("K1 with the window disagrees with its plain version")
    layer = iter(range(10 ** 9))

    def call():
        return block_topk_attention(q, bstate.kv_tail, next(layer) % L, blk,
                                    n_c, **kw)
    ms = graph_ms(call, 4 * L)
    plain_ms = graph_ms(lambda: block_topk_attention_ref(
        q, bstate.kv_tail, next(layer) % L, blk, n_c, **kw), L)
    call_ms = cuda_ms(lambda: block_topk_attention(
        q, bstate.kv_tail, next(layer) % L, blk, n_c, **kw), 200, warmup=8)
    sel_rows = int(np.minimum(bs, np.maximum(ncn[:, None] - blk_np * bs,
                                             0)).sum())
    win_rows = int(np.minimum(local, N - ncn).sum())
    rows = sel_rows + win_rows
    nbytes = rows * D2 + q.numel() * 4 + Hf * g * 4 * (2 + D)
    ops = 4.0 * g * D * rows
    bound_ms = max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3
    log(f"K1 batched: kernel {ms * 1e3:.2f} us of device time per call "
        f"({rows} rows, {nbytes / ms / 1e6:.0f} GB/s, {bound_ms / ms:.1%} of "
        f"its bound), {call_ms * 1e3:.2f} us per call from Python; plain "
        f"{plain_ms:.3f} ms; bound {bound_ms * 1e3:.2f} us (bytes); library "
        f"call: none")
    return dict(name="block_topk_attention", route="cuda",
                source="pqcache_tpu_torch/csrc/block_attn.cu",
                replaces="pqcache_tpu/ops/block_attn_pallas.py:138",
                max_abs_err=err, max_row_rel_err=row_rel_err(got[2], ref[2]),
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)


def k3_batched(dev, n_cand) -> None:
    """K3 at B 8 (the batched K3 branch's shapes: [8, 8, 4, 2, 64] LUT,
    codes [8, 8, 2, 33280], the slots' n_cand), codes cold (16 layers, 68
    MB per cycle); prints the CTAs per (slot, kv head) it chose."""
    m = config.LLAMA31_8B
    B, H_kv, g, L, bs, D = 8, m.num_kv_heads, m.num_heads // m.num_kv_heads, \
        16, 256, m.head_dim
    T = 33280
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    lut = torch.randn((B, H_kv, g, 2, 64), generator=gen, device=dev) * 8
    codes = torch.randint(0, 64, (L, B, H_kv, 2, T), generator=gen,
                          device=dev, dtype=torch.uint8)
    got = adc_block_scores(lut, codes[3], n_cand, sel_block=bs, head_dim=D)
    ctas = adc.block_scores_ctas()
    torch.cuda.synchronize()
    ref = adc_block_scores_ref(lut, codes[3], n_cand, sel_block=bs,
                               head_dim=D)
    rel = ((got - ref).abs() / ref.abs().amax(-1, keepdim=True)).max().item()
    layer = iter(range(10 ** 9))
    ms = graph_ms(lambda: adc_block_scores(
        lut, codes[next(layer) % L], n_cand, sel_block=bs, head_dim=D), 4 * L)
    nbytes = codes[0].numel() + lut.numel() * 4 + got.numel() * 4
    bound_ms = nbytes / PEAK_BYTES * 1e3
    log(f"K3 batched B={B}: {rel:.3e} relative to each row's largest entry "
        f"(tol {K3_TOL}); {ctas} CTAs per (slot, kv head); kernel "
        f"{ms * 1e3:.2f} us of device time per call, codes cold "
        f"({nbytes / ms / 1e6:.0f} GB/s, bound {bound_ms * 1e3:.2f} us)")
    if not rel <= K3_TOL:
        raise SystemExit("K3 at B 8 disagrees with its plain version")


def batched_phase(dev, params, model) -> tuple:
    """bench.py's protocol through the port at BATCH_LAYERS layers, arm by
    arm (BATCH_ARMS), each arm's state freed before the next: prefilled once
    from one 32k prompt (TTFT), then decoded at B = 8 and at B = 1, eagerly
    and replayed. Returns (the K1 entry at the batched shapes, the launches
    the wrappers counted, the launches replayed from the graphs)."""
    model = dataclasses.replace(model, num_layers=BATCH_LAYERS)
    params = dict(params, layers={k: v[:BATCH_LAYERS]
                                  for k, v in params["layers"].items()})
    ids = np.random.default_rng(SEED + 3).integers(0, model.vocab_size,
                                                   BATCH_CTX)
    toks = torch.from_numpy(ids).to(dev)
    launches = dict.fromkeys(KERNELS, 0)
    replayed = dict.fromkeys(KERNELS, 0)
    entry = None
    for name, (policy, pq_kw, path) in BATCH_ARMS.items():
        arm_params = (quant.quantize_weight_tree(params)
                      if "w8_matmul" in path else params)
        cfg = batched_cfg(model, policy, **pq_kw)
        pol = get_policy(cfg, compute_budget(cfg.budget, BATCH_CTX,
                                             BATCH_STEPS), dev)
        state = pol.init_state()
        _zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        first = int(torch.argmax(llama.prefill(model, arm_params, pol,
                                               state, toks, 0, BATCH_CTX)))
        ttft = time.perf_counter() - t
        for k, v in _counts().items():
            launches[k] += v
        log(f"batched {name}: TTFT {ttft * 1e3:.1f} ms ({BATCH_LAYERS} "
            f"layers, prompt {BATCH_CTX}); ring_k {getattr(pol, 'ring_k', 0)}")
        for B in (8, 1):
            r = batched_run(dev, model, arm_params, pol, state, first, B,
                            name)
            for counts in (r["counts"], r["capture_counts"],
                           r["trace_counts"]):
                for k, v in counts.items():
                    launches[k] += v
            for k, v in r["replayed"].items():
                replayed[k] += v
            if name == "pq_search" and B == 8:
                entry = k1_batched_entry(dev, pol, r["bstate"])
                k3_batched(dev, r["bstate"].n_cand)
            if name == "pq_search-token" and B == 8:
                T = r["bstate"].codes.shape[-1]
                log(f"batched {name}: K5 at {r['bstate'].codes.shape[1]} "
                    f"folded heads, T {T} (the K5 phase timed T "
                    f"{N_TAIL_BATCH})")
                if T != N_TAIL_BATCH:
                    raise SystemExit("the K5 phase timed another tail length")
            del r
            torch.cuda.empty_cache()
        del state, pol, arm_params
        torch.cuda.empty_cache()
    return entry, launches, replayed


def batched_self_check(dev, params, model, name: str, **pq_kw) -> None:
    """kernels="auto" against kernels="xla" (the plain versions) on the
    batched path at SELF_LAYERS layers: two slots (3072- and 3000-token
    prompts) prefilled through the kernels and inserted into one batched
    state and a copy of it; 16 steps with ring_cap 8 (two flushes), each
    step's logits from both routes fed the plain route's tokens, held to
    LOGIT_TOL, greedy tokens equal away from a near tie. Budget
    SELF_COMPRESS, so that the top-k takes every candidate block."""
    small, sp, _ = _small(model, params)
    rng = np.random.default_rng(SEED + 9)
    P, lengths, n_steps = 3072, (3072, 3000), 16
    pols = {}
    for kernels in ("auto", "xla"):
        cfg = batched_cfg(small, "pq_search", kernels, SELF_COMPRESS,
                          ring_cap=8, **pq_kw)
        pols[kernels] = get_policy(
            cfg, compute_budget(cfg.budget, P, BATCH_GEN + 2), dev)
    pol = pols["auto"]
    bstate = pol.init_batched_state(len(lengths))
    first, pos = [], []
    for slot, n in enumerate(lengths):
        ids = np.zeros(P, np.int64)
        ids[P - n:] = rng.integers(0, small.vocab_size, n)
        st = pol.init_state()
        lg = llama.prefill(small, sp, pol, st, torch.from_numpy(ids).to(dev),
                           P - n, n)
        pol.insert_slot(bstate, st, slot)
        first.append(int(torch.argmax(lg)))
        pos.append(n)
    states = {"auto": bstate, "xla": copy.deepcopy(bstate)}
    tok = torch.tensor(first, dtype=torch.int32, device=dev)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    diffs, parted = [], []
    for i in range(n_steps):
        lg = {k: llama.decode_step_batched(small, sp, pols[k], states[k], tok,
                                           pos) for k in ("auto", "xla")}
        d = (lg["auto"] - lg["xla"]).abs().amax(-1)
        diffs.append(d.max().item())
        a, x = lg["auto"].argmax(-1), lg["xla"].argmax(-1)
        for b in torch.nonzero(a != x).flatten().tolist():
            top2 = lg["xla"][b].topk(2).values
            parted.append((i, b, (top2[0] - top2[1]).item(), d[b].item()))
        tok, pos = x.to(torch.int32), pos + 1
        if (i + 1) % pol.ring_k == 0:
            for k in ("auto", "xla"):
                pols[k].flush_ring_batched(states[k])
    same_hist = (pol.use_jhist and torch.equal(states["auto"].jhist,
                                               states["xla"].jhist))
    log(f"self-check batched {name} ({SELF_LAYERS} layers, B "
        f"{len(lengths)}, ring_k {pol.ring_k}, joins deferred "
        f"{pol._jhist_defer(bstate)}): max |logit diff| {max(diffs):.4f} "
        f"(tol {LOGIT_TOL}) over {n_steps} steps; greedy tokens parted at "
        f"{parted or 'no step'}; histograms equal: "
        f"{same_hist if pol.use_jhist else 'n/a'}")
    if (max(diffs) > LOGIT_TOL or any(gap > 2 * d for _, _, gap, d in parted)
            or (pol.use_jhist and not same_hist)):
        raise SystemExit(f"batched kernels disagree with the plain versions "
                         f"({name})")


# ---------------------------------------------------------------------------
# The serving path: BatchEngine under load, through the port's harnesses

# harness/serving.py's defaults, spelled out: Llama-3.1-8B widths at 8
# layers, 32k prompts, pool 8, a burst of 16 requests, 64 new tokens,
# decode chunks of 16, interleaved admission in slabs of 8192, block path
SERVE_ARGS = ["--ctx", "32768", "--layers", "8", "--pool", "8",
              "--requests", "16", "--stagger", "0", "--gen", "64",
              "--chunk", "16", "--prefill-chunk", "8192",
              "--select-block", "256"]
# the rows: (policy, extra flags, the path kernels that must launch)
SERVE_ROWS = [
    ("pq_search", [], ("flash_attention", "block_topk_attention")),
    ("original", [], ("flash_attention",)),
    ("pq_search", ["--kv-dtype", "int8", "--weight-int8"],
     ("flash_attention", "block_topk_attention", "w8_matmul")),
]
# interleaved against monolithic admission: pool 2, 4 prompts of different
# lengths, 32 new tokens
MONO_LENGTHS, MONO_GEN = (32768, 30001, 24577, 17000), 32
SAMPLE_CTX, SAMPLE_B, SAMPLE_STEPS = 4096, 4, 32


class _Spans:
    """While active, CUDA events around the BatchEngine's admission and
    decode calls (no host wait added), kept for the last ``run``; and that
    run's results."""
    KINDS = {"_admission_step": "slab", "_admission_finish": "tail",
             "_admit": "admission", "_decode_chunk": "decode chunk"}

    def __enter__(self):
        from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
        self.events, self.results, self.replays = [], None, 0
        self._orig = {n: getattr(BatchEngine, n)
                      for n in (*self.KINDS, "run")}
        for n, kind in self.KINDS.items():
            def timed(eng, *a, _fn=self._orig[n], _kind=kind, **kw):
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                out = _fn(eng, *a, **kw)
                e.record()
                self.events.append((_kind, s, e))
                return out
            setattr(BatchEngine, n, timed)

        def run(eng, *a, **kw):
            self.events = []
            self.results = self._orig["run"](eng, *a, **kw)
            self.replays = eng.decoder.replays   # over the engine's life
            return self.results
        BatchEngine.run = run
        return self

    def __exit__(self, *exc):
        from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
        for n, fn in self._orig.items():
            setattr(BatchEngine, n, fn)

    def breakdown(self) -> dict:
        """kind -> (calls, seconds between its events summed, the most)."""
        torch.cuda.synchronize()
        out = {}
        for kind, s, e in self.events:
            n, tot, most = out.get(kind, (0, 0.0, 0.0))
            t = s.elapsed_time(e) / 1e3
            out[kind] = (n + 1, tot + t, max(most, t))
        return out


def serving_rows(dev) -> tuple:
    """(a) harness/serving.py at its defaults for each of SERVE_ROWS: every
    request returns gen tokens, ttft_p95 >= wait_p95 >= 0, the path's
    kernels launched (counts set to 0 just before the row, read just
    after). Prints each row's JSON line, its peak memory and where its
    timed run's time went. Returns the launches the wrappers counted and
    those the decode graph's replays ran (replays x launches per step)."""
    from pqcache_tpu_torch.harness import serving
    total = dict.fromkeys(KERNELS, 0)
    replayed = dict.fromkeys(KERNELS, 0)
    for policy, extra, path in SERVE_ROWS:
        args = serving.parse_args(SERVE_ARGS + extra + ["--policies",
                                                        policy])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t = time.perf_counter()
        with _Spans() as spans:
            (row,) = serving.run(args)
        got = _counts()
        split = spans.breakdown()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"serving {policy} {' '.join(extra) or '(bf16)'}: "
            f"{time.perf_counter() - t:.0f} s with the warm-up, peak "
            f"{peak:.1f} GiB; launches {got}")
        log(f"serving {policy}: timed run {row['wall_s']} s, of it "
            + "; ".join(f"{k} {n} x, {s:.3f} s (most {m * 1e3:.1f} ms)"
                        for k, (n, s, m) in split.items()))
        res = spans.results
        if (sorted(res) != list(range(args.requests))
                or any(len(v) != args.gen for v in res.values())
                or not row["ttft_p95_s"] >= row["wait_p95_s"] >= 0
                or not all(got[k] > 0 for k in path)):
            raise SystemExit(f"serving row {policy} {extra} failed")
        for k in total:
            total[k] += got[k]
        for k in path[1:]:            # the decode kernels of the step
            replayed[k] += spans.replays * _per_step(k, args.layers)
    return total, replayed


def interleave_check(dev) -> dict:
    """(b) interleaved against monolithic admission on the card: the
    8-layer model, pool 2, MONO_LENGTHS prompts, MONO_GEN new tokens; the
    token streams must be identical. Returns the launches."""
    from pqcache_tpu_torch.harness import serving
    from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
    model = bench.bench_model(8)
    params = serving.build_params(model, False, dev)
    cfg = batched_cfg(model, "pq_search")
    cfg = dataclasses.replace(cfg, cache=config.CacheConfig(kv_dtype="bf16"),
                              runtime=dataclasses.replace(
                                  cfg.runtime, max_new_tokens=MONO_GEN,
                                  prefill_chunk=8192))
    rng = np.random.default_rng(SEED + 11)
    reqs = [(i, rng.integers(0, model.vocab_size, n))
            for i, n in enumerate(MONO_LENGTHS)]
    out, total = {}, dict.fromkeys(KERNELS, 0)
    for mode in ("on", "off"):
        _zero_counts()
        t = time.perf_counter()
        be = BatchEngine(cfg, params, batch_size=2, prefill_len=BATCH_CTX,
                         max_new_tokens=MONO_GEN, interleave=mode)
        out[mode] = be.run(reqs, chunk=16)
        got = _counts()
        log(f"admission interleave={mode}: {time.perf_counter() - t:.1f} s "
            f"for {len(reqs)} prompts {MONO_LENGTHS}, pool 2; launches "
            f"{got}")
        for k in total:
            total[k] += got[k]
        del be
        torch.cuda.empty_cache()
    same = out["on"] == out["off"]
    log(f"interleaved = monolithic token streams: {same}")
    if not same or any(len(v) != MONO_GEN for v in out["on"].values()):
        raise SystemExit("interleaved and monolithic admission disagree")
    return total


def sampling_check(dev) -> None:
    """(c) sampling on the batched decoder at 2 layers: SAMPLE_B prompts of
    SAMPLE_CTX tokens, one per slot; temperature 0.8, top_k 50, top_p 0.9
    replayed from the graph against eager from the same generator seed
    (tokens and states identical); top_k 1 replayed against eager, and at
    every eager step and slot the token is the plain rule's: of the tokens
    tied at the largest logit (top_k keeps every tied logit, as JAX's
    `>= kth` does), the one with the largest noise; greedy, unless bf16
    logits tie."""
    from pqcache_tpu_torch.core.sampling import GumbelNoise, make_sampler
    from pqcache_tpu_torch.harness import serving
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    model = bench.bench_model(2)
    params = serving.build_params(model, False, dev)
    cfg = batched_cfg(model, "pq_search")
    pol = get_policy(cfg, compute_budget(cfg.budget, SAMPLE_CTX,
                                         SAMPLE_STEPS), dev)
    rng = np.random.default_rng(SEED + 12)
    bstate = pol.init_batched_state(SAMPLE_B)
    first = []
    for slot in range(SAMPLE_B):
        ids = torch.from_numpy(rng.integers(0, model.vocab_size,
                                            SAMPLE_CTX)).to(dev)
        st = pol.init_state()
        first.append(int(torch.argmax(llama.prefill(
            model, params, pol, st, ids, 0, SAMPLE_CTX))))
        pol.insert_slot(bstate, st, slot)
        del st
    states = [bstate] + [copy.deepcopy(bstate) for _ in range(3)]
    tok = torch.tensor(first, dtype=torch.int32, device=dev)
    pos = torch.full((SAMPLE_B,), SAMPLE_CTX, dtype=torch.int32, device=dev)
    one_hot = make_sampler(0.8, 1)
    seen = []

    def recording(lg, noise):    # top_k 1, keeping each step's inputs
        seen.append((lg.float().clone(), noise.clone()))
        return one_hot(lg, noise)

    def run(state, sample, graph):
        d = BatchedDecoder(model, params, pol, state, chunk=16, graph=graph,
                           sample=sample, noise=GumbelNoise(SEED + 5, dev))
        return d.generate(tok, pos, SAMPLE_STEPS)
    hot = make_sampler(0.8, 50, 0.9)
    replayed, eager = run(states[0], hot, True), run(states[1], hot, False)
    one, one_eager = (run(states[2], one_hot, True),
                      run(states[3], recording, False))
    same_state = _same_state(states[0], states[1])
    distinct = len(set(replayed[:, 0].tolist()))
    lg = torch.stack([x for x, _ in seen])             # [steps, B, V]
    noise = torch.stack([g for _, g in seen])
    tied = lg == lg.amax(-1, keepdim=True)
    rule = torch.where(tied, noise, -torch.inf).argmax(-1).to(torch.int32)
    greedy = lg.argmax(-1).to(torch.int32)
    n_tied = int((tied.sum(-1) > 1).sum())
    rule_ok = torch.equal(one_eager, rule)
    log(f"sampling (T 0.8, top_k 50, top_p 0.9; 2 layers, B {SAMPLE_B} "
        f"prompts, {SAMPLE_STEPS} steps): replayed = eager tokens "
        f"{torch.equal(replayed, eager)}, states {same_state}; {distinct} "
        f"distinct tokens in slot 0; top_k 1: replayed = eager "
        f"{torch.equal(one, one_eager)}, the plain rule at every step and "
        f"slot {rule_ok} ({n_tied} of {lg.shape[0] * SAMPLE_B} steps x "
        f"slots had tied largest logits; the token was greedy's argmax at "
        f"{int((one_eager == greedy).sum())})")
    if not (torch.equal(replayed, eager) and same_state
            and torch.equal(one, one_eager) and rule_ok):
        raise SystemExit("sampled decode: replayed and eager disagree, or "
                         "top_k 1 is not greedy up to ties")


def latency_rows(dev) -> dict:
    """(d) harness/latency.py at 32k: pq_search with W8 weights and an int8
    tail at select_block 1 (K5), and `original`. Prints its rows; returns
    the launches."""
    from pqcache_tpu_torch.harness import latency
    args = latency.parse_args(["--ctx", "32768", "--policies", "pq_search",
                               "original", "--weight-int8", "--kv-dtype",
                               "int8"])
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rows = latency.run(args)
    got = _counts()
    log(f"latency harness: {time.perf_counter() - t:.0f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; launches "
        f"{got}")
    if not (len(rows) == 2 and all(r["per_token_ms"] > 0 for r in rows)
            and got["adc_scores"] > 0 and got["w8_matmul"] > 0
            and got["flash_attention"] > 0):
        raise SystemExit("latency harness failed")
    return got


def serving_phase(dev) -> tuple:
    """(a)-(d); returns the launches the wrappers counted and those the
    serving rows' decode graphs replayed."""
    total, replayed = serving_rows(dev)
    for part in (interleave_check(dev), latency_rows(dev)):
        for k in total:
            total[k] += part[k]
    sampling_check(dev)
    return total, replayed


# ---------------------------------------------------------------------------
# The host-offload tier: the KV in pinned host memory, a device block cache

OFFLOAD_CTX = 32768
OFFLOAD_GEN = 24
OFFLOAD_AGREE = 0.8    # greedy tokens the offload twin shares with the HBM
# |logit| difference, offload tier against its HBM twin, teacher-forced, at
# every decode step: K1 against the plain segment merge over the same
# blocks, both in bf16, reads 0.125-0.164 a step; with a wrong block
# assembled for each cache hit (_WrongSlot) 5.3-6.8 from the first step
# with hits (PERF.md)
OFFLOAD_LOGIT_TOL = 0.25
OFFLOAD_RUNS = [       # (label, offload_bench environment) of (b) and (c)
    ("(b) generate_batch B 4 @ 32k", dict(BATCH="4")),
    ("(b) serve 8 requests over 4 slots @ 32k",
     dict(BATCH="4", REQUESTS="8")),
    ("(c) 128k, int8 store, stale, chunked prefill 32768",
     dict(CTX="131072", KV_INT8="1", STALE="1", PREFILL_CHUNK="32768")),
]


def offload_cfg(model, kv: str = "bf16", stale: bool = False,
                offload: bool = True):
    """offload_bench's configuration (harness/offload_bench.py): PQ 2 x 6
    bits, 6 k-means iterations, budget 0.2 / 0.5 / sink 32, block 128, an
    8192-token device cache, top 64 blocks admitted a step; select_block
    128 so that the device tier (offload=False) selects the same blocks."""
    return config.EngineConfig(
        model=model,
        pq=config.PQConfig(n_subvec_per_head=2, n_subbits=6, kmeans_iters=6,
                           select_block=128),
        budget=config.BudgetConfig(compress_ratio=0.2, recent_ratio=0.5,
                                   sink_size=32),
        cache=config.CacheConfig(offload=offload, block_size=128,
                                 hbm_cache_tokens=8192, cache_topk_blocks=64,
                                 kv_dtype=kv, stale_select=stale),
        runtime=config.RuntimeConfig(
            policy="pq_search", prefill_bucket=1024,
            max_new_tokens=OFFLOAD_GEN + 2, max_seq_len=OFFLOAD_CTX + 2048))


def _offload_line(label: str, eng, res_ms: float, ttft: float,
                  k2: int) -> dict:
    """Prints one offload run's figures; returns its transfer stats."""
    st, tm = eng.store, eng.timings
    t = st.transfer_stats()
    steps = max(tm["steps"], 1)
    log(f"offload {label}: TTFT {ttft * 1e3:.1f} ms of which pinned "
        f"allocation {t['alloc_s'] * 1e3:.1f} ms "
        f"({t['pinned_bytes'] / 2**30:.2f} GiB pinned); decode "
        f"{res_ms:.2f} ms/token; per step host "
        f"{tm['host_s'] / steps * 1e3:.2f} ms, wait "
        f"{tm['wait_s'] / steps * 1e3:.2f} ms, decode "
        f"{tm['decode_s'] / steps * 1e3:.2f} ms over {tm['steps']} steps; hit "
        f"rate {st.hit_rate:.4f} ({st.hits} hits, {st.misses} misses); staged "
        f"{t['h2d_bytes'] / steps / 2**20:.2f} MiB/step in "
        f"{t['h2d_copies'] / steps:.1f} copies/step at "
        f"{t['h2d_bytes'] / max(t['h2d_s'] or 0, 1e-12) / 1e9:.2f} GB/s "
        f"(H2D); prefill and tail writes {t['d2h_bytes'] / 2**30:.3f} GiB at "
        f"{t['d2h_bytes'] / max(t['d2h_s'] or 0, 1e-12) / 1e9:.2f} GB/s "
        f"(D2H); peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
        f"K2 launches {k2}; native LFU {st.lfu[0].native}")
    return t


class _WrongSlot:
    """While active (when ``on``), the offload engine assembles each cache
    hit from the next cache slot: real rows of a wrong block, the fault of
    a slot map that is off by one."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self._orig = offload_engine.assemble_blocks
        if self.on:
            def wrong(cache, staged, slots, miss_pos):
                nxt = torch.where(slots >= 0, (slots + 1) % cache.shape[0],
                                  slots)
                return self._orig(cache, staged, nxt, miss_pos)
            offload_engine.assemble_blocks = wrong
        return self

    def __exit__(self, *exc):
        offload_engine.assemble_blocks = self._orig


def offload_phase(dev, params, model) -> dict:
    """(a) the device-tier Engine (select_block 128) against OffloadEngine
    with a bf16 store in exact mode on one 32k prompt: the first-token
    logits within LOGIT_TOL (the same prefill math); fed the twin's tokens,
    every step's logits within OFFLOAD_LOGIT_TOL of the twin's, greedy
    tokens equal on at least OFFLOAD_AGREE of the steps, every parting at
    a near tie (top-2 gap within twice the logit difference: the decode
    differs only in its memory hierarchy and in K1 against the plain
    segment merge), and hits > 0; the same run with each cache hit
    assembled from the wrong slot (_WrongSlot), which that hold must
    reject; then an int8 store in stale mode, free-running; (b)
    and (c) through harness/offload_bench.py. Each run's kernel counts are
    set to 0 before it and read after: K2 on every prefill, no other
    kernel on the offload tier (its decode attends the assembled blocks
    with the plain segment merge; the HBM twin decodes through K1).
    Returns the launches."""
    from pqcache_tpu_torch.harness import offload_bench
    total = dict.fromkeys(KERNELS, 0)
    L = model.num_layers
    ids = np.random.default_rng(SEED + 20).integers(0, model.vocab_size,
                                                    OFFLOAD_CTX)

    def counted(what: str, want_k2: int, **more) -> int:
        got = _counts()
        for k in total:
            total[k] += got[k]
        want = dict(dict.fromkeys(KERNELS, 0), flash_attention=want_k2,
                    **more)
        if got != want:
            raise SystemExit(f"offload {what}: launches {got}, expected "
                             f"{want}")
        return got["flash_attention"]

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with _PrefillLogits() as rec, _DecodeLogits() as dec:
        hbm = Engine(offload_cfg(model, offload=False), params,
                     device=dev).generate(ids, OFFLOAD_GEN)
    hbm_logits = [rec.last] + dec.seen
    # the device tier decodes through K1, the offload tier through none
    k2 = counted("HBM twin", L,
                 block_topk_attention=L * (len(hbm.tokens) - 1))
    hbm_ms = hbm.decode_seconds / (len(hbm.tokens) - 1) * 1e3
    log(f"offload (a) HBM twin (select_block 128, bf16 tail): TTFT "
        f"{hbm.prefill_seconds * 1e3:.1f} ms, decode {hbm_ms:.2f} ms/token, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; K2 "
        f"launches {k2}")
    # (kv, stale, planted fault): the bf16 exact arm is run again with a
    # wrong block assembled for every cache hit, which the hold must reject
    for kv, stale, fault in (("bf16", False, False), ("bf16", False, True),
                             ("int8", True, False)):
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        eng = OffloadEngine(offload_cfg(model, kv, stale), params,
                            device=dev)
        eng.logits_log = []
        t0 = time.perf_counter()
        # exact mode is fed the twin's tokens (teacher forcing), so that
        # each step's logits compare; stale mode runs free
        with _WrongSlot(fault):
            it = eng.stream(ids, OFFLOAD_GEN,
                            forced=None if stale else hbm.tokens)
            toks = [next(it)]
            ttft = time.perf_counter() - t0
            toks.extend(it)
            torch.cuda.synchronize()
        dec_ms = eng.timings["decode_s"] / eng.timings["steps"] * 1e3
        label = (f"(a) {kv} store, {'stale' if stale else 'exact'}"
                 + (", planted fault (each hit from the next cache slot)"
                    if fault else ""))
        k2 = counted(label, L)
        if not fault:
            _offload_line(label, eng, dec_ms, ttft, k2)
        first = eng.logits_log[0].to(dev)
        d = (first - rec.last).abs().max().item()
        agree = sum(a == b for a, b in zip(toks, hbm.tokens)) / len(toks)
        if not stale:
            diffs = _step_diffs([x.to(dev) for x in eng.logits_log],
                                hbm_logits)
            ties, diff, breach = _verdict(diffs, OFFLOAD_LOGIT_TOL)
            per_step = [round(x[0], 4) for x in diffs]
        log(f"offload {label} against the HBM twin: first-token |logit "
            f"diff| {d:.4f} (tol {LOGIT_TOL}); greedy tokens equal at "
            f"{agree:.0%} of {len(toks)} steps "
            + ("(teacher-forced with the twin's tokens: largest |logit "
               f"diff| {diff:.4f} (limit {OFFLOAD_LOGIT_TOL}), per step "
               f"{per_step}, {ties} partings at a near tie; breach: "
               f"{breach})" if not stale
               else "(free-running, stale selection)"))
        if not all(c.native for c in eng.store.lfu):
            raise SystemExit("offload: the native LFU did not build")
        if (len(toks) != OFFLOAD_GEN or eng.store.hits <= 0
                or not all(0 <= t < model.vocab_size for t in toks)
                or not torch.isfinite(first).all()):
            raise SystemExit(f"offload {label}: run failed: {toks}")
        if fault and breach is None:
            raise SystemExit(f"offload {label}: the hold against the HBM "
                             f"twin does not see the planted fault")
        if not stale and not fault and (d > LOGIT_TOL or breach
                                        or agree < OFFLOAD_AGREE):
            raise SystemExit(f"offload {label} disagrees with its HBM twin")
        del eng
    torch.cuda.empty_cache()
    for label, env in OFFLOAD_RUNS:
        s = offload_bench.settings(dict(env, SKIP_HBM="1", GEN=str(
            OFFLOAD_GEN)))
        chunks = (-(-s["ctx"] // s["prefill_chunk"])
                  if s["prefill_chunk"] else 1)
        # a warm-up run and the timed one
        prefills = (2 * s["batch"] if s["requests"] <= s["batch"]
                    else s["batch"] + s["requests"])
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        line = offload_bench.run(s)
        k2 = counted(label, prefills * chunks * L)
        log(f"offload {label} ({time.perf_counter() - t0:.0f} s with its "
            f"warm-up; peak {torch.cuda.max_memory_allocated() / 2**30:.1f} "
            f"GiB; K2 launches {k2}):")
        log(json.dumps(line))
        if not (line["per_step_ms"] > 0 and line["hit_rate"] > 0
                and line["staged_bytes_per_step"] > 0
                and line["lfu_native"]):
            raise SystemExit(f"offload {label}: run failed")
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# The parallel phase: the tensor-, data- and sequence-parallel engines with
# ranks as processes that share the one card over gloo (NCCL refuses two
# ranks on one device), so its times are the path's overheads, not a
# parallel speed-up

PAR_CTX = 32768          # (a) TPEngine tp 2 and (c) generate_ring sp 2
PAR_GEN = 32
PAR_BATCH_CTX = 8192     # (b) BatchTPEngine dp 2 x tp 2, PAR_SLOTS slots
PAR_SLOTS = 4
PAR_ARM_CTX = 8192       # the K3 and K5 arms of TPEngine tp 2
PAR_ARM_GEN = 8
PAR_OFFLOAD_B = 2        # (d) ShardedOffloadEngine tp 2, B 2 of 8k prompts
PAR_OFFLOAD_CTX = 8192
# A rank all-reduces each row-parallel product's bf16 partials, so every
# layer rounds twice more than on one device (and the ring prefill attends
# in float32 where K2 rounds P to bf16): at 8 layers the same function's
# logits part by ~0.1, at 2 layers by ~0.02 (PERF.md). The offload twin's
# limit; the planted fault (_swap_wo: each rank's heads through the other
# shard's wo rows) must breach it, and its reading is printed.
PAR_LOGIT_TOL = OFFLOAD_LOGIT_TOL


def par_cfg(model, P: int, gen: int, compress: float = 0.2, **pq_kw):
    """The batched path's pq_search configuration (``batched_cfg``:
    select_block 256, the joint-histogram scorer, an int8 tail, budget
    0.2 / 0.5 / sink 32), reserving ``gen`` new tokens past a P-token
    prompt: the single-process references and the ranks share its
    budget."""
    cfg = batched_cfg(model, "pq_search", compress=compress, **pq_kw)
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, max_new_tokens=gen, max_seq_len=P + 2048))


def _ranks(fn, n: int, *args, **kwargs) -> list:
    from pqcache_tpu_torch.parallel import launch
    return launch.launch(fn, n, backend="gloo", devices=["cuda:0"] * n,
                         args=args, kwargs=kwargs, timeout=900)


def _rank_counts(what: str, res: list, want: set, total: dict) -> None:
    """Each rank's launches of the run it reports: every kernel of
    ``want`` launched, no other; added to ``total``."""
    for r in res:
        got = r["launches"]
        for k, v in got.items():
            total[k] += v
        if any((got[k] > 0) != (k in want) for k in got):
            raise SystemExit(f"parallel {what}: rank {r['rank']} launched "
                             f"{got}, expected exactly {sorted(want)}")
    log(f"parallel {what}: launches per rank "
        f"{[{k: v for k, v in r['launches'].items() if v} for r in res]}")


def _rank_lines(what: str, res: list, timed: bool = False) -> None:
    """Each rank's peak device memory and its collectives' routes, calls
    and bytes; their host seconds only where the run timed them."""
    for r in res:
        peak = r["peak_bytes"]
        log(f"parallel {what} rank {r['rank']}: peak "
            + (f"{peak / 2**30:.2f} GiB" if peak is not None
               else "not measured") + "; collectives "
            + json.dumps({g: {op: {k: (round(v, 4) if isinstance(v, float)
                                       else v) for k, v in st.items()
                                   if timed or k != "seconds"}
                              for op, st in ops.items()}
                          for g, ops in r["comm"].items()}))


def _tp_line(what: str, r: dict, timed: bool = False) -> None:
    """TTFT and ms/token of a run; with ``timed`` (the collectives timed
    on the host clock, the device synchronised around each: a measurement
    run whose own times are instrumented) the collectives' share."""
    t = r["timings"]
    d = t.get("decode_all_reduce", {})
    steps = max(t["steps"], 1)
    line = (f"parallel {what}: TTFT {t['prefill_s'] * 1e3:.1f} ms, decode "
            f"{t['decode_s'] / steps * 1e3:.2f} ms/token over {t['steps']} "
            f"steps; decode all-reduce {d.get('bytes', 0) / steps:.0f} B "
            f"and {d.get('calls', 0) / steps:.0f} calls a step")
    if timed:
        line += (f"; instrumented: {d.get('seconds', 0.0) / max(t['decode_s'], 1e-9):.1%}"
                 f" of the decode in collectives on the host clock (device "
                 f"synchronised around each)")
    log(line)


def _hold_par(what: str, toks: dict, own, got,
              limit=PAR_LOGIT_TOL) -> None:
    """A parallel run against its single-process reference, both fed the
    reference's tokens (own[i], got[i]: the logits before token i): every
    step within ``limit`` and each greedy parting at a near tie
    (``_check_greedy``); ``toks``, the free-running tokens beside the
    reference's, printed. The bf16 runs are held at budget 1.0, where the
    top-k takes every candidate: at budget 0.2 the two runs train their
    codebooks on keys that differ in bf16 rounding, and a block top-k of
    random weights is a near tie, so their selections part and the logits
    with them (PERF.md); ``par_tp_from_state`` holds budget 0.2 from one
    prefill state."""
    _check_greedy(f"parallel {what}", toks, {"xla": own, "auto": got},
                  limit=limit)


def _reject_par(what: str, own, got) -> None:
    """The negative control: the hold must reject a planted fault."""
    parts, diff, breach = _verdict(_step_diffs(got, own), PAR_LOGIT_TOL)
    log(f"parallel {what}: largest |logit diff| {diff:.4f} (tol "
        f"{PAR_LOGIT_TOL}), rejected: {breach}")
    if breach is None:
        raise SystemExit(f"parallel {what}: the hold accepted a planted "
                         f"fault")


def _forced_logits(model, params, cfg, ids, P, toks, dev,
                   dtype=torch.bfloat16):
    """The single-process teacher-forced logits under cfg: the prefill's,
    then after each of toks[:-1]."""
    pol = get_policy(cfg, compute_budget(cfg.budget, P, cfg.runtime
                                         .max_new_tokens), dev)
    lg, st = _prefill(model, params, pol, P, ids, dev, dtype)
    return torch.cat([lg[None], _decode_forced(model, params, pol, st,
                                               len(ids), toks, dev)])


def par_tp(dev, params, model, total: dict) -> None:
    """(a) TPEngine tp 2 on one 32k prompt against the single-process
    Engine (``_hold_par``); (c) generate_ring sp 2 held against (a)'s
    generate the same way; the K3 and K5 arms of the decode at 8k and
    budget 1.0, and the K3 arm with the planted fault (``_swap_wo``), which
    the hold must reject; (a) once more with the collectives timed. One
    launch of two ranks runs the six."""
    cfg = par_cfg(model, PAR_CTX, PAR_GEN)
    cfg1 = par_cfg(model, PAR_CTX, PAR_GEN, compress=1.0)
    ids = np.random.default_rng(SEED + 30).integers(0, model.vocab_size,
                                                    PAR_CTX)
    torch.cuda.reset_peak_memory_stats()
    ref = Engine(cfg, params, device=dev).generate(ids, PAR_GEN)
    log(f"parallel (a) single-process Engine: TTFT "
        f"{ref.prefill_seconds * 1e3:.1f} ms, decode "
        f"{ref.decode_seconds / (PAR_GEN - 1) * 1e3:.2f} ms/token, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    forced = Engine(cfg1, params, device=dev).generate(ids, PAR_GEN).tokens
    own = _forced_logits(model, params, cfg1, ids, PAR_CTX, forced, dev)
    par_tp_from_state(dev, params, model, cfg, ids, ref.tokens)
    # the K3 and K5 arms of the decode under tp 2 at 8k, budget 1.0 (free
    # running and teacher-forced alike)
    arms = {"k3": dict(scorer="kernel"),
            "token": dict(select_block=1, adc_mode="v2")}
    ids8 = ids[:PAR_ARM_CTX - 500]
    runs = [dict(cfg=cfg, prompt=ids, prefill_len=PAR_CTX, max_new=PAR_GEN,
                 ring=ring, forced=forced, forced_cfg=cfg1)
            for ring in (False, True)]
    refs, owns = [], []
    for kw in arms.values():
        c = par_cfg(model, PAR_ARM_CTX, PAR_ARM_GEN, compress=1.0, **kw)
        r = Engine(c, params, device=dev).generate(ids8, PAR_ARM_GEN).tokens
        owns.append(_forced_logits(model, params, c, ids8, PAR_ARM_CTX, r,
                                   dev))
        refs.append(r)
        runs.append(dict(cfg=c, prompt=ids8, prefill_len=PAR_ARM_CTX,
                         max_new=PAR_ARM_GEN, forced=r))
    runs.append(dict(runs[2], fault=True))
    runs.append(dict(cfg=cfg, prompt=ids, prefill_len=PAR_CTX,
                     max_new=PAR_GEN, timed=True))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = _ranks(workers.tp_runs, 2, SEED, runs, dtype=torch.bfloat16)
    log(f"parallel (a), (c), the arms, the fault and the timed (a): "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start-up")
    res, rr = [r[0] for r in out], [r[1] for r in out]
    _tp_line("(a) TPEngine tp 2", res[0])
    _tp_line("(a) TPEngine tp 2, collectives timed", out[0][5], timed=True)
    _rank_lines("(a)", res)
    _rank_lines("(a) timed", [r[5] for r in out], timed=True)
    _rank_counts("(a)", res, {"flash_attention", "block_topk_attention"},
                 total)
    tp_logits = res[0]["forced_logits"].to(dev)
    _hold_par("(a) TPEngine tp 2 against the single-process Engine",
              {"xla": ref.tokens, "auto": res[0]["tokens"]}, own, tp_logits)
    _tp_line("(c) generate_ring sp 2", rr[0])
    _rank_lines("(c)", rr)
    # the ring prefill attends in plain float32 (XLA einsums in JAX): no K2
    _rank_counts("(c)", rr, {"block_topk_attention"}, total)
    _hold_par("(c) generate_ring sp 2 against (a)'s generate",
              {"xla": res[0]["tokens"], "auto": rr[0]["tokens"]}, tp_logits,
              rr[0]["forced_logits"].to(dev))
    for i, (name, want) in enumerate((
            ("k3", {"flash_attention", "adc_block_scores",
                    "block_topk_attention"}),
            ("token", {"flash_attention", "adc_scores"}))):
        arm = [r[2 + i] for r in out]
        _rank_counts(f"(a) {name} arm", arm, want, total)
        _hold_par(f"(a) {name} arm tp 2 against the single-process Engine",
                  {"xla": refs[i], "auto": arm[0]["tokens"]}, owns[i],
                  arm[0]["forced_logits"].to(dev))
    _reject_par("(a) k3 arm with each rank's heads through the other "
                "shard's wo (planted fault)", owns[0],
                out[0][4]["forced_logits"].to(dev))


def par_tp_from_state(dev, params, model, cfg, ids, toks,
                      dtype=torch.bfloat16) -> None:
    """(a)'s decode at budget 0.2, held: the single-process prefill state of
    the 32k prompt, sliced per rank (``workers.tp_decode_state``), decoded
    by TPEngine tp 2 with the Engine's tokens ``toks`` fed in, every step
    within PAR_LOGIT_TOL of the single process's own decode from that
    state in bf16 (the all-reduce's rounding alone reads 0.13 at the first
    step on an H100), within LOGIT_TOL in float32, and each parting at a
    near tie. Both sides then select blocks from the same codebooks and
    codes, so this holds the sharded selection where selection prunes.
    Each rank also prefills the prompt itself: how many of its codes are
    the single process's (the codebooks' agreement), and its
    teacher-forced logits from its own state beside the single process's,
    printed."""
    pol = get_policy(cfg, compute_budget(cfg.budget, PAR_CTX, PAR_GEN), dev)
    lg, st = _prefill(model, params, pol, PAR_CTX, ids, dev, dtype)
    st_cpu = dataclasses.replace(st, **{
        f.name: getattr(st, f.name).cpu() for f in dataclasses.fields(st)
        if isinstance(getattr(st, f.name), torch.Tensor)})
    own = _decode_forced(model, params, pol, st, len(ids), toks, dev)
    del st, pol
    torch.cuda.empty_cache()
    what = "float32, plain route" if dtype == torch.float32 else "bf16"
    t0 = time.perf_counter()
    res = _ranks(workers.tp_decode_state, 2, cfg, SEED, st_cpu, toks[0],
                 len(ids), len(toks) - 1, PAR_CTX, PAR_GEN, forced=toks,
                 prompt=ids)
    del st_cpu
    log(f"parallel (a) {what}, budget 0.2, decode from the single-process "
        f"state: {time.perf_counter() - t0:.1f} s with the ranks' start-up;"
        f" each rank's own prefill gives the state's codes at "
        f"{[round(r['codes_agree'], 6) for r in res]} of the candidates, "
        f"centroids within {[r['centroids_max_diff'] for r in res]}")
    _hold_par(f"(a) {what}, TPEngine tp 2 decode at budget 0.2 from the "
              "single-process prefill state",
              {"xla": toks[1:], "auto": res[0]["tokens"]}, own,
              res[0]["logits"].to(dev),
              limit=LOGIT_TOL if dtype == torch.float32 else PAR_LOGIT_TOL)
    # the witness: each rank's own codebooks (not held: in bf16 and in
    # float32 alike k-means on keys that differ in rounding trains other
    # codebooks, and random weights' block top-k then parts, PERF.md)
    diffs = _step_diffs(res[0]["own_logits"].to(dev),
                        torch.cat([lg[None].float(), own.float()]))
    parts, diff, _ = _verdict(diffs, None)
    log(f"parallel (a) {what}, TPEngine tp 2 from its own prefill at "
        f"budget 0.2 (not held): largest |logit diff| {diff:.4f}, {parts} "
        f"partings; steps past PAR_LOGIT_TOL: "
        f"{[i for i, d in enumerate(diffs) if d[0] > PAR_LOGIT_TOL]}")


def par_tp_f32(dev, params, model) -> None:
    """(a) in float32 at budget 0.2 on the plain route (the kernels take
    bf16), as ``par_tp_from_state``: the second witness beside bf16's
    reading. In float32 the two runs' keys differ only in summation
    order."""
    cfg = par_cfg(model, PAR_CTX, PAR_GEN)
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, kernels="xla"))
    ids = np.random.default_rng(SEED + 30).integers(0, model.vocab_size,
                                                    PAR_CTX)
    p32 = params_to(params, dev, torch.float32)
    t0 = time.perf_counter()
    toks = Engine(cfg, p32, dtype=torch.float32, device=dev).generate(
        ids, PAR_GEN).tokens
    log(f"parallel (a) float32 single-process Engine (plain route): "
        f"{time.perf_counter() - t0:.1f} s")
    par_tp_from_state(dev, p32, model, cfg, ids, toks, torch.float32)


def _budget1(cfg):
    return dataclasses.replace(cfg, budget=dataclasses.replace(
        cfg.budget, compress_ratio=1.0))


def par_batch(dev, params, model, total: dict) -> None:
    """(b) BatchTPEngine dp 2 x tp 2 (4 processes), 4 slots of 8k prompts,
    against the single-device batched path (the same engine on a mesh of
    one), slot by slot (``_hold_par``)."""
    from pqcache_tpu_torch.parallel.batch_tp import BatchTPEngine
    from pqcache_tpu_torch.parallel.factory import make_mesh
    cfg = par_cfg(model, PAR_BATCH_CTX, PAR_GEN)
    rng = np.random.default_rng(SEED + 31)
    prompts = [rng.integers(0, model.vocab_size, PAR_BATCH_CTX - 97 * i)
               for i in range(PAR_SLOTS)]
    mesh = make_mesh(config.ParallelConfig(1, 1), dev)
    one = BatchTPEngine(cfg, params, mesh, PAR_BATCH_CTX, PAR_GEN)
    t0 = time.perf_counter()
    ref = one.generate_batch(prompts, PAR_GEN)
    torch.cuda.synchronize()
    t = one.timings
    log(f"parallel (b) single-device batched path (B {PAR_SLOTS}, eager): "
        f"{time.perf_counter() - t0:.1f} s, waves {t['prefill_s']:.2f} s, "
        f"decode {t['decode_s'] / t['steps'] * 1e3:.2f} ms a step")
    one = BatchTPEngine(_budget1(cfg), params, mesh, PAR_BATCH_CTX, PAR_GEN)
    forced = one.generate_batch(prompts, PAR_GEN)
    own = workers.batch_forced_logits(one, prompts, forced)
    del one
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = _ranks(workers.batch_generate, 4, cfg, SEED, 2, prompts,
                 PAR_BATCH_CTX, PAR_GEN, forced=forced,
                 forced_cfg=_budget1(cfg), dtype=torch.bfloat16)
    same = all(r["tokens"] == res[0]["tokens"] for r in res)
    t = res[0]["timings"]
    log(f"parallel (b) BatchTPEngine dp 2 x tp 2: "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start-up; waves "
        f"{t['prefill_s']:.2f} s, decode {t['decode_s'] / t['steps'] * 1e3:.2f}"
        f" ms a step; every rank returned the same {PAR_SLOTS} streams: "
        f"{same}")
    _rank_lines("(b)", res)
    _rank_counts("(b)", res, {"flash_attention", "block_topk_attention"},
                 total)
    if not same:
        raise SystemExit("parallel (b): ranks returned different streams")
    got = torch.cat([r["forced_logits"] for r in sorted(
        (r for r in res if r["forced_logits"] is not None),
        key=lambda r: r["dp_rank"])], 1)
    for s in range(PAR_SLOTS):
        _hold_par(f"(b) slot {s} against the single-device batched path",
                  {"xla": ref[s], "auto": res[0]["tokens"][s]}, own[:, s],
                  got[:, s])


def par_offload(dev, params, model, total: dict) -> None:
    """(d) ShardedOffloadEngine dp 1 x tp 2 (the offload phase's
    configuration), B 2 of 8k prompts, 24 tokens, against the
    single-device BatchOffloadEngine (``_hold_par``)."""
    from pqcache_tpu_torch.runtime.offload_batch import BatchOffloadEngine
    cfg = offload_cfg(model)
    rng = np.random.default_rng(SEED + 32)
    prompts = [rng.integers(0, model.vocab_size, PAR_OFFLOAD_CTX - 130 * i)
               for i in range(PAR_OFFLOAD_B)]
    core = BatchOffloadEngine(cfg, params, batch_size=PAR_OFFLOAD_B,
                              device=dev)
    ref = core.generate_batch(prompts, OFFLOAD_GEN)
    t = core.timings
    log(f"parallel (d) single-device BatchOffloadEngine B {PAR_OFFLOAD_B}: "
        f"{t['decode_s'] / t['steps'] * 1e3:.2f} ms a step, hit rate "
        f"{core.store.hit_rate:.4f}")
    core = BatchOffloadEngine(_budget1(cfg), params,
                              batch_size=PAR_OFFLOAD_B, device=dev)
    forced = core.generate_batch(prompts, OFFLOAD_GEN)
    own = workers.offload_forced_logits(core, prompts, forced)
    del core
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = _ranks(workers.offload_generate, 2, cfg, SEED, 1, prompts,
                 OFFLOAD_GEN, forced=forced, forced_cfg=_budget1(cfg),
                 dtype=torch.bfloat16)
    t = res[0]["timings"]
    log(f"parallel (d) ShardedOffloadEngine tp 2: "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start-up; "
        f"{t['decode_s'] / t['steps'] * 1e3:.2f} ms a step (host "
        f"{t['host_s'] / t['steps'] * 1e3:.2f}, wait "
        f"{t['wait_s'] / t['steps'] * 1e3:.2f}), hit rate over both "
        f"stores {res[0]['hit_rate']:.4f}")
    _rank_lines("(d)", res)
    _rank_counts("(d)", res, {"flash_attention"}, total)
    got = res[0]["forced_logits"]
    for s in range(PAR_OFFLOAD_B):
        _hold_par(f"(d) slot {s} against BatchOffloadEngine",
                  {"xla": ref[s], "auto": res[0]["tokens"][s]}, own[:, s],
                  got[:, s])


def par_kernels(dev) -> None:
    """(e) K2, K1 and K3 on this process (rank 0's card) at a tp 2 shard's
    shapes: 16 q / 4 kv heads at 32k (K2 with pad 768; K1 over 13 of the
    int8 tail's blocks per kv head; K3 over the codes of 4 kv heads),
    against their plain versions."""
    m = config.LLAMA31_8B
    H, H_kv, D, bs = m.num_heads // 2, m.num_kv_heads // 2, m.head_dim, 256
    g = torch.Generator(device=dev).manual_seed(SEED + 33)
    q, k, v = [t[0, :h].contiguous() for t, h in zip(
        _qkv(dev, g, 1, PAR_CTX), (H, H_kv, H_kv))]
    out = flash_attention(q, k, v, valid_lo=768)
    torch.cuda.synchronize()
    ref = chunked_attention(q, k, v, valid_lo=768)
    rel = row_rel_err(out, ref)
    log(f"parallel (e) K2 q [{H}, {PAR_CTX}, {D}], kv {H_kv} heads: max_abs_"
        f"err {(out.float() - ref.float()).abs().max().item():.3e}, worst row "
        f"||err||/||ref|| {rel:.3e} (tol {K2_TOL})")
    if not rel <= K2_TOL or not torch.isfinite(out).all():
        raise SystemExit("parallel (e): K2 disagrees at the shard's shapes")
    del q, k, v, out, ref
    rng = np.random.default_rng(SEED + 33)
    blk = torch.from_numpy(np.stack([np.sort(np.concatenate([
        [N_CAND // bs], rng.choice(N_CAND // bs, 12, replace=False)]))
        for _ in range(H_kv)])).to(dev)
    kv = torch.randint(-127, 128, (1, H_kv, N_TAIL, 2 * D), generator=g,
                       device=dev, dtype=torch.int8)
    qd = torch.randn((H, 1, D), generator=g, device=dev) * 0.01
    got = block_topk_attention(qd, kv, 0, blk, N_CAND, block=bs)
    torch.cuda.synchronize()
    want = block_topk_attention_ref(qd, kv, 0, blk, N_CAND, block=bs)
    rel = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
              for a, b in zip(got, want))
    log(f"parallel (e) K1 q [{H}, 1, {D}], int8 tail [{H_kv}, {N_TAIL}, "
        f"{2 * D}]: max_abs_err "
        f"{max((a - b).abs().max().item() for a, b in zip(got, want)):.3e}, "
        f"{rel:.3e} relative to the largest entry (tol {K1_TOL}); worst acc "
        f"row ||err||/||ref|| {row_rel_err(got[2], want[2]):.3e}")
    if not rel <= K1_TOL:
        raise SystemExit("parallel (e): K1 disagrees at the shard's shapes")
    lut, codes = _lut_codes(dev, 1)
    lut, codes = lut[:H_kv].contiguous(), codes[0, :H_kv].contiguous()
    got = adc_block_scores(lut, codes, N_CAND, sel_block=bs, head_dim=D)
    torch.cuda.synchronize()
    want = adc_block_scores_ref(lut, codes, N_CAND, sel_block=bs, head_dim=D)
    rel = ((got - want).abs() / want.abs().amax(-1, keepdim=True)).max().item()
    grp = H // H_kv
    same = torch.equal(
        pq.topk_from_block_mass(got, N_CAND, TOPK, group=grp, block=bs),
        pq.topk_from_block_mass(want, N_CAND, TOPK, group=grp, block=bs))
    log(f"parallel (e) K3 lut [{H_kv}, {H // H_kv}, 2, 64], codes "
        f"[{H_kv}, 2, {N_TAIL}]: "
        f"max_abs_err {(got - want).abs().max().item():.3e}, {rel:.3e} "
        f"relative to each row's largest entry (tol {K3_TOL}); block top-k "
        f"identical: {same}")
    if not rel <= K3_TOL or not same:
        raise SystemExit("parallel (e): K3 disagrees at the shard's shapes")


def parallel_phase(dev, params, model) -> dict:
    """(a)-(e) of the parallel phase; each run's kernel counts are set to 0
    in its ranks just before it and read just after. Returns the launches
    summed over the ranks."""
    total = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    par_kernels(dev)
    par_tp(dev, params, model, total)
    log(f"parallel (a), (c) done at {time.perf_counter() - t0:.0f} s")
    par_tp_f32(dev, params, model)
    log(f"parallel (a) float32 done at {time.perf_counter() - t0:.0f} s")
    par_batch(dev, params, model, total)
    log(f"parallel (b) done at {time.perf_counter() - t0:.0f} s")
    par_offload(dev, params, model, total)
    log(f"parallel phase {time.perf_counter() - t0:.0f} s; launches {total}")
    return total


# ---------------------------------------------------------------------------
# The evaluation path: the HF loader, the evaluation policies and branches,
# the LongBench command line at full depth, and synth_quality

EVAL_SELF_CHECKS = ("ip-block", "ip-token", "nogqa", "masked", "no_drop_lb",
                    "sparq_f")
LB_CTX = 8000             # whitespace words of context per LongBench sample
LB_POLICIES = [("original", []), ("pq_search", []),
               ("pq_search", ["--metric", "ip", "--exp-name", "ip"]),
               ("h2o", []), ("infllm", []), ("no_drop_lb", []),
               ("sparq_f", [])]
_HF_LAYER = {"wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
             "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
             "gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight",
             "down": "mlp.down_proj.weight",
             "ln1": "input_layernorm.weight",
             "ln2": "post_attention_layernorm.weight"}


def _write_safetensors(path: str, tensors: dict) -> int:
    """A plain safetensors writer: the 8-byte little-endian header length,
    the JSON header (bf16 tensors, data offsets from the header's end),
    then each tensor's bytes. Returns the bytes written."""
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().cpu().view(torch.uint8).numpy().data)
    return 8 + len(head) + off


def loader_check(dev, params, model) -> dict:
    """(a) A 2-layer checkpoint at Llama-3.1-8B widths in HF layout (linear
    weights [out, in]; config.json; two bf16 shards; no lm_head, so the
    loader ties it), written with the plain writer above, loaded on the
    card by models/loader.py: every tensor bit for bit what was written,
    then one block-path request whose first-token logits equal those of
    the same params built in memory. Returns the launches."""
    import tempfile
    from pqcache_tpu_torch.models import loader
    L = 2
    sp = {"embed": params["embed"], "final_norm": params["final_norm"],
          "layers": {k: v[:L] for k, v in params["layers"].items()}}
    sp["lm_head"] = sp["embed"].T.contiguous()          # tied
    rs = {"rope_type": "llama3", "factor": model.rope_scaling_factor,
          "low_freq_factor": model.rope_low_freq_factor,
          "high_freq_factor": model.rope_high_freq_factor,
          "original_max_position_embeddings":
              model.rope_original_max_position}
    hf = {"vocab_size": model.vocab_size, "hidden_size": model.hidden_size,
          "intermediate_size": model.intermediate_size,
          "num_hidden_layers": L, "num_attention_heads": model.num_heads,
          "num_key_value_heads": model.num_kv_heads,
          "rms_norm_eps": model.rms_norm_eps, "rope_theta": model.rope_theta,
          "rope_scaling": rs, "tie_word_embeddings": True,
          "max_position_embeddings": model.max_position_embeddings}
    shards = [{"model.embed_tokens.weight": sp["embed"]},
              {"model.norm.weight": sp["final_norm"]}]
    for i in range(L):
        for name, sub in _HF_LAYER.items():
            w = sp["layers"][name][i]
            shards[i][f"model.layers.{i}.{sub}"] = w.T if w.dim() == 2 else w
    total = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf, f)
        t = time.perf_counter()
        nbytes = sum(_write_safetensors(os.path.join(
            d, f"model-0000{i + 1}-of-00002.safetensors"), sh)
            for i, sh in enumerate(shards))
        write_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        cfg, lp = loader.load_hf_checkpoint(d, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    log(f"loader [{card()}]: {nbytes / 1e9:.3f} GB in 2 shards (written "
        f"in {write_s:.2f} s), loaded onto the card in {load_s:.2f} s: "
        f"{nbytes / 1e9 / load_s:.2f} GB/s (the files just written, read "
        f"through the page cache)")
    if dataclasses.replace(cfg, name=model.name) != dataclasses.replace(
            model, num_layers=L, tie_word_embeddings=True):
        raise SystemExit(f"loader: config {cfg} differs")
    flat = [(k, lp[k], sp[k]) for k in ("embed", "final_norm", "lm_head")]
    flat += [(k, lp["layers"][k], sp["layers"][k]) for k in _HF_LAYER]
    for name, got, ref in flat:
        if (got.dtype != torch.bfloat16 or got.shape != ref.shape
                or not torch.equal(got.view(torch.int16),
                                   ref.contiguous().view(torch.int16))):
            raise SystemExit(f"loader: {name} is not bit-equal to what was "
                             f"written")
    small = dataclasses.replace(model, num_layers=L)
    ids = np.random.default_rng(SEED + 30).integers(0, model.vocab_size,
                                                    4000)
    got = {}
    for what, p in (("loaded", lp), ("in memory", sp)):
        with _PrefillLogits() as rec:
            _zero_counts()
            res = Engine(engine_cfg(small, "block-bf16"), p,
                         device=dev).generate(ids, 8)
        want = _expected_launches("block-bf16", res.policy_name, L,
                                  len(res.tokens) - 1)
        if _counts() != want or res.policy_name != "pq_search":
            raise SystemExit(f"loader request ({what}): launches "
                             f"{_counts()}, expected {want}")
        for k in total:
            total[k] += want[k]
        got[what] = (rec.last, res.tokens)
    d = (got["loaded"][0] - got["in memory"][0]).abs().max().item()
    log(f"loader: block-path request (4000 tokens, 2 layers) from the loaded "
        f"params: first-token |logit diff| to the params in memory {d}; "
        f"tokens equal {got['loaded'][1] == got['in memory'][1]}")
    if not torch.equal(got["loaded"][0], got["in memory"][0]):
        raise SystemExit("loader: first-token logits differ")
    del lp, sp
    torch.cuda.empty_cache()
    return total


def _lb_data(d: str) -> None:
    """Two synthetic passage_count samples of LB_CTX whitespace words:
    paragraphs drawn from a few distinct ones, the answer their count."""
    rng = np.random.default_rng(SEED + 31)
    words = [f"tok{i}" for i in range(5000)]
    os.makedirs(os.path.join(d, "data"))
    with open(os.path.join(d, "data", "passage_count.jsonl"), "w") as f:
        for i in range(2):
            paras = [" ".join(rng.choice(words, 200)) for _ in range(5 + i)]
            pick = rng.integers(0, len(paras), LB_CTX // 200)
            ctx = "\n\n".join(f"Paragraph {j + 1}: {paras[p]}"
                              for j, p in enumerate(pick))
            f.write(json.dumps({"context": ctx, "answers": [str(5 + i)],
                                "length": LB_CTX}) + "\n")


class _Requests:
    """While active, keeps the GenerateResult of every Engine.generate."""

    def __enter__(self):
        self.seen, self._orig = [], Engine.generate

        def rec(eng, *a, **kw):
            res = self._orig(eng, *a, **kw)
            self.seen.append(res)
            return res
        Engine.generate = rec
        return self

    def __exit__(self, *exc):
        Engine.generate = self._orig


def _lb_expected(policy: str, L: int, requests: int, steps: int) -> dict:
    """The launches of a LongBench run: K2 per layer and request, K4 too
    for h2o and infllm, K5 per layer and decode step on pq_search's
    per-token path (the command line's default select_block 1)."""
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = requests * L
    if policy in SCORE_POLICIES:
        want["flash_scores"] = requests * L
    if policy == "pq_search":
        want["adc_scores"] = L * steps
    return want


def longbench_cli(dev) -> dict:
    """(c) harness/longbench.py's command line at random:llama-3.1 (32
    layers, Llama-3.1-8B widths, the whitespace tokenizer) on two
    synthetic passage_count samples of about 8k tokens (32 new tokens
    each), once per policy of LB_POLICIES; each run's kernel counts set to
    0 before it and read after, held to its path (K2 on every prefill, K4
    on h2o/infllm's, K5 per layer and decode step on pq_search's per-token
    path). Then a rerun that writes nothing (resume) and `score`. Prints
    each policy's TTFT and ms/token (the second sample's: the first pays
    the first launches). Returns the launches."""
    import tempfile
    from pqcache_tpu_torch.harness import longbench
    total = dict.fromkeys(KERNELS, 0)
    L = config.LLAMA31_8B.num_layers
    with tempfile.TemporaryDirectory() as d:
        _lb_data(d)
        base = ["predict", "--checkpoint", "random:llama-3.1", "--model",
                "llama-3.1", "--datasets", "passage_count", "--data-dir",
                os.path.join(d, "data"), "--out-dir", os.path.join(d, "pred")]
        for policy, extra in LB_POLICIES:
            _zero_counts()
            t = time.perf_counter()
            with _Requests() as rq:
                longbench.main(base + ["--compressor", policy] + extra)
            wall = time.perf_counter() - t
            got = _counts()
            want = _lb_expected(policy, L, len(rq.seen),
                                sum(len(r.tokens) - 1 for r in rq.seen))
            label = policy + (" ip" if "ip" in extra else "")
            if (len(rq.seen) != 2 or got != want
                    or {r.policy_name for r in rq.seen} != {policy}):
                raise SystemExit(f"longbench {label}: {len(rq.seen)} requests"
                                 f", launches {got}, expected {want}")
            for k in total:
                total[k] += got[k]
            r = rq.seen[-1]
            log(f"longbench {label} [{card()}] ({L} layers, "
                f"{len(rq.seen)} samples, "
                f"{wall:.1f} s with the model's random init): TTFT "
                f"{r.prefill_seconds * 1e3:.1f} ms, decode "
                f"{r.decode_seconds / max(len(r.tokens) - 1, 1) * 1e3:.2f} "
                f"ms/token over {len(r.tokens) - 1} steps (first sample "
                f"TTFT {rq.seen[0].prefill_seconds * 1e3:.1f} ms)")
        files = sorted(os.path.join(root, f) for root, _, fs in os.walk(
            os.path.join(d, "pred")) for f in fs if f.endswith(".jsonl"))
        sizes = [os.path.getsize(f) for f in files]
        with _Requests() as rq:
            longbench.main(base + ["--compressor", "pq_search"])
        if rq.seen or [os.path.getsize(f) for f in files] != sizes:
            raise SystemExit("longbench resume wrote again")
        for f in files:
            with open(f) as fh:
                rows = [json.loads(line) for line in fh]
            if len(rows) != 2 or not all(
                    r["input_tokens"] > LB_CTX and r["pred"] for r in rows):
                raise SystemExit(f"longbench output {f}: {rows}")
        longbench.main(["score", "--pred-dir", os.path.join(d, "pred")])
        with open(os.path.join(d, "pred", "result.json")) as fh:
            result = json.load(fh)
        if len(result) != len(LB_POLICIES) - 1 or len(files) != len(
                LB_POLICIES):
            raise SystemExit(f"longbench score: {result}")
    log(f"longbench: {len(files)} prediction files, the rerun wrote nothing, "
        f"score gave {len(result)} configurations")
    torch.cuda.empty_cache()
    return total


def synth_quality_check(dev) -> None:
    """(d) harness/synth_quality.py on the card: the copy model trained
    (N 96, 200 steps, batch 16, as tests/test_synth_quality.py) and
    evaluated through the Engine (float32, the plain versions, as the JAX
    harness evaluates) for original, pq_search, h2o and no_drop_lb, held
    to that test's gate."""
    from pqcache_tpu_torch.harness import synth_quality as sq
    cfg = sq.model_config(96)
    torch.cuda.synchronize()
    t = time.perf_counter()
    params = sq.train(cfg, 96, 200, batch=16, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    t = time.perf_counter()
    acc = sq.evaluate(cfg, params, ["original", "pq_search", "h2o",
                                    "no_drop_lb"], 96, eval_n=6, gen=12,
                      device=dev)
    log(f"synth_quality [{card()}]: trained in {train_s:.1f} s (200 "
        f"steps), evaluated "
        f"in {time.perf_counter() - t:.1f} s: accuracy {acc}")
    if not (acc["original"] >= 0.95 and acc["pq_search"] >= 0.90
            and acc["h2o"] <= acc["pq_search"] - 0.10):
        raise SystemExit(f"synth_quality gate failed: {acc}")


def evaluation_phase(dev, params, model) -> dict:
    """(a) the loader and (b) the evaluation branches' 2-layer
    kernels-vs-plain self-checks; the model's params are needed there.
    Returns the launches (the loader's requests and each self-check's
    kernel-route request)."""
    total = loader_check(dev, params, model)
    for engine in EVAL_SELF_CHECKS:
        got = self_check(dev, params, model, engine,
                         shared_compress=0.2 if engine != "ip-block"
                         else SELF_COMPRESS)
        for k in total:
            total[k] += got[k]
    return total


# seconds: past this, the 128k bench run (~25 s) is left out; the whole
# script reaches the bench phase at ~640 s on an H100 80GB HBM3 at 700 W
BENCH_128K_AFTER = 720


def bench_phase(t0: float) -> dict:
    """The port's bench driver (``pqcache_tpu_torch/bench.py``) at bench.py's
    defaults (32k, B 8, 8 layers, W8 weights and an int8 tail against the
    bf16 `original` arm), then, unless the script has run past
    BENCH_128K_AFTER seconds, at bench.py's chunked-prefill case
    (BENCH_CTX=131072 BENCH_BATCH=1 BENCH_SKIP_BASE=1). Each prints its JSON
    line; counts are set to 0 before each run and read after it. Returns
    the launches."""
    total = dict.fromkeys(KERNELS, 0)
    runs = [dict(), dict(BENCH_CTX="131072", BENCH_BATCH="1",
                         BENCH_SKIP_BASE="1")]
    for env in runs:
        if env and time.perf_counter() - t0 > BENCH_128K_AFTER:
            log(f"bench at {env}: left out, the script has run "
                f"{time.perf_counter() - t0:.0f} s")
            continue
        kw = bench.settings(env)
        model = bench.bench_model(kw.pop("layers"), kw.pop("mlp_chunk"))
        _zero_counts()
        t = time.perf_counter()
        line = bench.run(model, **kw)
        got = _counts()
        log(f"bench {env or 'defaults'} ({time.perf_counter() - t:.0f} s, "
            f"launches {got}):")
        log(json.dumps(line))
        if not (line["value"] > 0 and got["w8_matmul"] > 0
                and got["flash_attention"] > 0):
            raise SystemExit(f"bench run at {env} failed: {line}")
        for k in total:
            total[k] += got[k]
        torch.cuda.empty_cache()
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global _TRACES
    _TRACES = tempfile.TemporaryDirectory(prefix="chip_smoke_traces_")
    t0 = time.perf_counter()
    environment()
    entries = [k2_phase(dev), k4_phase(dev), k1_phase(dev), k3_phase(dev),
               k5_phase(dev), k6_phase(dev)]
    entries.append(w8_step_entry(dev, w8_phase(dev)))
    log(f"kernel phases done at {time.perf_counter() - t0:.0f} s")

    model = dataclasses.replace(config.LLAMA31_8B, num_layers=LAYERS)
    log(f"model {model.name}: {model.num_layers} layers, hidden "
        f"{model.hidden_size}, heads {model.num_heads}/{model.num_kv_heads}, "
        f"vocab {model.vocab_size} (random weights, seed {SEED})")
    params = llama.init_params(model, torch.Generator(device=dev).manual_seed(
        SEED), dtype=torch.bfloat16, device=dev)
    launches = main_path(dev, params, model)
    log(f"main path done at {time.perf_counter() - t0:.0f} s; launches "
        f"{launches}")
    t_trace = time.perf_counter()
    for engine in TRACE_ENGINES:
        decode_profile(dev, params, model, engine)
    torch.cuda.empty_cache()
    trace_clis(dev)
    log(f"trace phase done at {time.perf_counter() - t0:.0f} s "
        f"({time.perf_counter() - t_trace:.1f} s)")
    self_check(dev, params, model, "block-bf16")
    self_check(dev, params, model, "token", shared_compress=0.2)
    self_check(dev, params, model, "k3")
    score_self_check(dev, params, model, "h2o-sum")
    score_self_check(dev, params, model, "infllm")
    log(f"self-checks done at {time.perf_counter() - t0:.0f} s")
    k1_entry, batched, replayed = batched_phase(dev, params, model)
    for k, v in batched.items():
        launches[k] += v
    batched_self_check(dev, params, model, "jhist", jhist_defer="on")
    batched_self_check(dev, params, model, "k3", scorer="kernel")
    batched_self_check(dev, params, model, "token", select_block=1,
                       adc_mode="v2")
    log(f"batched phase done at {time.perf_counter() - t0:.0f} s; launches "
        f"{batched} from the wrappers, {replayed} replayed from the graphs")
    # the kernels line takes K1 at the batched path's shapes (K5's entry
    # is already the K5 phase's batched one)
    entries = [k1_entry if e["name"] == k1_entry["name"] else e
               for e in entries]
    for k, v in offload_phase(dev, params, model).items():
        launches[k] += v
    log(f"offload phase done at {time.perf_counter() - t0:.0f} s")
    for k, v in parallel_phase(dev, params, model).items():
        launches[k] += v
    log(f"parallel phase done at {time.perf_counter() - t0:.0f} s")
    eval_launches = evaluation_phase(dev, params, model)
    for k, v in eval_launches.items():
        launches[k] += v
    del params
    torch.cuda.empty_cache()
    evaluated = longbench_cli(dev)
    synth_quality_check(dev)
    for k, v in evaluated.items():
        launches[k] += v
        evaluated[k] += eval_launches[k]
    log(f"evaluation phase done at {time.perf_counter() - t0:.0f} s; "
        f"launches {evaluated}")
    served, served_replayed = serving_phase(dev)
    for k, v in served.items():
        launches[k] += v
        replayed[k] += served_replayed[k]
    log(f"serving phase done at {time.perf_counter() - t0:.0f} s; launches "
        f"{served} from the wrappers, {served_replayed} replayed from the "
        f"graphs (replays x launches per step)")
    for k, v in bench_phase(t0).items():
        launches[k] += v
    # launches: the wrappers' counts (eager calls and captures);
    # replayed_launches: the kernels the batched graphs' replays ran
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["replayed_launches"] = replayed[e["name"]]
        if not e["launches"]:
            raise SystemExit(f"{e['name']} never launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches",
            "replayed_launches", "max_abs_err",
            "max_row_rel_err", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    _TRACES.cleanup()
    log(f"total {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
