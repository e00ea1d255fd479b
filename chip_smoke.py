"""Quickest proof that the PyTorch port runs on an NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pqcache_tpu_torch/csrc``, holds each
(K1–K6) against its plain PyTorch version at the main path's shapes (K2
also on the serving path's admission slabs at q_offset), serves requests
through ``Engine.generate`` at Llama-3.1-8B width and 8 layers (random
weights from a seeded generator) on the block path (joint-histogram scorer + K1),
the per-token path (select_block 1: K5, and K6 with gather_mode "pallas"),
the fused block-scorer path (K3 + K1) and the score-reading policies h2o
("sum" and "max") and infllm (K2 + K4 at prefill), checks that each request
launched exactly the kernels of its path, profiles a few decode steps of
each path (device time and launches per step), then holds the kernels
against the plain versions end to end at reduced depth. Then bench.py's
batched protocol at 8 layers: one 32k prompt inserted into B = 8 and B = 1
slots, pq_search (int8 tail, K1 with the local window), its per-token arm
(BENCH_PQ_BLOCK=1: K5 at 64 folded heads) and `original`, one chunk
decoded eagerly and replayed from a CUDA graph with identical tokens and
states, launches per step by stage, device busy share, capture time and
peak memory; K1 at the batched shapes, K3 at B 8, and 2-layer batched
kernels-vs-plain checks. The W8 kernel (weight-only int8 decode products)
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
runs ``harness/latency.py`` at 32k (K5 on the pq arm). Then the port's
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
import json
import subprocess
import sys
import time

import numpy as np
import torch

from pqcache_tpu_torch import bench, config
from pqcache_tpu_torch.core import pq, quant
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
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
from pqcache_tpu_torch.ops.w8 import w8_matmul
from pqcache_tpu_torch.policies import h2o, infllm
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime import stages
from pqcache_tpu_torch.runtime.generate import Engine, bucket_length
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
    with torch.cuda.graph(graph):
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


def environment() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc '{nvcc[-1]}' "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    _build.build_all(verbose=True)
    log(f"kernel build {_build.build_seconds:.1f} s")


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
    and 24576, SLAB_OFFSETS). At 32768
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
    return entry


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
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
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

KERNELS = {"flash_attention": flash_attention,
           "flash_scores": flash_scores,
           "block_topk_attention": block_topk_attention,
           "adc_scores": adc_scores, "adc_block_scores": adc_block_scores,
           "gather_rows": gather_rows, "w8_matmul": w8_matmul}


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
            prefill_chunk=e.get("prefill_chunk", 0)))


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
        dec = {"block_topk_attention"} | ({"adc_block_scores"} if pq_kw.get(
            "scorer") == "kernel" else set())
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


def decode_profile(dev, params, model, engine: str, n_prompt: int = 32000,
                   steps: int = 4) -> None:
    """Where a decode step's time goes: torch.profiler over `steps` decode
    steps after the prefill of one request. Prints the device time per step
    (the sum of the CUDA kernels' own times, one stream, so they do not
    overlap), the kernel launches per step and the kernels that take the
    most device time, beside the profiled wall time per step. The profiler
    adds host time per op, so the device's busy share is read against the
    unprofiled decode ms/token of the main path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(engine_cfg(model, engine), params, device=dev)
    ids = np.random.default_rng(SEED + 2).integers(0, model.vocab_size,
                                                   n_prompt)
    it = eng.generate_stream(ids, steps + 1, chunk=steps)
    next(it)                                  # prefill and the first token
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        toks = list(it)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    if len(toks) != steps:
        raise SystemExit(f"decode profile ({engine}): {len(toks)} tokens")
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / steps
    if not ev or dev_ms <= 0:
        log(f"decode profile {engine} prompt={n_prompt}: the profiler saw no "
            f"device time (not measured); wall {wall_ms:.2f} ms/step")
        return
    launches = sum(e.count for e in ev) / steps
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    log(f"decode profile {engine} prompt={n_prompt}: device "
        f"{dev_ms:.3f} ms/step in {launches:.0f} kernel launches/step; wall "
        f"under the profiler {wall_ms:.2f} ms/step; top kernels (ms/step): "
        + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / steps:.3f}"
                    for e in top))


def _policy(model, engine: str, kernels: str, n_prompt: int, dev,
            compress: float = SELF_COMPRESS):
    cfg = engine_cfg(model, engine, kernels, compress)
    P = bucket_length(n_prompt, cfg.runtime.prefill_bucket)
    return get_policy(cfg, compute_budget(cfg.budget, P,
                                          cfg.runtime.max_new_tokens), dev), P


def _prefill(model, params, pol, P, ids, dev):
    state = pol.init_state(torch.bfloat16)
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
               shared_compress: float = SELF_COMPRESS):
    """kernels="auto" against kernels="xla" (the plain versions) at reduced
    depth. Held to LOGIT_TOL: the prefill logits (K2 against its plain
    version) and the logits of each decode step taken from one shared state
    (same codebooks and tail), at budget ``shared_compress``. Greedy tokens
    of the two Engine.generate runs must agree up to a step where their
    logits differ by more than half the top-2 gap (a near tie, after which
    the sequences are not comparable); each run trains its own codebooks on
    its own prefill K, so logits may part further there.

    Random weights give nearly uniform block masses, so a block top-k of 2
    of 12 blocks parts at near ties that are noise, not kernel error. The
    whole-run comparison therefore uses a budget (compress 1.0, a
    3072-token prompt, 15 decode steps) whose top-k selects every candidate
    at every step; for block selection the last block is cut by n_cand, so
    K1 still masks rows. On the per-token path K5 and K6 are exact, so the
    shared-state steps run at the main path's budget 0.2 and their per-token
    selections must be identical."""
    small, sp, ids = _small(model, params)
    toks, own, P = _both_routes(small, sp, ids, engine, SELF_COMPRESS, dev)
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
    per_token = ENGINES[engine]["pq"]["select_block"] == 1
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
    forcing with the plain route's tokens. on_prefill(kernels) is a context
    manager entered around each route's prefill."""
    toks, own = {}, {}
    policy = ENGINES[engine].get("policy", "pq_search")
    for kernels in ("auto", "xla"):
        cfg = engine_cfg(small, engine, kernels, compress)
        res = Engine(cfg, sp, device=dev).generate(ids, SELF_TOKENS)
        if res.policy_name != policy:
            raise SystemExit(f"self-check must run the {policy} path")
        toks[kernels] = res.tokens
    for kernels in ("auto", "xla"):
        pol, P = _policy(small, engine, kernels, len(ids), dev, compress)
        with on_prefill(kernels) if on_prefill else contextlib.nullcontext():
            lg, st = _prefill(small, sp, pol, P, ids, dev)
        own[kernels] = torch.cat([lg[None], _decode_forced(
            small, sp, pol, st, len(ids), toks["xla"], dev)])
    return toks, own, P


def _check_greedy(engine: str, toks: dict, own: dict) -> None:
    """The greedy tokens of the two routes agree up to a step where their
    logits differ by more than half the top-2 gap (a near tie, after which
    the sequences are not comparable)."""
    ref = toks["xla"]
    first = next((i for i, (a, b) in enumerate(zip(toks["auto"], ref))
                  if a != b), None)
    if first is None:
        log(f"self-check {engine}: greedy tokens equal {len(ref)}/{len(ref)}")
        return
    top2 = own["xla"][first].topk(2).values
    gap = (top2[0] - top2[1]).item()
    d = (own["auto"][first] - own["xla"][first]).abs().max().item()
    log(f"self-check {engine}: greedy tokens equal up to step {first} of "
        f"{len(ref)}; there the top-2 gap is {gap:.4f} and the runs' "
        f"logits differ by {d:.4f}")
    if gap > 2 * d:
        raise SystemExit("greedy tokens differ away from a near tie")


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
    policies; its logits part only through the prefill state."""
    small, sp, ids = _small(model, params)
    errs = {}

    def on_prefill(kernels):
        errs[kernels] = _ScoreErrors()
        return errs[kernels]
    toks, own, _ = _both_routes(small, sp, ids, engine, 0.2, dev,
                                on_prefill)
    pre_diff = (own["auto"][0] - own["xla"][0]).abs().max().item()
    k4 = errs["auto"].rel
    log(f"self-check {engine} ({SELF_LAYERS} layers): prefill |logit diff| "
        f"{pre_diff:.4f} (tol {LOGIT_TOL}); K4 per prefill layer, largest "
        f"|err| per head over its largest entry "
        f"{[f'{x:.2e}' for x in k4]} (tol {K4_TOL})")
    _check_greedy(engine, toks, own)
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
# profiled steps, a whole profiled chunk), reserved as max_new_tokens
BATCH_STEPS = 3 * BATCH_GEN + BATCH_PROFILE
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


def _counts() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def _zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _profile(run, steps: int) -> dict:
    """torch.profiler over run() (a chunk of `steps` steps and its flush):
    device kernels per step by name and their device ms per step; host
    launches per step (kernel launches, graph launches) attributed to the
    stage ranges that hold them (runtime/stages.py), and device ms per
    step attributed to the stage ranges' device spans that hold each
    kernel's start (marked steps only: an eager run under recording())."""
    import bisect
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evs = prof.events()
    # device events: kernels (not copies, not the stage marks' own device
    # ranges, which span their kernels)
    dev_ev = [e for e in evs if e.device_type == DeviceType.CUDA
              and not e.name.startswith(("Memcpy", "Memset", stages.PREFIX))]
    by_name = {}
    for e in dev_ev:
        by_name[e.name] = by_name.get(e.name, 0) + 1
    ranges = sorted((e.time_range.start, e.time_range.end,
                     e.name[len(stages.PREFIX):]) for e in evs
                    if e.name.startswith(stages.PREFIX))
    starts = [r[0] for r in ranges]
    by_stage, graph_launches = {}, 0
    for e in evs:
        if e.device_type == DeviceType.CUDA:
            continue
        if "GraphLaunch" in e.name:
            graph_launches += 1
        if "LaunchKernel" not in e.name:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        st = (ranges[i][2] if i >= 0 and e.time_range.start < ranges[i][1]
              else "other")
        by_stage[st] = by_stage.get(st, 0) + 1
    dev_t = {}
    for e in dev_ev:
        dev_t[e.name] = dev_t.get(e.name, 0.0) + e.self_device_time_total
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len(stages.PREFIX):]) for e in evs
                   if e.device_type == DeviceType.CUDA
                   and e.name.startswith(stages.PREFIX))
    span_starts = [r[0] for r in spans]
    dev_stage = {}
    for e in dev_ev:
        i = bisect.bisect_right(span_starts, e.time_range.start) - 1
        st = (spans[i][2] if i >= 0 and e.time_range.start < spans[i][1]
              else "other")
        dev_stage[st] = dev_stage.get(st, 0.0) + e.self_device_time_total
    top = sorted(dev_t.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        kernels=len(dev_ev) / steps,
        dev_ms=sum(e.self_device_time_total for e in dev_ev) / 1e3 / steps,
        top="; ".join(f"{k[:56]} {v / 1e3 / steps:.3f}" for k, v in top),
        host_launches=sum(by_stage.values()) / steps,
        graph_launches=graph_launches / steps,
        by_stage={k: v / steps for k, v in sorted(by_stage.items())},
        dev_stage={k: v / 1e3 / steps for k, v in sorted(dev_stage.items())},
        by_name=by_name)


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
    with stages.recording():
        prof_eager = _profile(lambda: eager.decode(
            want[-1], pos + n, steps), steps)
    _zero_counts()
    prof_replay = _profile(lambda: replay.decode(
        got[-1], pos + 2 * n, steps), steps)
    replay_counted = _counts()
    path = BATCH_ARMS[name][2]

    def path_seen(profiles):
        return {k: sum(c for pr in profiles for nm, c in pr["by_name"].items()
                       if DEVICE_NAMES[k] in nm) for k in path}
    seen = path_seen([prof_replay])
    whole = ""
    if name == "pq_search" and B == 8:
        replay.begin(got[-1], pos + 2 * n + steps)
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
        f"during the replays {replay_counted}; top kernels (ms/step): "
        + prof_replay["top"] + whole)
    want_eager = {k: n * _per_step(k, L) * (k in path) for k in KERNELS}
    want_capture = {k: 2 * _per_step(k, L) * (k in path) for k in KERNELS}
    if (not same_tokens or not same_state or eager_counts != want_eager
            or capture_counts != want_capture
            or any(seen[k] != _per_step(k, L) * steps for k in path)
            or any(replay_counted.values())
            or not bool(((got >= 0) & (got < model.vocab_size)).all())):
        raise SystemExit(
            f"batched {name} B={B} failed: tokens {same_tokens}, states "
            f"{same_state}, eager launches {eager_counts} (expected "
            f"{want_eager}), capture {capture_counts} (expected "
            f"{want_capture}), replayed path kernels {seen}")
    replayed = {k: replay.replays * seen[k] // steps for k in path}
    out = dict(eager_ms=eager_ms, replay_ms=replay_ms, peak_gib=peak,
               capture_s=replay.capture_seconds, counts=eager_counts,
               replayed=replayed,
               capture_counts=capture_counts, bstate=bstate)
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
            for counts in (r["counts"], r["capture_counts"]):
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


BENCH_128K_AFTER = 600    # seconds: past this, the 128k bench run is left out


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
    for engine in ("block-bf16", "token", "k3", "h2o-sum", "infllm"):
        decode_profile(dev, params, model, engine)
    log(f"decode profiles done at {time.perf_counter() - t0:.0f} s")
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
    del params
    torch.cuda.empty_cache()
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
    log(f"total {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
