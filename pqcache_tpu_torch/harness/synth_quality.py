"""Asset-free quality evidence: a trained model through the port's engine.

Counterpart of ``pqcache_tpu/harness/synth_quality.py``. With no checkpoint
at hand, LongBench, GSM8K and NAH runs on random weights score noise; this
harness trains a 2-layer model on the copy (induction-head) task instead,

    x1 x2 ... xn | x1 x2 ... xn          (LM loss on the second half)

and evaluates it through the inference ``Engine``: prompt = the first half
and the first k tokens of the repeat; the model must free-run the
continuation by attending, at each generated token, to the position after
the previous occurrence of its last token. Those positions lie in the
early prompt, far outside the decode local window at compress 0.2 and
recent 0.5, so pq_search scores only if its retrieval finds them among the
evicted middle: the paper's central claim (quality with 1/5 of the tokens
attending, README.md:18) and what the reference's needle-in-a-haystack
harness measures on real checkpoints (test_nah.py:17-92). Baselines under
the same budget: h2o (accumulated-score eviction), no_drop_lb (the
exact-score oracle) and original (full attention, the task's ceiling).

Training is plain autograd in float32 with AdamW exactly as
``optax.adamw(lr)`` computes it (b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
weight decay 1e-4 on every parameter; torch's AdamW defaults to 0.01).
The engines evaluate in float32 with ``kernels="xla"``, as the JAX harness
does: the plain versions, at head_dim 32.

Usage (on the card; ``--device cpu`` for the CPU):
  python -m pqcache_tpu_torch.harness.synth_quality [--n 200] [--steps 600]
      [--eval-n 32] [--gen 24] [--task copy|recall] [--offload-locality]
Prints one JSON line: per-policy mean per-token copy accuracy.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import (BudgetConfig, CacheConfig, EngineConfig,
                                      ModelConfig, PQConfig, RuntimeConfig)
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.models.llama import (apply_rope, mlp, rms_norm,
                                            rope_cos_sin)

VOCAB = 514          # ids [2, 514) are content tokens; 0/1 reserved


def model_config(n: int) -> ModelConfig:
    return ModelConfig(
        name="synthcopy", vocab_size=VOCAB, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=4,
        head_dim=32, rope_theta=10000.0,
        max_position_embeddings=4 * (2 * n + 2))


def gen_copy(rng: np.random.Generator, n: int, batch: int) -> np.ndarray:
    """[B, 2n] sequences whose second half repeats the first."""
    seq = rng.integers(2, VOCAB, size=(batch, n))
    return np.concatenate([seq, seq], axis=1).astype(np.int32)


def gen_copy_varlen(rng: np.random.Generator, n: int, batch: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """[B, 2n] cyclic repeats of a prefix of variable length n' (uniform in
    [n/2, n]): position t >= n' copies t - n'. A fixed-offset circuit cannot
    solve it: the model must form a content-matching induction head, which
    is what zero-shot associative recall needs. Returns (tokens,
    n_prime [B])."""
    n_p = rng.integers(n // 2, n + 1, size=batch)
    seq = np.empty((batch, 2 * n), np.int32)
    for b in range(batch):
        x = rng.integers(2, VOCAB, size=n_p[b])
        reps = -(-2 * n // n_p[b])
        seq[b] = np.tile(x, reps)[: 2 * n]
    return seq, n_p.astype(np.int32)


# -- associative recall (multi-needle with distractors) ----------------------
#
# The NAH-like point-retrieval task, evaluated zero-shot on the
# copy-trained model: m unique (key, value, value) triplets, then a query
# key; the answer's first token comes from the prefill (dense for every
# policy), its second from a decode step whose lookup targets the queried
# triplet deep in the evicted middle.

KEY_LO, KEY_HI = 2, 172          # key alphabet
V1_LO, V1_HI = 172, 342          # first-value alphabet
V2_LO, V2_HI = 342, VOCAB        # second-value alphabet


def gen_kv(rng: np.random.Generator, m: int, batch: int,
           depth: float | None = None) -> tuple[np.ndarray, int]:
    """[B, 3m+3] sequences ``k1 v11 v12 ... km vm1 vm2 kq a1 a2`` with unique
    keys and unique first values. depth: the queried triplet's position as
    a fraction (0 = oldest), None = uniform. Returns (tokens,
    a1_pos = 3m+1)."""
    if m > KEY_HI - KEY_LO or m > V1_HI - V1_LO:
        raise ValueError(f"at most {KEY_HI - KEY_LO} pairs")
    keys = np.stack([rng.permutation(np.arange(KEY_LO, KEY_HI))[:m]
                     for _ in range(batch)])
    v1 = np.stack([rng.permutation(np.arange(V1_LO, V1_HI))[:m]
                   for _ in range(batch)])
    v2 = rng.integers(V2_LO, V2_HI, size=(batch, m))
    if depth is None:
        qi = rng.integers(0, m, size=batch)
    else:
        qi = np.full((batch,), min(int(m * depth), m - 1))
    seq = np.empty((batch, 3 * m + 3), np.int32)
    seq[:, 0:3 * m:3] = keys
    seq[:, 1:3 * m + 1:3] = v1
    seq[:, 2:3 * m + 2:3] = v2
    ar = np.arange(batch)
    seq[:, 3 * m] = keys[ar, qi]
    seq[:, 3 * m + 1] = v1[ar, qi]
    seq[:, 3 * m + 2] = v2[ar, qi]
    return seq, 3 * m + 1


def _engine_config(cfg: ModelConfig, name: str, T: int, max_new: int,
                   max_seq: int, compress_ratio: float, metric: str,
                   kv_dtype: str, **pq_kw) -> EngineConfig:
    """The evaluation engines' configuration (synth_quality.py:157-164,
    270-277): float32 plain versions, exact top-k, 64 centroids."""
    return EngineConfig(
        model=cfg,
        pq=PQConfig(n_subvec_per_head=2, n_subbits=6, kmeans_iters=12,
                    approx_topk=False, metric=metric, **pq_kw),
        budget=BudgetConfig(compress_ratio=compress_ratio, recent_ratio=0.5,
                            sink_size=4),
        cache=CacheConfig(
            kv_dtype=kv_dtype if name == "pq_search" else "bf16"),
        runtime=RuntimeConfig(policy=name, prefill_bucket=T,
                              max_new_tokens=max_new, max_seq_len=max_seq,
                              kernels="xla"))


def evaluate_kv(cfg: ModelConfig, params: dict, policies, m: int,
                eval_n: int = 64, depth: float | None = None, seed: int = 7,
                compress_ratio: float = 0.1, metric: str = "euc",
                kv_dtype: str = "bf16", device=None, **pq_kw):
    """Per-policy recall accuracy through the inference Engine: prompt =
    the triplets and the query key; the first answer token scored from the
    prefill, the second (the decode retrieval) where the first was right."""
    from pqcache_tpu_torch.runtime.generate import Engine
    rng = np.random.default_rng(seed)
    toks, apos = gen_kv(rng, m, eval_n, depth=depth)
    prompt = toks[:, :apos]
    t1, t2 = toks[:, apos], toks[:, apos + 1]
    T = prompt.shape[1]
    out = {}
    for name in policies:
        eng = Engine(_engine_config(cfg, name, T, 4, 2 * (T + 8),
                                    compress_ratio, metric, kv_dtype,
                                    **pq_kw),
                     params, dtype=torch.float32, device=device)
        c1 = c2 = 0
        for i in range(eval_n):
            res = eng.generate(prompt[i], max_new_tokens=2)
            c1 += int(res.tokens[0] == t1[i])
            c2 += int(res.tokens[0] == t1[i] and res.tokens[1] == t2[i])
        out[name] = {"a1_prefill": round(c1 / eval_n, 4),
                     "a2_decode_retrieval": round(c2 / max(c1, 1), 4)}
    return out


def lm_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Dense causal training forward -> logits [B, T, V] f32, over the
    inference stack's params layout (models/llama.py), so the trained
    weights drop straight into the Engine and the policies."""
    B, T = tokens.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hidden = params["embed"][tokens]                        # [B, T, E]
    cos, sin = rope_cos_sin(cfg, torch.arange(T, device=tokens.device))
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=tokens.device))
    lay = params["layers"]
    for i in range(cfg.num_layers):
        lp = {k: v[i] for k, v in lay.items()}
        hn = rms_norm(hidden, lp["ln1"], cfg.rms_norm_eps)
        q = (hn @ lp["wq"]).reshape(B, T, H, D).transpose(1, 2)
        k = (hn @ lp["wk"]).reshape(B, T, Hkv, D).transpose(1, 2)
        v = (hn @ lp["wv"]).reshape(B, T, Hkv, D).transpose(1, 2)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if H != Hkv:
            k = k.repeat_interleave(H // Hkv, 1)
            v = v.repeat_interleave(H // Hkv, 1)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D)
        s = torch.where(causal, s, -1e30)
        attn = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
        hidden = hidden + attn.transpose(1, 2).reshape(B, T, H * D) @ lp["wo"]
        hn2 = rms_norm(hidden, lp["ln2"], cfg.rms_norm_eps)
        hidden = hidden + mlp(lp, hn2.reshape(B * T, -1)).reshape(B, T, -1)
    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    return (hidden @ params["lm_head"]).float()


def loss_fn(cfg: ModelConfig, params: dict, toks: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Masked mean next-token cross-entropy (optax's
    softmax_cross_entropy_with_integer_labels: logsumexp - target logit)."""
    logits = lm_forward(cfg, params, toks)[:, :-1]
    labels = toks[:, 1:].long()
    ce = (torch.logsumexp(logits, -1)
          - logits.gather(-1, labels[..., None])[..., 0])
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _leaves(params: dict) -> list:
    return [v for k, v in params.items() if k != "layers"] + list(
        params["layers"].values())


def _adamw_step(leaves, grads, mu, nu, count: int, lr: float, b1=0.9,
                b2=0.999, eps=1e-8, weight_decay=1e-4) -> None:
    """optax.adamw(lr) in place: scale_by_adam (eps_root 0), then
    add_decayed_weights on every parameter, then -lr."""
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    for p, g, m, v in zip(leaves, grads, mu, nu):
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * g * g + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p
        p.add_(-lr * u)


def train(cfg: ModelConfig, n: int, steps: int, batch: int = 32,
          lr: float = 2e-3, seed: int = 0, log_every: int = 0,
          varlen: bool = False, device=None) -> dict:
    """AdamW on the second-half LM cross-entropy, float32 params
    throughout, initialised from ``torch.Generator(device).manual_seed(
    seed)``. varlen=True trains on variable-offset cyclic repeats
    (content-based induction; the recall evaluation needs it)."""
    device = resolve_device(device)
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), dtype=torch.float32, device=device)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    rng = np.random.default_rng(seed)
    pos = np.arange(1, 2 * n)
    for i in range(steps):
        if varlen:
            toks, n_p = gen_copy_varlen(rng, n, batch)
            mask = (pos[None, :] >= n_p[:, None]).astype(np.float32)
        else:
            toks = gen_copy(rng, n, batch)
            mask = np.broadcast_to((pos >= n).astype(np.float32),
                                   (batch, 2 * n - 1))
        loss = loss_fn(cfg, params, torch.from_numpy(toks).to(device),
                       torch.from_numpy(np.ascontiguousarray(mask)).to(
                           device))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            _adamw_step(leaves, grads, mu, nu, i + 1, lr)
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1}: loss {loss.item():.4f}", flush=True)
    for p in leaves:
        p.requires_grad_(False)
    return params


def evaluate(cfg: ModelConfig, params: dict, policies, n: int,
             eval_n: int = 32, gen: int = 24, k_prefix: int = 4,
             seed: int = 123, compress_ratio: float = 0.2,
             kv_dtype: str = "bf16", metric: str = "euc", device=None,
             **pq_kw):
    """Per-policy mean per-token copy accuracy through the inference
    Engine: prompt [x1..xn x1..xk], free-run ``gen`` tokens, compare to
    x_{k+1}..x_{k+gen}."""
    from pqcache_tpu_torch.runtime.generate import Engine
    rng = np.random.default_rng(seed)
    toks = gen_copy(rng, n, eval_n)
    prompt = toks[:, :n + k_prefix]
    target = toks[:, n + k_prefix:n + k_prefix + gen]
    T = prompt.shape[1]
    out = {}
    for name in policies:
        eng = Engine(_engine_config(cfg, name, T, gen + 2, 2 * (T + gen),
                                    compress_ratio, metric, kv_dtype,
                                    **pq_kw),
                     params, dtype=torch.float32, device=device)
        correct = total = 0
        for i in range(eval_n):
            res = eng.generate(prompt[i], max_new_tokens=gen)
            got = np.asarray(res.tokens[:gen])
            correct += int((got == target[i, :len(got)]).sum())
            total += len(got)
        out[name] = round(correct / max(total, 1), 4)
    return out


def _trained(args, varlen: bool = False):
    """(model config, trained params, training seconds) at args.n."""
    cfg = model_config(args.n)
    t0 = time.perf_counter()
    params = train(cfg, args.n, args.steps, batch=args.batch,
                   log_every=max(args.steps // 6, 1), varlen=varlen,
                   device=args.device)
    train_s = time.perf_counter() - t0
    if args.weight_int8:
        from pqcache_tpu_torch.core import quant
        params = quant.quantize_weight_tree(params)
    return cfg, params, train_s


def run_offload_locality(args) -> None:
    """Train the copy model at --n, then free-run ~n decode steps through
    the OffloadEngine while sweeping the device cache fraction: a trained
    induction head's block selections advance about one token a step, so
    the LFU's hit rate should beat the cache fraction (random weights give
    near-uniform selections, whose hit rate is the fraction). A
    random-weights control at one fraction."""
    from pqcache_tpu_torch.runtime.offload_engine import OffloadEngine
    n = args.n
    cfg, params, train_s = _trained(args)
    rng = np.random.default_rng(321)
    toks = gen_copy(rng, n, 2)
    k_prefix = 4
    prompt = toks[0, : n + k_prefix]
    gen = n - k_prefix - 8          # stay in-distribution while free-running
    T = len(prompt)
    bs = 16
    rows = []
    sel_stats = None
    for frac in (0.1, 0.25, 0.5, 0.75):
        cache_tokens = max(int(T * frac) // bs * bs, bs)
        ecfg = EngineConfig(
            model=cfg,
            pq=PQConfig(n_subvec_per_head=2, n_subbits=6, kmeans_iters=12,
                        approx_topk=False, metric=args.metric,
                        select_block=bs),
            budget=BudgetConfig(compress_ratio=args.compress_ratio,
                                recent_ratio=0.5, sink_size=4),
            cache=CacheConfig(offload=True, block_size=bs,
                              hbm_cache_tokens=cache_tokens,
                              cache_topk_blocks=2 * cache_tokens // bs,
                              kv_dtype=args.kv_dtype,
                              stale_select=False),
            runtime=RuntimeConfig(policy="pq_search", prefill_bucket=64,
                                  max_new_tokens=gen + 2,
                                  max_seq_len=2 * (T + gen),
                                  kernels="xla"))
        eng = OffloadEngine(ecfg, params, dtype=torch.float32,
                            device=args.device)
        if sel_stats is None:
            eng.selection_log = []
        out = eng.generate(prompt, max_new_tokens=gen)
        target = toks[0, n + k_prefix: n + k_prefix + gen]
        acc = float((np.asarray(out[:len(target)]) == target).mean())
        if eng.selection_log:
            # per-step unique selected blocks (union over layers and heads)
            # and the consecutive-step Jaccard overlap
            sets = [set(np.concatenate([b.ravel() for b in step]))
                    for step in eng.selection_log]
            sizes = [len(s) for s in sets]
            jac = [len(a & b) / max(len(a | b), 1)
                   for a, b in zip(sets, sets[1:])]
            sel_stats = {
                "mean_unique_blocks_per_step": round(float(np.mean(sizes)),
                                                     2),
                "total_blocks": T // bs,
                "mean_consecutive_jaccard": round(float(np.mean(jac)), 4),
            }
            eng.selection_log = None
        rows.append({
            "cache_fraction": round(cache_tokens / T, 3),
            "cache_tokens": cache_tokens,
            "hit_rate": round(eng.store.hit_rate, 4),
            "steps": eng.timings["steps"],
            "copy_acc": round(acc, 4),
        })
        print(json.dumps(rows[-1]), flush=True)
    # the random-weights control at one fraction
    dev = resolve_device(args.device)
    rnd_params = llama.init_params(cfg, torch.Generator(
        device=dev).manual_seed(99), dtype=torch.float32, device=dev)
    cache_tokens = max(int(T * 0.25) // bs * bs, bs)
    ecfg_r = dataclasses.replace(
        ecfg, cache=dataclasses.replace(ecfg.cache,
                                        hbm_cache_tokens=cache_tokens))
    eng_r = OffloadEngine(ecfg_r, rnd_params, dtype=torch.float32,
                          device=args.device)
    eng_r.generate(prompt, max_new_tokens=gen)
    control = {"cache_fraction": round(cache_tokens / T, 3),
               "hit_rate_random_weights": round(eng_r.store.hit_rate, 4)}
    print(json.dumps({
        "task": f"offload LFU locality on TRAINED copy model, n={n}, "
                f"{gen} decode steps",
        "train_steps": args.steps, "train_s": round(train_s, 1),
        "metric": args.metric,
        "selection_stats": sel_stats,
        "random_control": control,
        "hit_vs_fraction": rows}), flush=True)


def run_recall(args) -> None:
    """Train the copy objective (variable offsets), then evaluate zero-shot
    associative recall through the engine; n is raised so that the recall
    prompt (3m+2) sits inside the trained length (2n)."""
    m = args.pairs
    args.n = max((3 * m + 4) // 2, args.n)
    cfg, params, train_s = _trained(args, varlen=True)
    kw = dict(eval_n=args.eval_n, kv_dtype=args.kv_dtype,
              device=args.device)
    if args.budget_grid:
        grid = {f"c{comp}_{met}": evaluate_kv(
            cfg, params, args.policies, m, compress_ratio=comp, metric=met,
            **kw) for comp in (0.05, 0.1, 0.2) for met in ("euc", "ip")}
        print(json.dumps({
            "task": f"associative recall, {m} pairs (dup-key distractors, "
                    "last-occurrence wins)",
            "train_steps": args.steps, "train_s": round(train_s, 1),
            "kv_dtype": args.kv_dtype,
            "accuracy_by_budget": grid}), flush=True)
        return
    if args.depth_grid:
        grid = {f"depth_{frac}": evaluate_kv(
            cfg, params, args.policies, m, depth=frac,
            compress_ratio=args.compress_ratio, metric=args.metric, **kw)
            for frac in (0.05, 0.25, 0.5, 0.75)}
        print(json.dumps({
            "task": f"associative recall depth grid, {m} pairs",
            "budget": f"compress {args.compress_ratio}, recent 0.5, sink 4",
            "train_steps": args.steps, "train_s": round(train_s, 1),
            "accuracy_by_depth": grid}), flush=True)
        return
    acc = evaluate_kv(cfg, params, args.policies, m,
                      compress_ratio=args.compress_ratio,
                      metric=args.metric, **kw)
    print(json.dumps({
        "task": f"associative recall, {m} pairs (dup-key distractors)",
        "budget": f"compress {args.compress_ratio}, recent 0.5, sink 4",
        "metric": args.metric,
        "train_steps": args.steps, "train_s": round(train_s, 1),
        "accuracy": acc}), flush=True)


def run_copy(args) -> None:
    cfg, params, train_s = _trained(args)
    kw = dict(eval_n=args.eval_n, gen=args.gen, kv_dtype=args.kv_dtype,
              device=args.device)
    if args.budget_grid:
        grid = {f"c{comp}_{met}": evaluate(
            cfg, params, args.policies, args.n, compress_ratio=comp,
            metric=met, **kw) for comp in (0.05, 0.1, 0.2)
            for met in ("euc", "ip")}
        print(json.dumps({
            "task": f"copy/induction budget grid, half-length {args.n}, "
                    f"free-run {args.gen}",
            "train_steps": args.steps, "train_s": round(train_s, 1),
            "kv_dtype": args.kv_dtype,
            "accuracy_by_budget": grid}), flush=True)
        return
    if args.depth_grid:
        # the retrieved positions of offset k are [k+1, k+gen] of the
        # n-token first half: k sweeps them to 2%..75% depth
        grid = {f"depth_{frac}": evaluate(
            cfg, params, args.policies, args.n,
            k_prefix=max(4, int(args.n * frac)),
            compress_ratio=args.compress_ratio, metric=args.metric, **kw)
            for frac in (0.02, 0.25, 0.5, 0.75)}
        print(json.dumps({
            "task": f"copy/induction depth grid, half-length {args.n}",
            "budget": f"compress {args.compress_ratio}, recent 0.5, sink 4",
            "metric": args.metric, "train_steps": args.steps,
            "train_s": round(train_s, 1),
            "accuracy_by_depth": grid}), flush=True)
        return
    acc = evaluate(cfg, params, args.policies, args.n,
                   compress_ratio=args.compress_ratio, metric=args.metric,
                   **kw)
    print(json.dumps({
        "task": f"copy/induction, half-length {args.n} (prompt "
                f"{args.n+4} tokens), free-run {args.gen} tokens",
        "budget": f"compress {args.compress_ratio}, recent 0.5, sink 4 — "
                  "retrieved positions outside the local window",
        "metric": args.metric,
        "train_steps": args.steps, "train_s": round(train_s, 1),
        "accuracy": acc}), flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200,
                    help="copy half-length; prompt is n+4 tokens")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval-n", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--compress-ratio", type=float, default=0.2)
    ap.add_argument("--metric", default="euc", choices=["euc", "ip"])
    ap.add_argument("--task", default="copy", choices=["copy", "recall"],
                    help="copy = free-run induction copying; recall = "
                         "associative key-value recall with distractors "
                         "(NAH-like point retrieval)")
    ap.add_argument("--pairs", type=int, default=96,
                    help="recall task: (key, value) pair count")
    ap.add_argument("--depth-grid", action="store_true",
                    help="NAH-style depth sweep of the retrieved positions")
    ap.add_argument("--budget-grid", action="store_true",
                    help="sweep compress 0.05/0.1/0.2 x metric euc/ip")
    ap.add_argument("--policies", nargs="*",
                    default=["original", "pq_search", "h2o", "no_drop_lb"])
    ap.add_argument("--kv-dtype", dest="kv_dtype", default="bf16",
                    choices=["bf16", "int8"],
                    help="pq_search tail dtype (int8 quality check)")
    ap.add_argument("--weight-int8", dest="weight_int8",
                    action="store_true",
                    help="quantize the trained weights to int8 (W8A16, "
                         "core/quant.quantize_weight_tree) before the "
                         "engine evaluations")
    ap.add_argument("--offload-locality", dest="offload_locality",
                    action="store_true",
                    help="train, then free-run through the OffloadEngine "
                         "sweeping the device cache fraction")
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu for the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.offload_locality:
        run_offload_locality(args)
    elif args.task == "recall":
        run_recall(args)
    else:
        run_copy(args)


if __name__ == "__main__":
    main()
