"""Decode-step A/B timings on the card.

Counterpart of ``pqcache_tpu/harness/profile_decode.py``. The reference's
SYNC_TEST_TIME machinery (global_timer.py:33-54) splits a decode step into
pq / non-pq / transfer with paired CUDA events; these A/B runs of the
single-sequence decode loop give the same attribution by difference:
  * policy `original` against `pq_search`: the retrieval's cost;
  * PQ_ADC={v2,v1,xla}, PQ_FETCH={gather,masked}, PQ_GATHER={xla,pallas},
    BLOCK=n: the cost of each stage's variant.
(``harness/trace.py`` splits one run by cause instead.) The state is
randomized as a real one would be (codes, centroids and tail rows drawn
from ``np.random.default_rng(0)``, so top-k indices scatter as real
retrieval's do), or prefilled from a random prompt with PREFILL=1.

    python -m pqcache_tpu_torch.harness.profile_decode [policy ...]
    python -m pqcache_tpu_torch.harness.profile_decode --device cpu

Environment: CTX (4096), LAYERS (2), STEPS (8), BLOCK (1), PREFILL,
PQ_ADC (v2), PQ_FETCH (gather), PQ_GATHER (xla). Model: Llama-3.1-8B
widths (vocab 128256, hidden 4096, 32 / 8 heads, head_dim 128, rope theta
500000 with scaling 8) at LAYERS layers, random bf16 weights from seed 0.
Prints `<policy>: prefill <s>s` (PREFILL=1), `<policy>: first <s>s` (the
first decode loop, kernels built) and three `<policy>: <ms> ms/step`, each
timed between two device synchronizations. Runs on cuda unless
``--device cpu`` is given. Nothing is read or allocated at import:
``run`` takes the model, its weights and the sizes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from pqcache_tpu_torch import config, resolve_device
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy

DEFAULT_POLICIES = ("original", "pq_search")
MAX_NEW = 64          # the budget's reserved new tokens, as the JAX CLI's


def settings(env=None) -> dict:
    """The environment's knobs, with the JAX CLI's defaults."""
    env = os.environ if env is None else env
    return dict(ctx=int(env.get("CTX", "4096")),
                layers=int(env.get("LAYERS", "2")),
                steps=int(env.get("STEPS", "8")),
                block=int(env.get("BLOCK", "1")),
                prefill=env.get("PREFILL") == "1",
                adc_mode=env.get("PQ_ADC", "v2"),
                fetch_mode=env.get("PQ_FETCH", "gather"),
                gather_mode=env.get("PQ_GATHER", "xla"))


def model_config(layers: int, name: str = "prof") -> config.ModelConfig:
    """Llama-3.1-8B widths at ``layers`` layers, as the JAX CLIs build it."""
    return config.ModelConfig(
        name=f"{name}{layers}L", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=layers, num_heads=32,
        num_kv_heads=8, head_dim=128, rope_theta=500000.0,
        rope_scaling_factor=8.0, max_position_embeddings=131072)


def engine_config(model: config.ModelConfig, policy: str, ctx: int,
                  block: int = 1, **pq_kw) -> config.EngineConfig:
    """The CLIs' configuration: 2 subvectors x 6 bits, 6 k-means
    iterations, budget 0.2 / 0.5 / sink 32, prefill bucket 1024."""
    return config.EngineConfig(
        model=model,
        pq=config.PQConfig(n_subvec_per_head=2, n_subbits=6, kmeans_iters=6,
                           select_block=block, **pq_kw),
        budget=config.BudgetConfig(compress_ratio=0.2, recent_ratio=0.5,
                                   sink_size=32),
        runtime=config.RuntimeConfig(policy=policy, prefill_bucket=1024,
                                     max_new_tokens=MAX_NEW,
                                     max_seq_len=ctx * 2))


def randomize_state(state, budget, ctx: int, policy: str,
                    n_centroids: int) -> None:
    """The JAX CLIs' randomized state, in place: pq_search gets codes,
    centroids and tail rows x 0.1 drawn from ``np.random.default_rng(0)``
    in that order (zeros would give constant scores and contiguous
    indices: optimistic gathers) and its counters at ``ctx``; a dense
    state its length and position."""
    rng = np.random.default_rng(0)
    if policy == "pq_search":
        state.n_cand, state.pos = budget.n_cand_init, ctx
        state.codes = torch.from_numpy(rng.integers(
            0, n_centroids, size=tuple(state.codes.shape))).to(
                state.codes)
        state.centroids = torch.from_numpy(rng.normal(
            size=tuple(state.centroids.shape))).to(state.centroids)
        state.kv_tail = torch.from_numpy(rng.normal(
            size=tuple(state.kv_tail.shape)) * 0.1).to(state.kv_tail)
    elif hasattr(state, "length"):
        state.length, state.pos = ctx, ctx


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(name: str, *, model: config.ModelConfig, params: dict,
        ctx: int = 4096, steps: int = 8, block: int = 1,
        prefill: bool = False, adc_mode: str = "v2",
        fetch_mode: str = "gather", gather_mode: str = "xla", device=None,
        dtype=torch.bfloat16, reps: int = 3,
        log: Callable[[str], None] = print) -> List[torch.Tensor]:
    """One policy: the state prefilled or randomized, a first decode loop
    of ``steps`` steps from token 3 at position ``ctx``, then ``reps``
    timed loops, each fed token 3 at the next ``steps`` positions (as the
    JAX CLI does). Prints the lines; returns each loop's tokens [steps]
    on the host."""
    dev = resolve_device(device)
    cfg = engine_config(model, name, ctx, block, adc_mode=adc_mode,
                        fetch_mode=fetch_mode, gather_mode=gather_mode)
    budget = compute_budget(cfg.budget, ctx, MAX_NEW)
    policy = get_policy(cfg, budget, device=dev)
    state = policy.init_state(dtype)
    if prefill:
        ids = np.random.default_rng(0).integers(0, model.vocab_size,
                                                size=ctx)
        sync(dev)
        t0 = time.perf_counter()
        logits = llama.prefill(model, params, policy, state,
                               torch.from_numpy(ids).to(dev), 0, ctx)
        sync(dev)
        log(f"{name}: prefill {time.perf_counter() - t0:.1f}s")
        del logits
    else:
        randomize_state(state, budget, ctx, name, cfg.pq.n_centroids)
    tok = torch.tensor(3, device=dev)
    out = []
    for rep in range(reps + 1):
        sync(dev)
        t0 = time.perf_counter()
        toks = llama.decode_loop(model, params, policy, state, tok,
                                 ctx + steps * rep, steps)
        sync(dev)
        dt = time.perf_counter() - t0
        log(f"{name}: first {dt:.1f}s" if rep == 0 else
            f"{name}: {dt / steps * 1e3:.2f} ms/step")
        out.append(toks.cpu())
    return out


def main(argv: Optional[List[str]] = None, env=None) -> dict:
    """The command line. Returns each policy's tokens."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("policies", nargs="*", default=list(DEFAULT_POLICIES))
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu runs the plain versions)")
    args = ap.parse_args(argv)
    s = settings(env)
    dev = resolve_device(args.device)
    model = model_config(s.pop("layers"))
    params = llama.init_params(
        model, torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev)
    out = {}
    for name in args.policies or DEFAULT_POLICIES:
        out[name] = run(name, model=model, params=params, device=dev, **s)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
