"""The port's `no_drop_lb` and `sparq_f` policies against the JAX package's.

On the CPU, float32: the same parameters (JAX's ``init_params`` through
``bridge``) and prompt. Prefill is deterministic on both sides, so the
port's own prefill state must equal JAX's (caches, counters, SparQ's mean
value); decode then starts from the JAX state transplanted through
``bridge`` and must give JAX's greedy tokens with logits within 1e-4 at
every step (the same float32 arithmetic in another summation order), on
both of the port's routes (``kernels="xla"`` and the kernel wrappers, which
take their plain versions on a CPU tensor). ``Engine.generate`` must give
the JAX Engine's tokens. ``torch.set_num_threads(1)``: the suite runs with
several workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu import config as jconfig
from pqcache_tpu.core.budget import compute_budget as jcompute_budget
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.policies.base import get_policy as jget_policy
from pqcache_tpu.runtime.generate import Engine as JEngine
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy, policy_class
from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
from pqcache_tpu_torch.runtime.generate import Engine

torch.set_num_threads(1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
N_STEPS = 16


@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.tiny_model_config(num_layers=2)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rng = np.random.default_rng(3)
    motif = rng.integers(0, jcfg.vocab_size, size=16)
    ids = np.concatenate([motif, rng.integers(0, jcfg.vocab_size, size=1000),
                          motif, rng.integers(0, jcfg.vocab_size, size=60)])
    return jparams, params, ids


def _ecfgs(policy, kernels="xla", **rt):
    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=2),
            budget=mod.BudgetConfig(compress_ratio=0.3, recent_ratio=0.5,
                                    sink_size=4),
            runtime=mod.RuntimeConfig(**dict(
                dict(policy=policy, prefill_bucket=64, max_new_tokens=32,
                     max_seq_len=2048, kernels=kernels), **rt)))
    return build(jconfig), build(config)


# (policy, RuntimeConfig overrides): SparQ at its defaults (top-r 32 of a
# 16-wide head: every component) and with a narrow top-r and the
# mean-value reallocation
CASES = {
    "no_drop_lb": ("no_drop_lb", {}),
    "sparq_f": ("sparq_f", {}),
    "sparq_f-r4-mean_v": ("sparq_f", dict(sparq_topr=4,
                                          sparq_mean_v_trick=True)),
}


def _dense(state):
    return state.dense if hasattr(state, "dense") else state


def _assert_state_equal(state, jstate):
    d, jd = _dense(state), _dense(jstate)
    assert (d.length, d.start, d.pos) == (int(jd.length), int(jd.start),
                                          int(jd.pos))
    span = slice(d.start, d.length)
    for name in ("k_cache", "v_cache"):
        np.testing.assert_allclose(
            getattr(d, name)[:, :, span].numpy(),
            np.asarray(getattr(jd, name))[:, :, span], **STATE_TOL)
    if hasattr(state, "mean_v"):
        np.testing.assert_allclose(state.mean_v.numpy(),
                                   np.asarray(jstate.mean_v), **STATE_TOL)


def _port_state(policy, np_state):
    if policy == "sparq_f":
        return bridge.sparq_state_from_numpy(np_state, device="cpu")
    return bridge.dense_state_from_numpy(np_state, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_jax(model, case):
    policy, rt = CASES[case]
    jparams, params, ids = model
    jecfg, ecfg = _ecfgs(policy, **rt)
    true_len, P = len(ids), 1152
    pad = P - true_len
    tokens = np.zeros(P, np.int32)
    tokens[pad:] = ids
    jpol = jget_policy(jecfg, jcompute_budget(jecfg.budget, P, 32))
    jlogits, jstate = jax.jit(lambda p, s, t: jllama.prefill(
        jecfg.model, p, jpol, s, t, jnp.asarray(pad),
        jnp.asarray(true_len)))(jparams, jpol.init_state(jnp.float32),
                                jnp.asarray(tokens))
    budget = compute_budget(ecfg.budget, P, 32)
    pol = get_policy(ecfg, budget, device="cpu")
    state0 = pol.init_state(torch.float32)
    logits = llama.prefill(ecfg.model, params, pol, state0,
                           torch.from_numpy(tokens).long(), pad, true_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    jnp_state = jax.tree.map(np.asarray, jstate)
    _assert_state_equal(state0, jnp_state)
    if policy == "no_drop_lb":
        assert (pol.high_budget, pol.local_budget) == (jpol.high_budget,
                                                       jpol.local_budget)
    else:
        assert (pol.r, pol.k_budget, pol.local_k) == (jpol.r, jpol.k_budget,
                                                      jpol.local_k)

    jstep = jax.jit(lambda p, s, t, pos: jllama.decode_step(
        jecfg.model, p, jpol, s, t, pos))
    tok = int(jnp.argmax(jlogits))
    jlog, jtoks = [], []
    for i in range(N_STEPS):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(true_len + i, jnp.int32))
        jlog.append(np.asarray(jl))
        jtoks.append(tok)
        tok = int(jnp.argmax(jl))
    for kernels in ("xla", "auto"):
        pol = get_policy(dataclasses.replace(ecfg, runtime=dataclasses.replace(
            ecfg.runtime, kernels=kernels)), budget, device="cpu")
        state = _port_state(policy, jnp_state)
        for i in range(N_STEPS):
            tl = llama.decode_step(ecfg.model, params, pol, state,
                                   torch.tensor(jtoks[i]), true_len + i)
            np.testing.assert_allclose(tl.numpy(), jlog[i],
                                       err_msg=f"{kernels} step {i}",
                                       **LOGIT_TOL)
            assert int(torch.argmax(tl)) == int(np.argmax(jlog[i]))
        _assert_state_equal(state, jax.tree.map(np.asarray, jstate))


@pytest.mark.parametrize("case", list(CASES))
def test_engine_generate_matches_jax(model, case):
    policy, rt = CASES[case]
    jparams, params, ids = model
    jecfg, ecfg = _ecfgs(policy, **rt)
    want = JEngine(jecfg, jparams, dtype=jnp.float32).generate(ids, 12)
    for kernels in ("auto", "xla"):
        got = Engine(dataclasses.replace(ecfg, runtime=dataclasses.replace(
            ecfg.runtime, kernels=kernels)), params, dtype=torch.float32,
            device="cpu").generate(ids, 12)
        assert got.policy_name == policy
        assert got.tokens == want.tokens, kernels
    # a short prompt passes straight through (no dense fallback to name)
    short = Engine(ecfg, params, dtype=torch.float32,
                   device="cpu").generate(ids[:40], 4)
    assert short.policy_name == policy and len(short.tokens) == 4


@pytest.mark.parametrize("policy", ["no_drop_lb", "sparq_f"])
def test_registered_single_sequence_only(model, policy):
    _, params, _ = model
    assert policy_class(policy).deferred_appends is False
    _, ecfg = _ecfgs(policy)
    # the JAX package has no batched route for these policies
    with pytest.raises(ValueError, match="single-sequence"):
        BatchEngine(ecfg, params, batch_size=2, prefill_len=256,
                    max_new_tokens=8, dtype=torch.float32, device="cpu")
