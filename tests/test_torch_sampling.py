"""The port's sampling against the JAX package's, on the CPU.

``jax.random.categorical`` draws ``argmax(gumbel + logits)``; torch cannot
replay ``jax.random``, so the port's sampler takes the Gumbel noise as an
argument, and these tests hand it JAX's own draws
(``jax.random.gumbel(sub, logits.shape, float32)`` for the key JAX's
sampler gets): the tokens must then be JAX's, exactly. The decode loops
are held the same way, step by step, from a batched state prefilled by the
JAX package and transplanted through ``bridge``: the port's float32 logits
differ from JAX's in summation order (1e-4, ``tests/test_torch_batched.py``),
so a token may part only where the two largest tempered-and-truncated
logits plus noise lie within 1e-4 of each other, which the test asserts at
the first parting (the streams differ after it). The Engine's and the
BatchEngine's sampling draw from torch generators, so they are held to
themselves: the same seed gives the same tokens, top_k 1 is greedy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu import config as jconfig
from pqcache_tpu.core.budget import compute_budget as jcompute_budget
from pqcache_tpu.core.sampling import make_sampler as jmake_sampler
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.policies.base import get_policy as jget_policy
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.core.sampling import (GumbelNoise, make_sampler,
                                             truncated_logits)
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
from pqcache_tpu_torch.runtime.generate import Engine

torch.set_num_threads(1)
GAP_TOL = 1e-4     # the largest logit-order difference a parting may show
P, LENGTHS, STEPS = 256, (256, 230), 8

SAMPLERS = {"T": (0.8, 0, 1.0), "top_k": (1.3, 20, 1.0),
            "top_p": (0.7, 0, 0.9), "top_k+top_p": (1.0, 40, 0.8)}


class JaxNoise:
    """JAX's per-step Gumbel draws for the key schedule of its decode
    loops: key, sub = split(key) each step, noise = gumbel(sub, shape)."""

    def __init__(self, key):
        self.key = key

    def fill_(self, buf):
        self.key, sub = jax.random.split(self.key)
        g = jax.random.gumbel(sub, tuple(buf.shape), jnp.float32)
        return buf.copy_(torch.from_numpy(np.array(g)))


@pytest.mark.parametrize("lead", [(), (5,)])
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_gives_jax_tokens_from_jax_noise(name, lead):
    # exact: the same float32 masks and argmax over the same sums
    T, k, p = SAMPLERS[name]
    jsample, sample = jmake_sampler(T, k, p), make_sampler(T, k, p)
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(3)
    for _ in range(24):
        logits = (rng.normal(size=lead + (300,)) * 3).astype(np.float32)
        key, sub = jax.random.split(key)
        want = np.asarray(jsample(sub, jnp.asarray(logits)))
        g = np.array(jax.random.gumbel(sub, logits.shape, jnp.float32))
        got = sample(torch.from_numpy(logits), torch.from_numpy(g))
        assert got.dtype == torch.int32 and got.shape == lead
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampler_greedy_and_truncation():
    assert make_sampler(0.0) is None
    assert make_sampler(0.0, top_k=5, top_p=0.5) is None
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0]])
    noise = GumbelNoise(0, "cpu")
    # top_k 1 and a nucleus smaller than the largest probability are argmax
    for s in (make_sampler(1.0, top_k=1), make_sampler(1.0, top_p=0.01)):
        for _ in range(8):
            assert int(s(logits, noise.draw(logits.shape))[0]) == 1
    probs = torch.tensor([0.5, 0.3, 0.15, 0.05])
    s = make_sampler(1.0, top_p=0.6)      # preceding mass < 0.6: {0, 1}
    draws = {int(s(probs.log(), noise.draw((4,)))) for _ in range(128)}
    assert draws == {0, 1}
    # the same seed, the same noise
    a, b = GumbelNoise(7, "cpu").draw((3, 50)), GumbelNoise(7, "cpu").draw(
        (3, 50))
    assert torch.equal(a, b) and torch.isfinite(a).all()


def _ecfgs(policy="pq_search", **rt):
    kw = dict(
        pq=dict(n_subvec_per_head=2, n_subbits=4, kmeans_iters=4,
                select_block=16, adc_mode="v1", approx_topk=False),
        budget=dict(compress_ratio=0.3, recent_ratio=0.5, sink_size=4),
        runtime=dict(dict(policy=policy, prefill_bucket=64,
                          max_new_tokens=16, max_seq_len=512,
                          kernels="xla"), **rt))

    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=2),
            pq=mod.PQConfig(**kw["pq"]),
            budget=mod.BudgetConfig(**kw["budget"]),
            runtime=mod.RuntimeConfig(**kw["runtime"]))
    jecfg, ecfg = build(jconfig), build(config)
    return jecfg, dataclasses.replace(ecfg, runtime=dataclasses.replace(
        ecfg.runtime, kernels="auto"))


@pytest.fixture(scope="module")
def model():
    jecfg, _ = _ecfgs()
    jparams = jllama.init_params(jecfg.model, jax.random.PRNGKey(7),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jparams, params


@pytest.mark.parametrize("policy", ["pq_search", "original"])
def test_decode_loop_batched_sampled_gives_jax_tokens(model, policy):
    jparams, params = model
    jecfg, ecfg = _ecfgs(policy)
    jpol = jget_policy(jecfg, jcompute_budget(jecfg.budget, P, 16))
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, 16), device="cpu")
    jstate = jpol.init_batched_state(len(LENGTHS), jnp.float32)
    prefill = jax.jit(lambda t, pad, n: jllama.prefill(
        jecfg.model, jparams, jpol, jpol.init_state(jnp.float32), t, pad, n))
    rng = np.random.default_rng(4)
    toks, pos = [], []
    for slot, n in enumerate(LENGTHS):
        ids = np.zeros(P, np.int32)
        ids[P - n:] = rng.integers(0, jecfg.model.vocab_size, n)
        lg, s = prefill(jnp.asarray(ids), jnp.asarray(P - n), jnp.asarray(n))
        jstate = jpol.insert_slot(jstate, s, jnp.asarray(slot))
        toks.append(int(jnp.argmax(lg)))
        pos.append(n)
    np_state = jax.tree.map(np.asarray, jstate)
    state = (bridge.pq_state_from_numpy(np_state, device="cpu")
             if policy == "pq_search" else
             bridge.dense_state_from_numpy(np_state, device="cpu"))
    T, k, p = SAMPLERS["top_k+top_p"]
    key = jax.random.PRNGKey(11)
    want, _ = jax.jit(lambda s, t, q: jllama.decode_loop_batched(
        jecfg.model, jparams, jpol, s, t, q, STEPS,
        sample=jmake_sampler(T, k, p), rng=key))(
            jstate, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32))
    want = np.asarray(want)
    sample, seen = make_sampler(T, k, p), []

    def recording(logits, noise):
        seen.append((logits.clone(), noise.clone()))
        return sample(logits, noise)
    got = llama.decode_loop_batched(
        ecfg.model, params, pol, state, torch.tensor(toks, dtype=torch.int32),
        torch.tensor(pos, dtype=torch.int32), STEPS, sample=recording,
        noise=JaxNoise(key)).numpy()
    assert got.shape == want.shape == (STEPS, len(LENGTHS))
    # the slots decode independently: each may part from JAX only at a
    # near tie of its two best scores, and runs its own course after it
    for b in range(len(LENGTHS)):
        parted = np.flatnonzero(got[:, b] != want[:, b])
        if not len(parted):
            continue
        i = parted[0]
        logits, noise = seen[i]
        scores = truncated_logits(logits[b], T, k, p) + noise[b]
        top2 = scores.topk(2).values
        assert (top2[0] - top2[1]).item() < GAP_TOL, (i, b, top2)
        np.testing.assert_array_equal(got[:i, b], want[:i, b])


def test_engine_sampling_seeded_and_greedy_at_top_k_one(model):
    _, params = model
    _, ecfg = _ecfgs(temperature=1.0, top_k=30, sample_seed=5)
    ids = np.random.default_rng(3).integers(0, 256, 250)

    def gen(**rt):
        e = dataclasses.replace(ecfg, runtime=dataclasses.replace(
            ecfg.runtime, **rt))
        return Engine(e, params, dtype=torch.float32,
                      device="cpu").generate(ids, 10).tokens
    a = gen()
    assert a == gen() and len(a) == 10
    assert gen(sample_seed=6) != a
    greedy = gen(temperature=0.0)
    assert gen(top_k=1) == greedy
    assert gen(temperature=0.0, top_k=3, top_p=0.5) == greedy


def test_batch_engine_sampling_seeded_and_greedy_at_top_k_one(model):
    _, params = model
    _, ecfg = _ecfgs(temperature=0.8, top_k=50, top_p=0.9, sample_seed=11,
                     prefill_chunk=64)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n) for n in (256, 240, 220)]

    def run(**rt):
        e = dataclasses.replace(ecfg, runtime=dataclasses.replace(
            ecfg.runtime, **rt))
        be = BatchEngine(e, params, batch_size=2, prefill_len=P,
                         max_new_tokens=6, dtype=torch.float32, device="cpu")
        assert be.interleave and (be.sampler is None) == (
            e.runtime.temperature == 0)
        return be.run(list(enumerate(prompts)), chunk=3)
    a = run()
    assert a == run() and all(len(v) == 6 for v in a.values())
    assert run(top_k=1) == run(temperature=0.0)
