"""The port's batched offload engine (``runtime/offload_batch.py``) against
the JAX package's, on the CPU, and the offload bench at a toy size.

At ``tests/test_offload_batch.py``'s configuration (2 layers, float32,
block 16, a 96-token cache, top 4 blocks admitted a step) the same
parameters and prompts go through
``pqcache_tpu.runtime.offload_batch.BatchOffloadEngine`` and the port's;
the tokens must be identical for every slot, token for token, as the JAX
test asks of its own tiers (the port's k-means starts from JAX's
k-means++ seeds of the same points): ``generate_batch`` at B 2 with bf16
and int8 stores, sampled given JAX's Gumbel draws, the continuous
``serve`` with arrivals and EOS (slots retire, their id ranges are
invalidated and reused) and serving in stale mode, whose selections are
reseeded by an exact step after each admission. The store's hit and miss
counts must be JAX's. ``torch.set_num_threads(1)``: the suite runs with
several workers.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu import config as jconfig
from pqcache_tpu.core import pq as jpq
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.runtime.offload_batch import \
    BatchOffloadEngine as JBatchOffload
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.harness import offload_bench
from pqcache_tpu_torch.native import lfu_cache
from pqcache_tpu_torch.runtime.offload_batch import BatchOffloadEngine

torch.set_num_threads(1)


def _ecfgs(kv="bf16", stale=False, compress=0.3, recent=0.5, **rt):
    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=2),
            pq=mod.PQConfig(n_subvec_per_head=2, n_subbits=4,
                            kmeans_iters=8, approx_topk=False,
                            select_block=16),
            budget=mod.BudgetConfig(compress_ratio=compress,
                                    recent_ratio=recent, sink_size=4),
            cache=mod.CacheConfig(offload=True, block_size=16,
                                  hbm_cache_tokens=96, cache_topk_blocks=4,
                                  kv_dtype=kv, stale_select=stale),
            runtime=mod.RuntimeConfig(policy="pq_search", prefill_bucket=64,
                                      max_new_tokens=40, max_seq_len=1024,
                                      **rt))
    return build(jconfig), build(config)


@pytest.fixture(scope="module")
def model():
    jparams = jllama.init_params(jconfig.tiny_model_config(num_layers=2),
                                 jax.random.PRNGKey(7), dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jparams, params


_jax_seeds = jax.jit(lambda x, n, C: jpq.kmeans(
    x, C, iters=0, seed=4321, valid_len=n).centroids, static_argnums=2)


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    orig = pq.kmeans

    def kmeans(x, C, iters, *, valid_len=None, generator=None, **kw):
        c0 = _jax_seeds(jnp.asarray(x.numpy()),
                        jnp.asarray(valid_len, jnp.int32), C)
        return orig(x, C, iters, valid_len=valid_len,
                    init_centroids=torch.from_numpy(np.array(c0)), **kw)
    monkeypatch.setattr(pq, "kmeans", kmeans)


class JaxNoise:
    """JAX's Gumbel draws for its key schedule (one split per draw)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def fill_(self, buf):
        self.key, sub = jax.random.split(self.key)
        g = jax.random.gumbel(sub, tuple(buf.shape), jnp.float32)
        return buf.copy_(torch.from_numpy(np.array(g)))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in lengths]


def _engines(model, B, **kw):
    jparams, params = model
    jecfg, ecfg = _ecfgs(**kw)
    return (JBatchOffload(jecfg, jparams, batch_size=B, dtype=jnp.float32),
            BatchOffloadEngine(ecfg, params, batch_size=B,
                               dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_generate_batch_gives_jax_tokens(model, jax_kmeans_init, kv):
    # a local window of 9 tokens: from step 10 on the evictions enter the
    # store, and by step 30 each slot's tail block has gone to the host
    je, pe = _engines(model, 2, kv=kv, recent=0.1)
    prompts = _prompts(3, (260, 230))
    want = je.generate_batch(prompts, max_new_tokens=30)
    got = pe.generate_batch(prompts, max_new_tokens=30)
    assert got == want
    assert (pe.store.hits, pe.store.misses) == (je.store.hits,
                                                je.store.misses)
    assert pe.store.hits > 0 and pe.store.d2h_copies > 4
    np.testing.assert_array_equal(pe._valid, je._valid)
    assert pe.store.host_kv[0].dtype == (torch.int8 if kv == "int8"
                                         else torch.float32)


def test_sampled_generate_batch_gives_jax_tokens(model, jax_kmeans_init):
    je, pe = _engines(model, 2, temperature=0.9, top_k=20, sample_seed=5)
    prompts = _prompts(4, (260, 230))
    want = je.generate_batch(prompts, max_new_tokens=10)
    assert pe.generate_batch(prompts, max_new_tokens=10,
                             noise=JaxNoise(5)) == want


def test_serve_with_arrivals_and_eos_gives_jax_tokens(model,
                                                      jax_kmeans_init):
    # 4 requests through 2 slots: the later ones admit into retired slots
    # whose id ranges were invalidated; an EOS retires a slot early
    je, pe = _engines(model, 2)
    prompts = _prompts(11, (320, 300, 320, 280))
    ref = je.serve([(0, prompts[0])], max_new_tokens=6)[0]
    eos = (int(ref[2]),)
    reqs = list(enumerate(prompts))
    want = je.serve(reqs, max_new_tokens=12, eos_ids=eos)
    timing: dict = {}
    got = pe.serve(reqs, max_new_tokens=12, eos_ids=eos,
                   arrivals={0: 0.0, 1: 0.0, 2: 0.0, 3: 0.3}, timing=timing)
    assert got == want and set(got) == {0, 1, 2, 3}
    assert len(got[0]) == 3
    assert (pe.store.hits, pe.store.misses) == (je.store.hits,
                                                je.store.misses)
    # every slot retired at the end: no id holds rows
    assert not pe.store.stored.any()
    for i in range(4):
        ev = timing[i]
        assert ev["admit"] <= ev["first"] <= ev["done"]
        assert len(ev["token_times"]) == len(got[i])
    assert timing[3]["admit"] >= 0.3


def test_serve_stale_reseeds_on_admission(model, jax_kmeans_init):
    # stale selections come from the previous step; after an admission the
    # slot's rows belong to a new sequence, so one exact step reseeds them
    je, pe = _engines(model, 2, stale=True)
    prompts = _prompts(3, (260, 230))
    reqs = [(i, prompts[i % 2]) for i in range(4)]
    seeds = []
    orig = pe._admission_step

    def step(adm):
        done = orig(adm)
        seeds.append(done and pe._blk_stale is None)
        return done
    pe._admission_step = step
    want = je.serve(reqs, max_new_tokens=8)
    assert pe.serve(reqs, max_new_tokens=8) == want
    assert sum(seeds) == 4
    assert (pe.store.hits, pe.store.misses) == (je.store.hits,
                                                je.store.misses)


@pytest.mark.parametrize("env", [dict(), dict(BATCH="2", KV_INT8="1"),
                                 dict(BATCH="2", REQUESTS="3", STALE="1")],
                         ids=["single", "batch", "serve"])
def test_offload_bench_at_toy_size(env, capsys):
    line = offload_bench.main(dict(env, TINY="1", DEVICE="cpu", CTX="400",
                                   LAYERS="2", GEN="6", CACHE_TOKENS="256",
                                   BLOCK="32"))
    assert json.loads(capsys.readouterr().out.strip()) == json.loads(
        json.dumps(line))
    assert line["per_step_ms"] > 0 and 0 <= line["hit_rate"] <= 1
    assert line["staged_bytes_per_step"] > 0 and line["d2h_bytes"] > 0
    assert line["kv_dtype"] == ("int8" if env.get("KV_INT8") else "bf16")
    assert ("hbm_tier_per_step_ms" in line) == ("REQUESTS" not in env)
    # the CPU store takes the Python model only where g++ cannot build
    assert line["lfu_native"] == lfu_cache.LFUCache(1).native
