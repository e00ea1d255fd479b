"""The port's offload engine (``runtime/offload_engine.py``) against the JAX
package's, on the CPU, and the Engine's routing to it.

At ``tests/test_offload_engine.py``'s configuration (2 layers, float32, a
260-token prompt, block 32, a 128-token cache, top 4 blocks admitted a
step) the same parameters (JAX's ``init_params`` through ``bridge``) and
prompt go through ``pqcache_tpu.runtime.offload_engine.OffloadEngine`` and
the port's. The port's k-means starts from JAX's k-means++ seeds of the
same points (torch cannot replay ``jax.random``). The port is fed JAX's
tokens (teacher forcing); its logits must be within 1e-4 of JAX's at every
step (JAX's read through a debug callback on its LM head), and its own
greedy token JAX's unless JAX's top-2 gap there is within the logit
difference. Cases: bf16 and int8 stores, exact and one-step-stale
selection, chunked prefill, a 36-step int8 run at block 16 (a 64-token
cache), and sampled decode given JAX's Gumbel draws. The store's hit and miss
counts must equal JAX's after every classify, and exact mode's per-layer
selections JAX's. Then the ``max_seq_len`` refusal, the Engine's routing
(``pq_search_offload``; a prefix raises; ``BatchEngine`` points to
``BatchOffloadEngine``) and the accuracy twin: the port's offload engine
against the port's device-tier Engine at the same ``select_block``.
``torch.set_num_threads(1)``: the suite runs with several workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu import config as jconfig
from pqcache_tpu.core import pq as jpq
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.runtime import host_offload as jhost_offload
from pqcache_tpu.runtime.offload_engine import OffloadEngine as JOffload
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.runtime import host_offload
from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
from pqcache_tpu_torch.runtime.generate import Engine
from pqcache_tpu_torch.runtime.offload_engine import OffloadEngine

torch.set_num_threads(1)
LOGIT_TOL = 1e-4


def _ecfgs(kv="bf16", stale=False, bs=32, cache=128, new=16, **rt):
    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=2),
            pq=mod.PQConfig(n_subvec_per_head=2, n_subbits=4,
                            kmeans_iters=8, approx_topk=False,
                            select_block=bs),
            budget=mod.BudgetConfig(compress_ratio=0.3, recent_ratio=0.5,
                                    sink_size=4),
            cache=mod.CacheConfig(offload=True, block_size=bs,
                                  hbm_cache_tokens=cache,
                                  cache_topk_blocks=4, kv_dtype=kv,
                                  stale_select=stale),
            runtime=mod.RuntimeConfig(**dict(
                dict(policy="pq_search", prefill_bucket=64,
                     max_new_tokens=new, max_seq_len=1024), **rt)))
    return build(jconfig), build(config)


@pytest.fixture(scope="module")
def model():
    jparams = jllama.init_params(jconfig.tiny_model_config(num_layers=2),
                                 jax.random.PRNGKey(7), dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    ids = np.random.default_rng(3).integers(0, 256, size=260).astype(
        np.int32)
    return jparams, params, ids


_jax_seeds = jax.jit(lambda x, n, C: jpq.kmeans(
    x, C, iters=0, seed=4321, valid_len=n).centroids, static_argnums=2)


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    """The port's k-means starts from JAX's k-means++ centroids of the
    same points and seed."""
    orig = pq.kmeans

    def kmeans(x, C, iters, *, valid_len=None, generator=None, **kw):
        c0 = _jax_seeds(jnp.asarray(x.numpy()),
                        jnp.asarray(valid_len, jnp.int32), C)
        return orig(x, C, iters, valid_len=valid_len,
                    init_centroids=torch.from_numpy(np.array(c0)), **kw)
    monkeypatch.setattr(pq, "kmeans", kmeans)


@pytest.fixture
def recorded(monkeypatch):
    """JAX's logits (a debug callback on its LM head, in trace and in eager
    code) and both stores' (hits, misses) after every classify."""
    rec = {"jax_logits": [], "jax_counts": [], "counts": []}
    orig_head = jllama.lm_head_logits

    def head(params, x):
        out = orig_head(params, x)
        jax.debug.callback(
            lambda a: rec["jax_logits"].append(np.array(a).reshape(-1)), out)
        return out
    monkeypatch.setattr(jllama, "lm_head_logits", head)
    for mod, key in ((jhost_offload, "jax_counts"), (host_offload, "counts")):
        orig = mod.HostKVStore.classify_blocks

        def classify(self, *a, _orig=orig, _key=key, **kw):
            out = _orig(self, *a, **kw)
            rec[_key].append((self.hits, self.misses))
            return out
        monkeypatch.setattr(mod.HostKVStore, "classify_blocks", classify)
    return rec


class JaxNoise:
    """JAX's Gumbel draws for its key schedule: key, sub = split(key) for
    each draw, noise = gumbel(sub, shape)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def fill_(self, buf):
        self.key, sub = jax.random.split(self.key)
        g = jax.random.gumbel(sub, tuple(buf.shape), jnp.float32)
        return buf.copy_(torch.from_numpy(np.array(g)))


def _hold(want, jl, got, pl) -> int:
    """Per-step logits within LOGIT_TOL; a token may part only where JAX's
    top-2 gap is within the logit difference. Returns the partings."""
    assert len(got) == len(want) and len(pl) == len(jl) == len(want)
    parts = 0
    for i, (a, b, x, y) in enumerate(zip(want, got, jl, pl)):
        d = float(np.abs(x - y.numpy()).max())
        assert d <= LOGIT_TOL, (i, d)
        if a != b:
            top2 = np.sort(x)[-2:]
            assert top2[1] - top2[0] <= d, (i, want, got)
            parts += 1
    return parts


def _run_both(model, kv, stale, n, *, sampled=False, bs=32, cache=128,
              **rt):
    jparams, params, ids = model
    jecfg, ecfg = _ecfgs(kv, stale, bs, cache, new=max(16, n), **rt)
    je = JOffload(jecfg, jparams, dtype=jnp.float32)
    je.selection_log = []
    want = je.generate(ids, n)
    pe = OffloadEngine(ecfg, params, dtype=torch.float32, device="cpu")
    pe.selection_log, pe.logits_log = [], []
    got = pe.generate(ids, n, forced=want,
                      noise=JaxNoise(rt.get("sample_seed", 0))
                      if sampled else None)
    return je, want, pe, got


CASES = {
    "bf16-exact": ("bf16", False, {}),
    "bf16-stale": ("bf16", True, {}),
    "int8-exact": ("int8", False, {}),
    "int8-stale": ("int8", True, {}),
    "chunked": ("bf16", False, dict(prefill_chunk=64)),
    "int8-jhist-long": ("int8", False, dict(bs=16, cache=64, n=36)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_offload_engine_gives_jax_tokens(model, jax_kmeans_init, recorded,
                                         case):
    kv, stale, kw = CASES[case]
    kw = dict(kw)
    n = kw.pop("n", 10)
    je, want, pe, got = _run_both(model, kv, stale, n, **kw)
    assert _hold(want, recorded["jax_logits"], got, pe.logits_log) == 0
    assert recorded["counts"] == recorded["jax_counts"]
    assert len(recorded["counts"]) == 2 * (n - 1)
    assert (pe.store.hits, pe.store.misses) == (je.store.hits,
                                                je.store.misses)
    assert pe.store.hits > 0 and pe.store.misses > 0
    if not stale:
        assert len(pe.selection_log) == len(je.selection_log) == n - 1
        for a, b in zip(pe.selection_log, je.selection_log):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    st = pe.store
    assert st.host_kv[0].dtype == st.cache_kv[0].dtype == st.tail[0].dtype \
        == (torch.int8 if kv == "int8" else torch.float32)
    np.testing.assert_array_equal(st.valid, je.store.valid)
    if case == "int8-jhist-long":
        assert pe.use_jhist and st.valid[0] > 0


@pytest.mark.parametrize("stale", [False, True], ids=["exact", "stale"])
def test_offload_sampled_decode_gives_jax_tokens(model, jax_kmeans_init,
                                                 recorded, stale):
    je, want, pe, got = _run_both(model, "bf16", stale, 10, sampled=True,
                                  temperature=0.9, top_k=20, sample_seed=3)
    assert got == want
    for x, y in zip(recorded["jax_logits"], pe.logits_log):
        assert np.abs(x - y.numpy()).max() <= LOGIT_TOL
    assert recorded["counts"] == recorded["jax_counts"]


def test_offload_respects_max_seq_len(model):
    _, params, ids = model
    _, ecfg = _ecfgs(max_seq_len=128)
    with pytest.raises(ValueError, match="max_seq_len"):
        OffloadEngine(ecfg, params, dtype=torch.float32,
                      device="cpu").generate(ids, 4)


def test_engine_routes_offload_to_the_tier(model, jax_kmeans_init):
    jparams, params, ids = model
    _, ecfg = _ecfgs()
    eng = Engine(ecfg, params, dtype=torch.float32, device="cpu")
    res = eng.generate(ids, 8)
    assert res.policy_name == "pq_search_offload"
    assert res.tokens == OffloadEngine(ecfg, params, dtype=torch.float32,
                                       device="cpu").generate(ids, 8)
    # a prompt too short for pq_search falls back to `original`, in device
    # memory, as the JAX Engine does
    assert eng.generate(ids[:20], 4).policy_name == "original"
    with pytest.raises(ValueError, match="offload"):
        eng.generate(ids[100:], 4, prefix=eng.prefill_prefix(ids[:100]))
    with pytest.raises(ValueError, match="BatchOffloadEngine"):
        BatchEngine(ecfg, params, batch_size=2, prefill_len=320,
                    max_new_tokens=8, dtype=torch.float32, device="cpu")
    # the ip metric is ported (tests/test_torch_pq_branches.py holds its
    # tokens to JAX's): the tier routes it too, without a histogram
    ip = dataclasses.replace(ecfg, pq=dataclasses.replace(ecfg.pq,
                                                          metric="ip"))
    ip_eng = Engine(ip, params, dtype=torch.float32, device="cpu")
    res = ip_eng.generate(ids, 4)
    assert res.policy_name == "pq_search_offload" and len(res.tokens) == 4
    assert not ip_eng._off_engine.use_jhist


def test_offload_matches_device_tier_engine(model):
    # the accuracy twin: the same block selection in a different memory
    # hierarchy (as tests/test_offload_engine.py asks of the JAX tiers)
    _, params, ids = model
    _, ecfg = _ecfgs()
    dev_tier = dataclasses.replace(
        ecfg, cache=dataclasses.replace(ecfg.cache, offload=False))
    hbm = Engine(dev_tier, params, dtype=torch.float32,
                 device="cpu").generate(ids, 10)
    eng = OffloadEngine(ecfg, params, dtype=torch.float32, device="cpu")
    off = eng.generate(ids, 10)
    assert hbm.policy_name == "pq_search"
    assert sum(a == b for a, b in zip(hbm.tokens, off)) >= 8, (hbm.tokens,
                                                               off)
    assert eng.store.hits > 0
    t = eng.timings
    assert t["steps"] == 9 and t["decode_s"] >= t["host_s"] > 0
