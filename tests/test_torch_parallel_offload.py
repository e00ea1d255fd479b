"""The port's sharded host-offload tier on the CPU, against the JAX
package's.

Ranks are gloo processes (``parallel/launch.py``; bodies in
``parallel/workers.py``), each running the batched offload engine at its
shard's shapes over its own host store, LFU and device cache slice, seeded
with the JAX package's k-means++ draws (``pq.use_seed_draws``) on weights
drawn by JAX. ``ShardedOffloadEngine`` at (dp, tp) = (1, 2) and (2, 2),
with a bf16 and an int8 store, gives the tokens of JAX's
``ShardedOffloadEngine`` on the same mesh exactly (float32), and those of
the port's single-device ``BatchOffloadEngine``, as JAX's
``test_offload_tp.py`` asks; with stale selection, which JAX's sharded
tier lacks, JAX's single-device ``BatchOffloadEngine``'s; and
``generate_ring`` (ring prefill straight into the sharded stores) gives
JAX's ``generate_ring`` tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pqcache_tpu import config as jconfig
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.parallel.offload_tp import \
    ShardedOffloadEngine as JShardedOffload
from pqcache_tpu.runtime.offload_batch import \
    BatchOffloadEngine as JBatchOffload
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.parallel import launch, workers
from pqcache_tpu_torch.runtime.offload_batch import BatchOffloadEngine
from test_torch_parallel_tp import jax_seed_draws, seeded_like_jax  # noqa

torch.set_num_threads(1)
GEN = 12
# (N, C, groups) of every k-means: 256-token slots, sink 4; 4 kv heads x 2
DRAWS = [(252, 16, 8)]


def run(fn, n, *args, **kwargs):
    return launch.launch(fn, n, backend="gloo", devices=["cpu"] * n,
                         args=args, kwargs=kwargs, timeout=240)


def _cfgs(kv_dtype="bf16", stale=False):
    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=2, num_heads=8,
                                        num_kv_heads=4, hidden_size=64),
            pq=mod.PQConfig(n_subvec_per_head=2, n_subbits=4,
                            kmeans_iters=8, approx_topk=False),
            budget=mod.BudgetConfig(compress_ratio=0.3, recent_ratio=0.5,
                                    sink_size=4),
            # 4 cache blocks of 32 rows for ~7 candidate blocks per slot:
            # hits, misses and LFU evictions all occur
            cache=mod.CacheConfig(offload=True, kv_dtype=kv_dtype,
                                  block_size=32, hbm_cache_tokens=128,
                                  stale_select=stale),
            runtime=mod.RuntimeConfig(policy="pq_search", prefill_bucket=64,
                                      max_new_tokens=24, max_seq_len=512,
                                      kernels="xla"))
    return build(jconfig), build(config)


def _cfg(kv_dtype="bf16", stale=False):
    return _cfgs(kv_dtype, stale)[1]


@pytest.fixture(scope="module")
def model():
    jparams = jllama.init_params(_cfgs()[0].model, jax.random.PRNGKey(9),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, _cfg().model.vocab_size, size=n)
               for n in (256, 230)]
    return jparams, params, prompts, jax_seed_draws(DRAWS)


def _mesh(dp, tp):
    return Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("dp", "tp"))


def _ref(cfg, params, prompts):
    return BatchOffloadEngine(cfg, params, batch_size=len(prompts),
                              dtype=torch.float32,
                              device="cpu").generate_batch(prompts, GEN)


@pytest.mark.parametrize("dp,tp,kv,stale", [
    (1, 2, "bf16", False), (2, 2, "bf16", False), (1, 2, "int8", False),
    (1, 2, "bf16", True)])
def test_sharded_offload_matches_single_device(model, seeded_like_jax, dp,
                                               tp, kv, stale):
    jparams, params, prompts, draws = model
    jcfg, cfg = _cfgs(kv, stale)
    jprompts = [p.astype(np.int32) for p in prompts]
    jeng = (JBatchOffload(jcfg, jparams, batch_size=2, dtype=jnp.float32)
            if stale else
            JShardedOffload(jcfg, jparams, _mesh(dp, tp), batch_size=2,
                            dtype=jnp.float32))
    want = jeng.generate_batch(jprompts, max_new_tokens=GEN)
    seeded_like_jax(draws)
    ref = _ref(cfg, params, prompts)
    res = run(workers.offload_generate, dp * tp, cfg, params, dp, prompts,
              GEN, seed_draws=draws)
    assert ref == want
    for r in res:
        assert r["tokens"] == want
        assert 0.0 < r["hit_rate"] < 1.0
        assert r["comm"]["tp"]["all_reduce"]["calls"] > 0


def test_sharded_offload_generate_ring(model, seeded_like_jax):
    jparams, params, prompts, draws = model
    jcfg, cfg = _cfgs()
    jeng = JShardedOffload(jcfg, jparams, _mesh(1, 2), batch_size=1,
                           dtype=jnp.float32)
    want = jeng.generate_ring(prompts[1].astype(np.int32),
                              max_new_tokens=GEN)
    seeded_like_jax(draws)
    ref = _ref(cfg, params, prompts[1:])[0]
    res = run(workers.offload_generate, 2, cfg, params, 1, prompts[1:], GEN,
              ring=True, seed_draws=draws)
    assert res[0]["tokens"] == res[1]["tokens"] == want == ref
    assert res[0]["comm"]["tp"]["all_to_all"]["calls"] == 1
    # one all-gather per split leaf of each layer rebuilds its weights
    assert res[0]["comm"]["tp"]["all_gather"]["calls"] == 7 * 2


def test_sharded_offload_refusals(model):
    _, params, prompts, _ = model
    from pqcache_tpu_torch.parallel.factory import make_mesh
    from pqcache_tpu_torch.parallel.offload_tp import ShardedOffloadEngine
    mesh = make_mesh(config.ParallelConfig(1, 1), device="cpu")
    eng = ShardedOffloadEngine(_cfg(), params, mesh, batch_size=2,
                               dtype=torch.float32)
    with pytest.raises(ValueError, match="dp == 1 and B == 1"):
        eng.generate_ring(prompts[0], GEN)
    with pytest.raises(ValueError, match="need 2 prompts"):
        eng.generate_batch(prompts[:1], GEN)
    chunked = dataclasses.replace(_cfg(), runtime=dataclasses.replace(
        _cfg().runtime, prefill_chunk=128))
    one = ShardedOffloadEngine(chunked, params, mesh, batch_size=1,
                               dtype=torch.float32)
    with pytest.raises(ValueError, match="unset runtime.prefill_chunk"):
        one.generate_ring(prompts[0], GEN)
