"""The port's dp x tp batched engines on the CPU, against the JAX
package's.

Ranks are gloo processes (``parallel/launch.py``; bodies in
``parallel/workers.py``), seeded with the JAX package's k-means++ draws
(``pq.use_seed_draws``), on weights drawn by JAX. ``BatchTPEngine`` at
dp 2 x tp 2 gives the tokens of JAX's ``BatchTPEngine`` on a (2, 2) mesh
(both split the row-parallel contractions alike) and is held to the port's
single-device ``Engine`` under the JAX package's rule for tp against one
device (first 5 of 8 tokens equal, at least 6 of 8: float32 summation
order differs there); ``serve_local`` with each dp group's own queue gives JAX's
``DistributedBatchTPEngine.serve_local`` tokens and the tokens of static
``generate_batch`` runs exactly, monolithic and slab-wise (interleaved),
as JAX's ``tests/test_dcn.py`` asks; ``all_hosts_done`` agrees across
processes.
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
from pqcache_tpu.parallel import batch_tp as jbatch_tp
from pqcache_tpu.parallel import dcn as jdcn
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.parallel import dcn, factory, launch, workers
from pqcache_tpu_torch.runtime.generate import Engine
from test_torch_parallel_tp import jax_seed_draws, seeded_like_jax  # noqa

torch.set_num_threads(1)
# (N, C, groups) of every k-means: 256-token slots, sink 4; 4 kv heads x 2
DRAWS = [(252, 16, 8)]


def run(fn, n, *args, **kwargs):
    return launch.launch(fn, n, backend="gloo", devices=["cpu"] * n,
                         args=args, kwargs=kwargs, timeout=240)


def _cfgs(prefill_chunk=0):
    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=2, num_heads=8,
                                        num_kv_heads=4, hidden_size=64),
            pq=mod.PQConfig(n_subvec_per_head=2, n_subbits=4, kmeans_iters=8,
                            approx_topk=False, adc_mode="v1"),
            budget=mod.BudgetConfig(compress_ratio=0.3, recent_ratio=0.5,
                                    sink_size=4),
            runtime=mod.RuntimeConfig(policy="pq_search", prefill_bucket=64,
                                      max_new_tokens=8, max_seq_len=512,
                                      kernels="xla",
                                      prefill_chunk=prefill_chunk))
    return build(jconfig), build(config)


def _cfg(prefill_chunk=0):
    return _cfgs(prefill_chunk)[1]


@pytest.fixture(scope="module")
def model():
    jcfg = _cfgs()[0]
    jparams = jllama.init_params(jcfg.model, jax.random.PRNGKey(9),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.model.vocab_size, size=256)
               for _ in range(4)]
    return jparams, params, prompts, jax_seed_draws(DRAWS)


def _mesh(dp, tp):
    return Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("dp", "tp"))


def _prefix_rule(ref, out):
    """The JAX package's tp-against-one-device rule."""
    assert out[:5] == ref[:5], (ref, out)
    assert sum(a == b for a, b in zip(ref, out)) >= 6, (ref, out)


def test_batch_tp_dp2_tp2_matches_single_device(model, seeded_like_jax):
    jparams, params, prompts, draws = model
    jcfg, cfg = _cfgs()
    jeng = jbatch_tp.BatchTPEngine(jcfg, jparams, _mesh(2, 2),
                                   prefill_len=256, max_new_tokens=8,
                                   dtype=jnp.float32)
    jax_toks = jeng.generate_batch([p.astype(np.int32) for p in prompts],
                                   max_new_tokens=8)
    seeded_like_jax(draws)
    eng = Engine(cfg, params, dtype=torch.float32, device="cpu")
    refs = [eng.generate(p, max_new_tokens=8).tokens for p in prompts]
    res = run(workers.batch_generate, 4, cfg, params, 2, prompts, 256, 8,
              seed_draws=draws)
    assert all(r["tokens"] == res[0]["tokens"] for r in res)
    for ref, jref, out in zip(refs, jax_toks, res[0]["tokens"]):
        assert out == jref, (jref, out)
        _prefix_rule(ref, out)
    # the dp groups share no collective while decoding: only the tp groups
    # all-reduce, and the world agrees once per decode chunk
    for r in res:
        assert set(r["comm"]["world"]) == {"all_true"}
        assert not r["comm"]["dp"]
        assert r["comm"]["tp"]["all_reduce"]["calls"] > 0


@pytest.mark.parametrize("interleave", ["off", "on"])
def test_serve_local_matches_static_batches(model, interleave):
    """Two dp groups (one rank each), each serving its own queue of two
    requests over one slot: admit, decode, retire, admit; the tokens are
    JAX's serve_local of the four requests on a (2, 2) mesh (one process
    feeding both groups), and those of static generate_batch runs of the
    same pairs. "on" admits slab-wise (a chunked prefill of 2 x 128
    rows)."""
    jparams, params, prompts, draws = model
    jcfg, cfg = _cfgs(prefill_chunk=128 if interleave == "on" else 0)
    jeng = jdcn.DistributedBatchTPEngine(jcfg, jparams, _mesh(2, 2),
                                         prefill_len=256, max_new_tokens=8,
                                         dtype=jnp.float32,
                                         interleave=interleave)
    jax_served = jeng.serve_local(
        [(i, p.astype(np.int32)) for i, p in enumerate(prompts)],
        max_new_tokens=8)
    queues = [[(0, prompts[0]), (2, prompts[2])],
              [(1, prompts[1]), (3, prompts[3])]]
    res = run(workers.serve_local, 2, cfg, params, 2, queues, 256, 8,
              interleave=interleave, seed_draws=draws)
    for r in res:
        assert r["interleave"] == (interleave == "on")
        assert set(r["served"]) == {q[0] for q in queues[r["dp_rank"]]}
        assert r["served"] == {k: jax_served[k] for k in r["served"]}
        assert r["served"] == {k: r["static"][k] for k in r["served"]}
        first = queues[r["dp_rank"]][0][0]
        assert r["local"] == [r["static"][first]]


def test_all_hosts_done():
    assert run(workers.hosts_done, 2) == [[False, True], [False, True]]
    assert dcn.all_hosts_done(True) and not dcn.all_hosts_done(False)


def test_single_process_mesh_and_local_rows():
    mesh = dcn.serving_mesh(1, 1, device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.tp_comm is None
    dcn.init_distributed("gloo")                    # no world: a no-op
    rows = dcn.host_local_rows(mesh, 3, [[1, 2], [3, 4], [5, 6]])
    arr, off = dcn.read_local_rows(mesh, rows)
    assert arr.tolist() == [[1, 2], [3, 4], [5, 6]] and off == 0
    with pytest.raises(ValueError, match="share"):
        dcn.host_local_rows(mesh, 4, [[1, 2]])
    with pytest.raises(ValueError, match="world of 4 processes"):
        factory.make_mesh(config.ParallelConfig(2, 2), device="cpu")
    cfg = dataclasses.replace(_cfg(), parallel=config.ParallelConfig(1, 1))
    params = llama.init_params(cfg.model, torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    eng = factory.make_engine(cfg, params, prefill_len=256, max_new_tokens=8,
                              dtype=torch.float32, device="cpu")
    assert type(eng).__name__ == "TPEngine"
    pool = factory.make_engine(cfg, params, prefill_len=256,
                               max_new_tokens=8, batched=True,
                               dtype=torch.float32, device="cpu")
    assert type(pool).__name__ == "BatchTPEngine"
