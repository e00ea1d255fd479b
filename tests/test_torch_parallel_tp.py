"""The port's tensor-parallel pieces on the CPU: sharding tables, the
collectives, the launcher, the k-means++ seeding hook and ``TPEngine``.

Ranks are processes (``parallel/launch.py``, gloo, one torch thread each)
whose bodies live in ``parallel/workers.py``: the children import no JAX.
``TPEngine`` at tp 2 is held to the port's single-device ``Engine`` under
the JAX package's own rule for tp against one device (the first 5 of 8
tokens equal and at least 6 of 8: the all-reduce splits the wo / down
contractions, so float32 summation order differs); decode from a JAX
``TPEngine`` prefill state, sliced per rank, gives JAX's tokens with every
step's logits within 1e-4 of JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pqcache_tpu import config as jconfig
from pqcache_tpu.core.budget import compute_budget as jcompute_budget
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.parallel import sharding as jsharding
from pqcache_tpu.parallel import tp_decode as jtp
from pqcache_tpu.policies.base import get_policy as jget_policy
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.parallel import launch, sharding, tp_decode, workers
from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
from pqcache_tpu_torch.runtime.generate import Engine
from pqcache_tpu_torch.runtime.state import PQState

torch.set_num_threads(1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def run(fn, n, *args, **kwargs):
    return launch.launch(fn, n, backend="gloo", devices=["cpu"] * n,
                         args=args, kwargs=kwargs, timeout=240)


def jax_seed_draws(shapes, seed=4321, pool=4096) -> dict:
    """The JAX package's k-means++ draws (``core/pq._kmeanspp_init``: the
    pool permutation and, per step and global group, the uniforms) for
    each (N, C, groups) of ``shapes``, as ``pq.use_seed_draws`` takes
    them: a rank seeded from them seeds as JAX does on the same points."""
    out = {}
    for N, C, G in shapes:
        kperm, kpick = jax.random.split(jax.random.PRNGKey(seed))
        P = min(N, pool)
        u = jax.vmap(lambda k: jax.vmap(lambda g: jax.random.uniform(
            jax.random.fold_in(k, g), (P,), minval=1e-12, maxval=1.0))(
                jnp.arange(G)))(jax.random.split(kpick, C - 1))
        out[(N, C, G)] = (np.array(jax.random.permutation(kperm, N)),
                          np.array(u))
    return out


@pytest.fixture
def seeded_like_jax():
    """Installs a table of JAX's draws in this process for one test
    (``pq.use_seed_draws``), then the generator again."""
    yield lambda table: pq.use_seed_draws(table)
    pq.use_seed_draws(None)


def _tp_dim(spec):
    """The dimension a JAX PartitionSpec puts on "tp" (None: replicated)."""
    return next((i for i, a in enumerate(spec) if a == "tp"), None)


def test_sharding_tables_match_jax_specs():
    jp, jt = jsharding.param_specs(None), jtp.PARAM_SPECS
    for port, ref in ((sharding.param_specs(), jp),
                      (tp_decode.PARAM_SPECS, jt)):
        assert set(port) == set(ref) and set(port["layers"]) == set(
            ref["layers"])
        for k in ("embed", "final_norm", "lm_head"):
            assert port[k] == _tp_dim(ref[k]), k
        for k, s in ref["layers"].items():
            assert port["layers"][k] == _tp_dim(s), k
    jst = jsharding.pq_state_specs(jhist=True, int8_scales=True)
    port = sharding.pq_state_specs(jhist=True, int8_scales=True)
    for f in ("k_sink", "v_sink", "kv_tail", "codes", "centroids", "phi",
              "n_cand", "pos", "jhist", "k_scale", "v_scale"):
        assert port[f] == _tp_dim(getattr(jst, f)), f
    jd = jsharding.dense_state_specs(with_scores=True)
    port = sharding.dense_state_specs(with_scores=True)
    for f in ("k_cache", "v_cache", "length", "start", "pos", "scores",
              "mask"):
        assert port[f] == _tp_dim(getattr(jd, f)), f


def test_shard_params_and_state_slices():
    m = config.tiny_model_config(num_layers=2)
    params = llama.init_params(m, torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    shards = [sharding.shard_params(params, r, 2) for r in range(2)]
    for k, dim in tp_decode.PARAM_SPECS["layers"].items():
        parts = [s["layers"][k] for s in shards]
        if dim is None:
            assert all(p is params["layers"][k] for p in parts)
            continue
        assert all(p.is_contiguous() for p in parts)
        assert parts[0].data_ptr() != params["layers"][k].data_ptr()
        torch.testing.assert_close(torch.cat(parts, dim),
                                   params["layers"][k], rtol=0, atol=0)
    vocab = sharding.shard_params(params, 1, 2, sharding.param_specs())
    assert vocab["lm_head"].shape[1] == m.vocab_size // 2
    # a global PQState and a batched one (counters [B], B·H_kv folded)
    # cut to kv-head (and slot) blocks that reassemble the original
    g = torch.Generator().manual_seed(1)
    L, H, S = 2, 4, 2

    def state(B):
        R = B * H
        t = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
        cnt = (torch.arange(B, dtype=torch.int32) if B > 1 else 5)
        return PQState(k_sink=t(L, R, 3, 8), v_sink=t(L, R, 3, 8),
                       kv_tail=t(L, R, 16, 16),
                       codes=torch.randint(0, 16, (L, R, S, 16),
                                           dtype=torch.uint8, generator=g),
                       centroids=t(L, R, S, 16, 4), phi=t(L, R * S, 1, 1),
                       n_cand=cnt, pos=cnt)
    one = state(1)
    parts = [sharding.shard_state(one, r, 2) for r in range(2)]
    for f in ("k_sink", "kv_tail", "codes", "centroids", "phi"):
        torch.testing.assert_close(torch.cat([getattr(p, f) for p in parts],
                                             1), getattr(one, f))
    assert parts[1].n_cand == 5
    four = state(4)
    part = sharding.shard_state(four, 1, 2, dp_rank=1, dp=2)
    want = sharding._fold(sharding._unfold(four.kv_tail, 4)[:, 2:, 2:])
    torch.testing.assert_close(part.kv_tail, want)
    want = sharding._fold(sharding._unfold(four.phi, 4)[:, 2:, 4:])
    torch.testing.assert_close(part.phi, want)
    assert part.pos.tolist() == [2, 3]


def test_kmeans_group_offset_draws_the_unsharded_seeds():
    """k-means++ on groups [2, 4) of 4, with group_offset 2, gives exactly
    rows [2, 4) of the 4-group run from the same generator seed."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 300, 4)).astype(np.float32))
    full = pq.kmeans(x, 8, iters=3, valid_len=270,
                     generator=torch.Generator().manual_seed(5))
    half = pq.kmeans(x[2:], 8, iters=3, valid_len=270,
                     generator=torch.Generator().manual_seed(5),
                     group_offset=2, total_groups=4)
    assert torch.equal(half.centroids, full.centroids[2:])
    assert torch.equal(half.codes, full.codes[2:])
    own = pq.kmeans(x[2:], 8, iters=3, valid_len=270,
                    generator=torch.Generator().manual_seed(5))
    assert not torch.equal(own.centroids, full.centroids[2:])


@pytest.mark.parametrize("valid_len", [200, 252])
def test_seed_draws_give_jax_kmeanspp_seeds(seeded_like_jax, valid_len):
    """Seeded from JAX's draws, the port's k-means++ gives the JAX
    package's seeds (iters=0) on the same points, and a head shard
    (group_offset) gives JAX's shard's centroids after Lloyd."""
    from pqcache_tpu.core import pq as jpq
    x = np.random.default_rng(6).normal(size=(8, 252, 16)).astype(
        np.float32)
    seeded_like_jax(jax_seed_draws([(252, 16, 8)]))
    for off, G, iters in ((0, 8, 0), (4, 4, 5)):
        want = jpq.kmeans(jnp.asarray(x[off:off + G]), 16, iters=iters,
                          seed=4321, valid_len=valid_len,
                          group_offset=off).centroids
        got = pq.kmeans(torch.from_numpy(x[off:off + G]), 16, iters,
                        valid_len=valid_len, group_offset=off,
                        total_groups=8).centroids
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(KeyError, match="no k-means"):
        pq.kmeans(torch.from_numpy(x[:, :250]), 16, 0)


def test_init_params_shard_draws_the_shard_of_the_model():
    """Each rank's shard drawn alone (no process holding the whole model)
    is shard_params of the whole model drawn from the same seed; the
    layers rebuilt from the shards are the model's."""
    m = config.tiny_model_config(num_layers=2)
    full = llama.init_params(m, torch.Generator().manual_seed(3),
                             dtype=torch.float32, device="cpu")
    for r in range(2):
        got = sharding.init_params_shard(m, torch.Generator().manual_seed(3),
                                         r, 2, dtype=torch.float32,
                                         device="cpu")
        want = sharding.shard_params(full, r, 2)
        for k in ("embed", "final_norm", "lm_head"):
            assert torch.equal(got[k], want[k]), k
        for k, v in want["layers"].items():
            assert torch.equal(got["layers"][k], v), k
    one = sharding.gather_layer(full, 1, None)
    assert all(torch.equal(one[k], v[1]) for k, v in full["layers"].items())


def test_collectives_and_launcher():
    n = 2
    res = run(workers.comm_ops, n)
    for r, out in enumerate(res):
        assert out["all_reduce"].tolist() == [3.0] * 3
        assert out["all_reduce_max"].tolist() == [1.0]
        assert out["all_gather"].tolist() == [[0.0, 1.0]] * 2
        # rank r receives block r (rows [2r, 2r + 2)) of every rank's
        # [4, 3] matrix, concatenated along columns in rank order
        want = torch.cat([torch.arange(12.).reshape(4, 3)[2 * r:2 * r + 2]
                          + 100 * s for s in range(n)], 1)
        assert torch.equal(out["all_to_all"], want)
        prev = (r - 1) % n
        assert out["ring_shift"][0].tolist() == [float(prev)] * 4
        assert out["ring_shift"][1].tolist() == [prev]
        assert out["all_true"] == (False, True)
        assert {s["route"] for s in out["stats"].values()} == {"direct"}
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        run(workers.comm_ops, n, fail_rank=1)
    with pytest.raises(ValueError, match="one card per rank"):
        launch.launch(workers.comm_ops, 2, backend="nccl",
                      devices=["cuda:0"] * 2)


def test_capture_under_a_process_group_raises():
    with pytest.raises(ValueError, match="not captured"):
        BatchedDecoder(None, None, None, None, graph=True, comm=object())


def _cfgs(jcfg, cfg, **pq_kw):
    kw = dict(
        pq=dict(n_subvec_per_head=2, n_subbits=4, kmeans_iters=8,
                approx_topk=False, adc_mode="v1", **pq_kw.pop("pq", {})),
        budget=dict(compress_ratio=0.3, recent_ratio=0.5, sink_size=4),
        cache=dict(kv_dtype=pq_kw.pop("kv_dtype", "bf16")),
        runtime=dict(policy="pq_search", prefill_bucket=64, max_new_tokens=8,
                     max_seq_len=512, kernels="xla"))

    def build(mod, m):
        return mod.EngineConfig(
            model=m, pq=mod.PQConfig(**kw["pq"]),
            budget=mod.BudgetConfig(**kw["budget"]),
            cache=mod.CacheConfig(**kw["cache"]),
            runtime=mod.RuntimeConfig(**kw["runtime"]))
    return build(jconfig, jcfg), build(config, cfg)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfig.tiny_model_config(num_layers=2)   # H 4, H_kv 2: tp 2
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=250)
    return jcfg, jparams, config.tiny_model_config(num_layers=2), params, ids


def _prefix_rule(ref, out):
    """The JAX package's tp-against-one-device rule."""
    assert out[:5] == ref[:5], (ref, out)
    assert sum(a == b for a, b in zip(ref, out)) >= 6, (ref, out)


@pytest.mark.parametrize("case", ["bf16", "int8", "jhist"])
def test_tp2_matches_single_device(tiny, case):
    _, _, cfg_m, params, ids = tiny
    kw = {"kv_dtype": "int8"} if case == "int8" else {}
    if case == "jhist":
        kw["pq"] = {"select_block": 16}
    _, ecfg = _cfgs(jconfig.tiny_model_config(num_layers=2), cfg_m, **kw)
    ref = Engine(ecfg, params, dtype=torch.float32,
                 device="cpu").generate(ids, max_new_tokens=8).tokens
    res = run(workers.tp_generate, 2, ecfg, params, ids, 256, 8)
    assert res[0]["tokens"] == res[1]["tokens"]
    _prefix_rule(ref, res[0]["tokens"])
    calls = res[0]["comm"]["tp"]["all_reduce"]["calls"]
    assert calls == 2 * cfg_m.num_layers * 8        # 2 per layer per pass


def test_tp2_decode_from_a_jax_tp_state(tiny):
    """JAX's TPEngine prefills on a 2-device mesh; its global state moves
    across, each rank takes its kv-head slice and decodes: JAX's tokens,
    and each step's logits within 1e-4 of JAX's single-device decode from
    the same state."""
    jcfg, jparams, cfg_m, params, ids = tiny
    jecfg, ecfg = _cfgs(jcfg, cfg_m)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2,), ("tp",))
    jeng = jtp.TPEngine(jecfg, jparams, mesh, prefill_len=256,
                        max_new_tokens=8, dtype=jnp.float32)
    jtoks = jeng.generate(ids, max_new_tokens=8)
    toks = np.zeros((256,), np.int32)
    toks[6:] = ids
    first, jst = jeng._prefill(jparams, jeng.init_state(), jnp.asarray(toks),
                               jnp.asarray(6, jnp.int32),
                               jnp.asarray(250, jnp.int32))
    assert int(first) == jtoks[0]
    pol = jget_policy(jecfg, jcompute_budget(jecfg.budget, 256, 8))
    st, jlogits = jst, []
    for i, t in enumerate(jtoks[:-1]):
        lg, st = jllama.decode_step(jcfg, jparams, pol, st,
                                    jnp.asarray(t, jnp.int32),
                                    jnp.asarray(250 + i, jnp.int32))
        jlogits.append(np.asarray(lg))
    state = bridge.pq_state_from_numpy(jax.tree.map(np.asarray, jst),
                                       device="cpu")
    res = run(workers.tp_decode_state, 2, ecfg, params, state, jtoks[0], 250,
              7, 256, 8)
    assert res[0]["tokens"] == res[1]["tokens"] == jtoks[1:]
    np.testing.assert_allclose(res[0]["logits"].numpy(), np.stack(jlogits),
                               **LOGIT_TOL)


def test_tp_engine_refuses_what_jax_refuses(tiny):
    _, _, cfg_m, params, _ = tiny
    _, ecfg = _cfgs(jconfig.tiny_model_config(num_layers=2), cfg_m)
    with pytest.raises(ValueError, match="must divide head counts"):
        tp_decode.local_model_config(ecfg, 3)
    with pytest.raises(ValueError, match="W8 weights"):
        from pqcache_tpu_torch.core.quant import quantize_weight_tree
        sharding.shard_params(quantize_weight_tree(params), 0, 2)
    other = dataclasses.replace(ecfg, runtime=dataclasses.replace(
        ecfg.runtime, policy="original"))
    with pytest.raises(ValueError, match="run pq_search"):
        tp_decode.TPEngine(other, params, None, 256, 8)
