"""The port's sequence-parallel (ring) prefill on the CPU.

Ranks are gloo processes (``parallel/launch.py``; bodies in
``parallel/workers.py``). Ring attention over sp slices is held to dense
causal attention in float32 (1e-5), with and without left padding;
distributed Lloyd to the JAX package's sharded ``kmeans`` under
``shard_map``, both started from JAX's ``iters=0`` centroids (the port's
k-means++ draws from torch: centroids within 1e-5, codes equal); the ring
handoff state (``gather_state_tp``) to the TP prefill's and, sliced per
rank, to the JAX ``TPEngine``'s ring prefill state; and ``generate_ring``
gives ``generate``'s tokens and JAX's ``generate_ring``'s exactly, as
JAX's own test asks. The engine runs take weights drawn by JAX and seed
their k-means from the JAX package's draws (``pq.use_seed_draws``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pqcache_tpu import config as jconfig
from pqcache_tpu.core import pq as jpq
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.parallel import tp_decode as jtp
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.parallel import launch, sharding, workers
from test_torch_parallel_tp import jax_seed_draws

torch.set_num_threads(1)


def run(fn, n, *args, **kwargs):
    return launch.launch(fn, n, backend="gloo", devices=["cpu"] * n,
                         args=args, kwargs=kwargs, timeout=240)


def _dense(q, k, v, pad):
    """Causal GQA attention in float32 over keys >= pad."""
    H, T, D = q.shape
    g = H // k.shape[0]
    s = torch.einsum("hqd,hkd->hqk", q, k.repeat_interleave(g, 0)) / D ** 0.5
    pos = torch.arange(T)
    mask = (pos[None, :] <= pos[:, None]) & (pos >= pad)[None, :]
    p = torch.softmax(torch.where(mask, s, -torch.inf), -1)
    return torch.einsum("hqk,hkd->hqd", p, v.repeat_interleave(g, 0))


@pytest.mark.parametrize("sp,pad", [(2, 0), (2, 21), (4, 0), (4, 37)])
def test_ring_attention_matches_dense(sp, pad):
    g = torch.Generator().manual_seed(sp + pad)
    T, D = 128, 16
    q = torch.randn(8, T, D, generator=g)
    k, v = torch.randn(4, T, D, generator=g), torch.randn(4, T, D, generator=g)
    outs = run(workers.ring_attention_slices, sp, q, k, v,
               torch.arange(T) >= pad, 8)
    got = torch.cat(outs, 1)
    torch.testing.assert_close(got[:, pad:], _dense(q, k, v, pad)[:, pad:],
                               rtol=1e-5, atol=1e-5)


def test_distributed_lloyd_matches_jax_sharded_kmeans():
    rng = np.random.default_rng(4)
    G, N, d, C, iters = 2, 256, 4, 8, 5
    x = rng.normal(size=(G, N, d)).astype(np.float32)
    valid = np.arange(N) >= 40                      # a left-padded prompt
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2,), ("sp",))

    def sharded(n_iters):
        def body(xs, ws):
            r = jpq.kmeans(xs, C, iters=n_iters, seed=7, axis_name="sp",
                           valid_mask=ws)
            return r.centroids, r.codes
        return jax.jit(shard_map(body, mesh=mesh,
                                 in_specs=(P(None, "sp", None), P(None, "sp")),
                                 out_specs=(P(), P(None, "sp")),
                                 check_rep=False))(
            jnp.asarray(x), jnp.asarray(valid[None]))
    init, _ = sharded(0)
    jc, jcodes = sharded(iters)
    res = run(workers.kmeans_slices, 2, torch.from_numpy(x),
              torch.from_numpy(valid), C, iters,
              torch.from_numpy(np.array(init)))
    assert torch.equal(res[0][0], res[1][0])            # replicated
    np.testing.assert_allclose(res[0][0].numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    codes = torch.cat([r[1] for r in res], 1).numpy()
    np.testing.assert_array_equal(codes[:, valid], np.asarray(jcodes)[:,
                                                                      valid])


def test_distributed_relocation_takes_the_global_farthest_point():
    """One centroid duplicated, so one cluster per group goes empty: the
    shard holding the globally farthest point wins, which is where the
    unsharded k-means relocates it (JAX's sharded seeding cannot be handed
    such an init; the port's own unsharded run is the reference)."""
    rng = np.random.default_rng(6)
    G, N, d, C = 2, 256, 4, 8
    x = torch.from_numpy(rng.normal(size=(G, N, d)).astype(np.float32))
    valid = torch.arange(N) >= 40
    init = x[:, 40:40 + C].clone()
    init[:, 1] = init[:, 0]
    ref = pq.kmeans(x, C, 4, init_centroids=init, valid_mask=valid[None])
    res = run(workers.kmeans_slices, 2, x, valid, C, 4, init)
    torch.testing.assert_close(res[0][0], ref.centroids, rtol=1e-5,
                               atol=1e-5)
    codes = torch.cat([r[1] for r in res], 1)
    assert torch.equal(codes[:, valid], ref.codes[:, valid])


def _cfgs(kv_dtype="bf16"):
    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=2, num_heads=8,
                                        num_kv_heads=4, hidden_size=64),
            pq=mod.PQConfig(n_subvec_per_head=2, n_subbits=4,
                            kmeans_iters=6, approx_topk=False),
            budget=mod.BudgetConfig(compress_ratio=0.3, recent_ratio=0.5,
                                    sink_size=4),
            cache=mod.CacheConfig(kv_dtype=kv_dtype),
            runtime=mod.RuntimeConfig(policy="pq_search", prefill_bucket=64,
                                      max_new_tokens=8, max_seq_len=512,
                                      kernels="xla"))
    return build(jconfig), build(config)


@pytest.fixture(scope="module")
def model():
    jparams = jllama.init_params(_cfgs()[0].model, jax.random.PRNGKey(11),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    ids = np.random.default_rng(5).integers(
        0, _cfgs()[1].model.vocab_size, 230)
    # 256-token prompts, sink 4; 4 kv heads x 2 subvectors
    return jparams, params, ids, jax_seed_draws([(252, 16, 8)])


def _jax_tp(jcfg, jparams, max_new=8):
    return jtp.TPEngine(jcfg, jparams,
                        Mesh(np.asarray(jax.devices()[:2]), ("tp",)),
                        prefill_len=256, max_new_tokens=max_new,
                        dtype=jnp.float32)


def test_gather_state_tp_builds_the_tp_prefill_state(model):
    jparams, params, ids, draws = model
    jcfg, cfg = _cfgs()
    tokens = np.zeros((256,), np.int32)
    tokens[26:] = ids
    first, jst = _jax_tp(jcfg, jparams, 2)._ring_prefill_program(512)(
        jparams, jnp.asarray(tokens), jnp.asarray(26, jnp.int32),
        jnp.asarray(230, jnp.int32))
    jst = bridge.pq_state_from_numpy(jax.tree.map(np.asarray, jst),
                                     device="cpu")
    res = run(workers.gather_state, 2, cfg, params, ids, 256,
              seed_draws=draws)
    for rank, r in enumerate(res):
        ring, tp = r["ring"], r["tp"]
        want = sharding.shard_state(jst, rank, 2)
        assert int(torch.argmax(r["ring_logits"])) == int(first)
        torch.testing.assert_close(r["ring_logits"], r["tp_logits"],
                                   rtol=1e-4, atol=1e-4)
        for f in ("k_sink", "v_sink", "kv_tail"):
            torch.testing.assert_close(getattr(ring, f), getattr(tp, f),
                                       rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(getattr(ring, f), getattr(want, f),
                                       rtol=1e-4, atol=1e-4)
        assert (ring.n_cand, ring.pos) == (tp.n_cand, tp.pos)
        assert (ring.n_cand, ring.pos) == (int(want.n_cand), int(want.pos))
        n = ring.n_cand
        same = (ring.codes[..., :n] == tp.codes[..., :n]).float().mean()
        assert same >= 0.99, same
        same = (ring.codes[..., :n] == want.codes[..., :n]).float().mean()
        assert same >= 0.99, same
        torch.testing.assert_close(ring.centroids, want.centroids,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_generate_ring_gives_generate_tokens(model, kv_dtype):
    jparams, params, ids, draws = model
    jcfg, cfg = _cfgs(kv_dtype)
    want = _jax_tp(jcfg, jparams).generate_ring(ids.astype(np.int32),
                                                 max_new_tokens=8)
    plain = run(workers.tp_generate, 2, cfg, params, ids, 256, 8,
                seed_draws=draws)
    ring = run(workers.tp_generate, 2, cfg, params, ids, 256, 8, ring=True,
               seed_draws=draws)
    assert ring[0]["tokens"] == plain[0]["tokens"] == plain[1]["tokens"]
    assert ring[0]["tokens"] == want
    st = ring[0]["comm"]["tp"]
    assert st["ring_shift"]["calls"] == cfg.model.num_layers    # sp - 1
    assert st["all_to_all"]["calls"] == 1
