"""The PyTorch port's PQ math against the JAX package, and its recall.

Inputs come from a numpy seed. Both sides compute in float32, so centroids
agree to ~1e-5 (summation order) and codes, block selections and histogram
counts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu.core import pq as jpq
from pqcache_tpu_torch.core import pq

torch.set_num_threads(1)


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_kmeans_matches_jax_from_the_same_init(init):
    # The JAX seeding draws from jax.random, which torch cannot replay: take
    # JAX's initial centroids (iters=0) and hand them to the port. With
    # init="random", 16 draws mod 40 valid points collide, so duplicate
    # centroids leave clusters empty and relocation runs.
    rng = np.random.default_rng(0)
    G, N, d, C, valid, iters = 4, 256, 8, 16, 40, 5
    x = rng.normal(size=(G, N, d)).astype(np.float32)
    if init == "kmeans++":
        valid = 200
    j0 = jpq.kmeans(jnp.asarray(x), C, iters=0, seed=7, valid_len=valid,
                    chunk=64, init=init)
    jr = jpq.kmeans(jnp.asarray(x), C, iters=iters, seed=7, valid_len=valid,
                    chunk=64, init=init)
    init_c = torch.from_numpy(np.asarray(j0.centroids))
    if init == "random":
        dup = [len(np.unique(np.asarray(j0.centroids)[g], axis=0)) < C
               for g in range(G)]
        assert any(dup), "the case must exercise empty-cluster relocation"
    tr = pq.kmeans(torch.from_numpy(x), C, iters=iters, valid_len=valid,
                   chunk=64, init_centroids=init_c)
    np.testing.assert_allclose(tr.centroids.numpy(),
                               np.asarray(jr.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    # pq_encode of the trained centroids reproduces the codes
    enc = pq.pq_encode(torch.from_numpy(x), tr.centroids)
    np.testing.assert_array_equal(enc.numpy(), np.asarray(
        jpq.pq_encode(jnp.asarray(x), jr.centroids)))


def test_kmeanspp_seeding_is_reproducible_and_valid():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 300, 4)).astype(np.float32))
    a = pq.kmeans(x, 8, iters=2, valid_len=250,
                  generator=torch.Generator().manual_seed(3))
    b = pq.kmeans(x, 8, iters=2, valid_len=250,
                  generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.centroids, b.centroids)
    assert torch.isfinite(a.centroids).all()
    assert a.codes.shape == (2, 300) and int(a.codes.max()) < 8


def test_joint_hist_and_block_selection_match_jax():
    rng = np.random.default_rng(2)
    H_kv, g, C, block, NB, D = 2, 2, 8, 16, 6, 32
    T = NB * block
    H = H_kv * g
    codes = rng.integers(0, C, size=(H_kv, 2, T)).astype(np.uint8)
    n_valid = 70
    J = pq.build_joint_hist(torch.from_numpy(codes), n_valid, n_centroids=C,
                            block=block)
    jJ = jpq.build_joint_hist(jnp.asarray(codes).astype(jnp.int32),
                              jnp.asarray(n_valid), n_centroids=C,
                              block=block)
    assert J.dtype == torch.uint8
    np.testing.assert_array_equal(J.numpy(), np.asarray(jJ))

    q = rng.normal(size=(H, 2, D // 2)).astype(np.float32)
    cent = rng.normal(size=(H_kv, 2, C, D // 2)).astype(np.float32)
    lut = pq.adc_lut_euc(torch.from_numpy(q), torch.from_numpy(cent))
    jlut = jpq.adc_lut_euc(jnp.asarray(q), jnp.asarray(cent))
    np.testing.assert_allclose(lut.numpy(), np.asarray(jlut), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pq.jhist_exp_lut(lut, D).numpy(),
                               np.asarray(jpq.jhist_exp_lut(jlut, D)),
                               rtol=1e-5, atol=1e-6)
    mass = pq.joint_block_mass(lut, J, head_dim=D)
    jmass = jpq.joint_block_mass(jlut, jJ, head_dim=D)
    np.testing.assert_allclose(mass.numpy(), np.asarray(jmass), rtol=1e-5,
                               atol=1e-6)
    for n_cand in (70, np.asarray([40, 90], np.int32)):
        sel = pq.topk_from_block_mass(mass, torch.as_tensor(n_cand), 40,
                                      group=g, block=block)
        jsel = jpq.topk_from_block_mass(jmass, jnp.asarray(n_cand), 40,
                                        group=g, block=block, approx=False)
        np.testing.assert_array_equal(np.sort(sel.numpy(), -1),
                                      np.sort(np.asarray(jsel), -1))


def test_jhist_add_tokens_saturates_at_255():
    C, block = 4, 256
    # a full 256-block of one code pair saturates at 255 when built
    codes = np.zeros((1, 2, 512), np.uint8)
    J = pq.build_joint_hist(torch.from_numpy(codes), 300, n_centroids=C,
                            block=block)
    jJ = jpq.build_joint_hist(jnp.asarray(codes).astype(jnp.int32),
                              jnp.asarray(300), n_centroids=C, block=block)
    np.testing.assert_array_equal(J.numpy(), np.asarray(jJ))
    assert int(J[0, 0, 0]) == 255 and int(J[0, 1, 0]) == 44
    # stacked [L, H_kv, NB, C^2] joins: one cell at 255 stays there, the
    # others count up by one — never a wrap to 0
    Js = torch.zeros((2, 2, 2, C * C), dtype=torch.uint8)
    Js[0, 1, 1, 5] = 255
    Js[1, 0, 1, 3] = 254
    tok = torch.tensor([[[1, 1], [1, 1]], [[0, 3], [2, 0]]])
    jJs = jnp.asarray(Js.numpy().copy())   # the port updates Js in place
    for _ in range(2):
        pq.jhist_add_tokens(Js, tok, 300, n_centroids=C, block=block)
        jJs = jpq.jhist_add_tokens(jJs, jnp.asarray(tok.numpy()), 300,
                                   n_centroids=C, block=block)
    np.testing.assert_array_equal(Js.numpy(), np.asarray(jJs))
    assert int(Js[0, 1, 1, 5]) == 255 and int(Js[1, 0, 1, 3]) == 255
    assert int(Js[0, 0, 1, 5]) == 2 and int(Js[1, 1, 1, 8]) == 2
    with pytest.raises(ValueError):
        pq.jhist_dtype(512)


def _make_keys(rng, H_kv, T, D, n_modes=32):
    """tests/test_recall.py's mixture keys (attention keys cluster)."""
    modes = rng.normal(size=(H_kv, n_modes, D)).astype(np.float32) * 2.0
    which = rng.integers(0, n_modes, size=(H_kv, T))
    noise = rng.normal(size=(H_kv, T, D)).astype(np.float32) * 0.7
    return np.take_along_axis(modes, which[..., None], axis=1) + noise


def _group_topk(scores, group, D, k):
    """GQA softmax-mass reduction + top-k over every candidate."""
    return pq.mips_topk(scores, scores.shape[1], k, group=group,
                        head_dim=D)[0]


def test_port_prefill_codebooks_reach_the_recall_operating_point():
    # the port's own k-means++ seeding (torch.Generator) must reach the
    # level tests/test_recall.py holds the JAX package to, at its sizes
    rng = np.random.default_rng(0)
    H_kv, group, T, D, S, C = 2, 2, 2048, 128, 2, 64
    H, d_sub = H_kv * group, D // S
    keys = _make_keys(rng, H_kv, T, D)
    queries = torch.from_numpy(rng.normal(size=(H, D)).astype(np.float32))
    xb = torch.from_numpy(keys.reshape(H_kv, T, S, d_sub).transpose(0, 2, 1, 3)
                          .reshape(H_kv * S, T, d_sub).copy())
    res = pq.kmeans(xb, C, iters=12, generator=torch.Generator().manual_seed(0))
    cent = res.centroids.reshape(H_kv, S, C, d_sub)
    codes = res.codes.reshape(H_kv, S, T)
    lut = pq.adc_lut_euc(queries.reshape(H, S, d_sub), cent)   # [H, S, C]
    codes_q = codes.repeat_interleave(group, 0)                # [H, S, T]
    scores = torch.gather(lut, 2, codes_q).sum(1)              # [H, T]
    k = T // 5
    idx = _group_topk(scores, group, D, k)
    keys_t = torch.from_numpy(keys)
    exact = pq.exact_topk(queries, keys_t, T, k, group=group)
    r = pq.topk_recall(idx, exact, group=group)
    ex_scores = torch.einsum("hd,htd->ht", queries,
                             keys_t.repeat_interleave(group, 0))
    ceiling = pq.topk_recall(_group_topk(ex_scores, group, D, k), exact,
                             group=group)
    assert r > 0.8 * ceiling, f"recall {r} vs ceiling {ceiling}"
    assert r > 0.4, f"absolute recall {r}"


def test_block_and_exact_topk_break_ties_like_jax():
    # torch.topk orders ties arbitrarily (on this input it returned
    # [5 23 16 17 ...]); jax.lax.top_k takes the lower index first, also
    # among -inf entries past n_valid
    mass = np.zeros((2, 30), np.float32)
    mass[:, 5] = 1.0
    for n_valid in (30, 9):
        sel = pq.topk_from_block_mass(torch.from_numpy(mass), n_valid, 12,
                                      group=1, block=1)
        jsel = jpq.topk_from_block_mass(jnp.asarray(mass),
                                        jnp.asarray(n_valid), 12, group=1,
                                        block=1, approx=False)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert sel[0].tolist() == [5, 0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11]
    # exact_topk over keys with repeated rows: tied logits
    rng = np.random.default_rng(4)
    keys = np.repeat(rng.normal(size=(2, 4, 8)).astype(np.float32), 10, 1)
    q = rng.normal(size=(4, 8)).astype(np.float32)
    for n_valid in (40, 13):
        got = pq.exact_topk(torch.from_numpy(q), torch.from_numpy(keys),
                            n_valid, 16, group=2)
        want = jpq.exact_topk(jnp.asarray(q), jnp.asarray(keys),
                              jnp.asarray(n_valid), 16, group=2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
