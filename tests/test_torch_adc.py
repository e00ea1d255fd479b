"""The port's ADC scorers (K5, K3), row gather (K6) and GQA top-k against
the JAX package, on the CPU.

Inputs come from a numpy seed. On the CPU every kernel wrapper computes its
plain PyTorch version, so these tests hold the plain versions (and the
wrappers' CPU branches) against the JAX functions, the Pallas kernels run in
interpret mode as the JAX package's own tests run them. Tolerances:
  * K5: the sum of S <= 2 LUT entries is exact in float32 whichever order it
    is taken in, so the plain version equals adc_scores_xla and the v1 Pallas
    kernel exactly; with the LUT rounded to bf16 it equals the v2 Pallas
    kernel (bf16 LUT x one-hot, f32 sums) exactly too.
  * K3: against the float32 XLA chain, 1e-5 relative to each row's largest
    entry (summation order); against the Pallas kernel, which rounds p to
    bf16 before its indicator matmul, the JAX test's own rtol 0.05 / atol
    5e-4.
  * K6 and every top-k selection: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu.core import pq as jpq
from pqcache_tpu.ops.adc_pallas import (adc_block_scores_pallas,
                                        adc_block_scores_pallas_batched,
                                        adc_scores_pallas,
                                        adc_scores_pallas_v2, adc_scores_xla)
from pqcache_tpu.ops.gather_pallas import gather_rows as jgather_rows
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.ops.adc import (adc_block_scores, adc_block_scores_ref,
                                       adc_scores, adc_scores_ref)
from pqcache_tpu_torch.ops.gather import gather_rows, gather_rows_ref

torch.set_num_threads(1)


def _lut_codes(rng, lead, H_kv, g, S, C, T):
    lut = rng.normal(size=(*lead, H_kv, g, S, C)).astype(np.float32)
    codes = rng.integers(0, C, size=(*lead, H_kv, S, T)).astype(np.uint8)
    return lut, codes


# ---------------------------------------------------------------------------
# K5

@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("T,block_t", [(256, 128), (300, 128), (1024, 512)])
def test_adc_scores_matches_jax(T, block_t, S):
    rng = np.random.default_rng(T + S)
    lut, codes = _lut_codes(rng, (), 2, 4, S, 64, T)
    jl, jc = jnp.asarray(lut), jnp.asarray(codes.astype(np.int8))
    tl, tc = torch.from_numpy(lut), torch.from_numpy(codes)
    v1 = adc_scores_ref(tl, tc).numpy()
    np.testing.assert_array_equal(v1, np.asarray(adc_scores_xla(jl, jc)))
    np.testing.assert_array_equal(v1, np.asarray(adc_scores_pallas(
        jl, jc, block_t=block_t, interpret=True)))
    v2 = adc_scores_ref(tl, tc, round_lut_bf16=True).numpy()
    np.testing.assert_array_equal(v2, np.asarray(adc_scores_pallas_v2(
        jl, jc, block_t=block_t, interpret=True)))
    # the wrapper takes the plain version on the CPU
    np.testing.assert_array_equal(adc_scores(tl, tc).numpy(), v1)
    np.testing.assert_array_equal(
        adc_scores(tl, tc, round_lut_bf16=True).numpy(), v2)


def test_adc_scores_uint8_codes_c256_and_leading_dims():
    # uint8 codes up to 255 (JAX's kernel tests stay below 64 in int8), and
    # leading dims folded into the kv-head axis (the batched layout)
    rng = np.random.default_rng(5)
    lut, codes = _lut_codes(rng, (3,), 2, 2, 2, 256, 200)
    assert codes.max() > 127
    got = adc_scores_ref(torch.from_numpy(lut), torch.from_numpy(codes))
    want = np.stack([np.asarray(adc_scores_xla(
        jnp.asarray(lut[b]), jnp.asarray(codes[b].astype(np.int32))))
        for b in range(3)])
    np.testing.assert_array_equal(got.numpy(), want)
    # the policy's [H, T] view is adc_gather_scores of the [H, S, C] LUT
    H = 4
    flat = pq.adc_gather_scores(torch.from_numpy(lut[0]).reshape(H, 2, 256),
                                torch.from_numpy(codes[0]))
    np.testing.assert_array_equal(flat.numpy(), want[0].reshape(H, -1))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(
        jpq.adc_gather_scores(jnp.asarray(lut[0].reshape(H, 2, 256)),
                              jnp.asarray(codes[0].astype(np.int32)))))


# ---------------------------------------------------------------------------
# K3

def _block_mass_xla(lut, codes, n_cand, sel_block, head_dim):
    """tests/test_adc_pallas.py's float32 chain: ADC -> masked softmax ->
    per-block sums."""
    H_kv, g, S, C = lut.shape
    T = codes.shape[-1]
    scores = adc_scores_xla(lut, codes).reshape(H_kv * g, T)
    tok = jnp.arange(T, dtype=jnp.int32)[None, :]
    masked = jnp.where(tok < n_cand, scores / jnp.sqrt(float(head_dim)),
                       -jnp.inf)
    probs = jax.nn.softmax(masked, axis=-1)
    probs = jnp.where(tok < n_cand, probs, 0.0)
    return jnp.sum(probs.reshape(H_kv * g, T // sel_block, sel_block),
                   axis=-1)


def _assert_rows_close(got, want, rel=1e-5):
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1e-30)
    assert (np.abs(got - want) / scale).max() <= rel


@pytest.mark.parametrize("T,n_cand,sel_block", [(2048, 2048, 128),
                                                (2048, 1500, 128),
                                                (4096, 3000, 256),
                                                (2048, 100, 128),
                                                (2048, 0, 128)])
def test_adc_block_scores_matches_jax(T, n_cand, sel_block):
    rng = np.random.default_rng(11)
    H_kv, g, S, C, D = 2, 4, 2, 64, 128
    lut, codes = _lut_codes(rng, (), H_kv, g, S, C, T)
    jl, jc = jnp.asarray(lut), jnp.asarray(codes.astype(np.int8))
    got = adc_block_scores_ref(torch.from_numpy(lut), torch.from_numpy(codes),
                               n_cand, sel_block=sel_block,
                               head_dim=D).numpy()
    ref = np.nan_to_num(np.asarray(_block_mass_xla(jl, jc, n_cand, sel_block,
                                                   D)))
    _assert_rows_close(got, ref)
    pal = np.asarray(adc_block_scores_pallas(
        jl, jc, jnp.asarray(n_cand), sel_block=sel_block, head_dim=D,
        interpret=True))
    np.testing.assert_allclose(got, pal, rtol=0.05, atol=5e-4)
    if n_cand == 0:
        assert (got == 0).all()
    else:
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(adc_block_scores(
        torch.from_numpy(lut), torch.from_numpy(codes), n_cand,
        sel_block=sel_block, head_dim=D).numpy(), got)


def test_adc_block_scores_batched_per_slot_counts():
    rng = np.random.default_rng(12)
    B, H_kv, g, S, C, T, D = 3, 2, 2, 2, 64, 2048, 128
    lut, codes = _lut_codes(rng, (B,), H_kv, g, S, C, T)
    n_cand = np.asarray([2048, 700, 0], np.int32)
    got = adc_block_scores(torch.from_numpy(lut), torch.from_numpy(codes),
                           torch.from_numpy(n_cand), sel_block=128,
                           head_dim=D).numpy()
    pal = np.asarray(adc_block_scores_pallas_batched(
        jnp.asarray(lut), jnp.asarray(codes.astype(np.int8)),
        jnp.asarray(n_cand), sel_block=128, head_dim=D, interpret=True))
    np.testing.assert_allclose(got, pal, rtol=0.05, atol=5e-4)
    for b in range(B):
        ref = np.nan_to_num(np.asarray(_block_mass_xla(
            jnp.asarray(lut[b]), jnp.asarray(codes[b].astype(np.int32)),
            int(n_cand[b]), 128, D)))
        _assert_rows_close(got[b], ref)
    assert (got[2] == 0).all()


# ---------------------------------------------------------------------------
# K6

@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_gather_rows_matches_jax(dtype):
    rng = np.random.default_rng(2)
    LH, T, D2, H, K = 6, 256, 128, 2, 40   # 3 layers x 2 heads stacked
    x = rng.normal(size=(LH, T, D2)).astype(np.float32)
    if dtype == "int8":
        x = rng.integers(-127, 128, size=(LH, T, D2)).astype(np.int8)
    idx = rng.integers(0, T, size=(H, K)).astype(np.int32)
    jsrc = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else None)
    want = np.asarray(jgather_rows(jsrc, jnp.asarray(idx),
                                   jnp.asarray(4, jnp.int32),
                                   rows_per_block=8, interpret=True))
    src = torch.from_numpy(x)
    if dtype == "bf16":
        src = src.bfloat16()
    for fn in (gather_rows_ref, gather_rows):
        got = fn(src, torch.from_numpy(idx).long(), 4)
        assert got.dtype == src.dtype and got.shape == (H, K, D2)
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))


def test_gather_rows_clamps_and_checks_offsets():
    src = torch.arange(2 * 8 * 4).reshape(2, 8, 4)
    idx = torch.tensor([[-3, 0, 7, 8, 100]])
    got = gather_rows(src, idx, 1)
    assert torch.equal(got, src[1, [0, 0, 7, 7, 7]][None])
    with pytest.raises(ValueError):
        gather_rows(src, torch.zeros((2, 3), dtype=torch.long), 1)


# ---------------------------------------------------------------------------
# GQA selection on inputs full of ties

def _tied_scores(rng, H, T, n_distinct=4):
    """Per-token scores with only a few distinct values per head, as a kv
    head's ADC scores have (at most C^S distinct values)."""
    vals = rng.normal(size=(H, n_distinct)).astype(np.float32) * 3
    return np.take_along_axis(vals, rng.integers(0, n_distinct, (H, T)), 1)


@pytest.mark.parametrize("n_valid", [300, 17, [300, 250], [5, 0]])
def test_mips_topk_and_group_scores_match_jax_on_ties(n_valid):
    rng = np.random.default_rng(7)
    g, T, D, k = 2, 320, 64, 40
    scores = _tied_scores(rng, 4, T)
    nv = np.asarray(n_valid, np.int32)
    tn = torch.from_numpy(nv) if nv.ndim else int(nv)
    idx, gm = pq.mips_topk(torch.from_numpy(scores), tn, k, group=g,
                           head_dim=D)
    jidx, jgm = jpq.mips_topk(jnp.asarray(scores), jnp.asarray(nv), k,
                              group=g, head_dim=D, approx=False)
    # the same indices in the same order: ties go to the lower index, also
    # among the -inf entries past n_valid
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gm.numpy(), np.nan_to_num(np.asarray(jgm)),
                               rtol=1e-5, atol=1e-7)
    gs = pq.group_scores(torch.from_numpy(scores), tn, group=g, head_dim=D)
    jgs = np.asarray(jpq.group_scores(jnp.asarray(scores), jnp.asarray(nv),
                                      group=g, head_dim=D))
    assert np.array_equal(np.isinf(gs.numpy()), np.isinf(jgs))
    fin = np.isfinite(jgs)
    np.testing.assert_allclose(gs.numpy()[fin], jgs[fin], rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("n_valid", [320, 100, [320, 33]])
def test_mips_topk_blocks_and_block_mass_match_jax_on_ties(n_valid):
    rng = np.random.default_rng(8)
    g, T, D, block, k_tokens = 2, 320, 64, 16, 120
    scores = _tied_scores(rng, 4, T, n_distinct=1)    # every block ties
    nv = np.asarray(n_valid, np.int32)
    tn = torch.from_numpy(nv) if nv.ndim else int(nv)
    idx, _ = pq.mips_topk_blocks(torch.from_numpy(scores), tn, k_tokens,
                                 group=g, head_dim=D, block=block)
    jidx, _ = jpq.mips_topk_blocks(jnp.asarray(scores), jnp.asarray(nv),
                                   k_tokens, group=g, head_dim=D, block=block,
                                   approx=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    mass = np.zeros((4, T // block), np.float32)
    mass[:, 3] = 1.0                                   # one block, then ties
    sel = pq.topk_from_block_mass(torch.from_numpy(mass), tn, k_tokens,
                                  group=g, block=block)
    jsel = jpq.topk_from_block_mass(jnp.asarray(mass), jnp.asarray(nv),
                                    k_tokens, group=g, block=block,
                                    approx=False)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
