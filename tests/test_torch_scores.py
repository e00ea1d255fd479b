"""The port's score-emitting attention (K4's plain version and wrapper) and
the materialized-softmax attention ops against the JAX package.

Inputs come from a numpy seed. ``flash_scores_ref`` and the ``flash_scores``
wrapper (which computes it for CPU tensors) are held against JAX's
``chunked_attention(with_scores=True)`` and the Pallas ``flash_scores`` in
interpret mode, at the JAX tests' own tolerance (rtol 1e-3, atol 1e-4,
``tests/test_flash_attention.py``); both sides compute in float32, so the
measured differences are ~1e-6. The dense ops compare at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu.ops import attention_xla as jattn
from pqcache_tpu.ops import dispatch as jdispatch
from pqcache_tpu.ops.flash_attention import flash_scores as jflash_scores
from pqcache_tpu_torch.ops import attention_ref
from pqcache_tpu_torch.ops.dispatch import dense_prefill_attention
from pqcache_tpu_torch.ops.flash_scores import flash_scores

torch.set_num_threads(1)
SCORE_TOL = dict(rtol=1e-3, atol=1e-4)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=0.5):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("T,pad,D", [(256, 0, 128), (256, 60, 128),
                                     (200, 60, 16), (200, 0, 16)])
def test_flash_scores_match_jax(mode, T, pad, D):
    rng = np.random.default_rng(T + pad + D)
    H, H_kv = 4, 2                                  # GQA group 2
    q, k = _rand(rng, H, T, D), _rand(rng, H_kv, T, D)
    v = _rand(rng, H_kv, T, D)
    _, ref = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), valid_lo=pad, block=64,
                                     with_scores=True, score_mode=mode)
    ref = np.asarray(ref)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    # the plain version at two block sizes, the wrapper (CPU: the plain
    # version) and the dispatcher on both routes
    outs = [attention_ref.flash_scores_ref(tq, tk, pad, score_mode=mode),
            attention_ref.flash_scores_ref(tq, tk, pad, score_mode=mode,
                                           block=64),
            flash_scores(tq, tk, valid_lo=pad, score_mode=mode)]
    for use_kernel in (True, False):
        outs.append(dense_prefill_attention(
            tq, tk, torch.from_numpy(v), pad, with_scores=True,
            score_mode=mode, use_kernel=use_kernel)[1])
    for got in outs:
        assert got.shape == (H, T) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, **SCORE_TOL)
        assert torch.all(got[:, :pad] == 0)
    if mode == "max":
        # the first recent_cnt valid rows see only recent keys: the last
        # 32 valid columns get nothing
        assert torch.all(outs[0][:, T - 32:] == 0)
    if D == 128:
        # the Pallas kernel as the JAX tests call it (interpret mode)
        pal = jflash_scores(jnp.asarray(q), jnp.asarray(k), valid_lo=pad,
                            block_q=128, block_k=128, score_mode=mode,
                            interpret=True)
        np.testing.assert_allclose(outs[2].numpy(), np.asarray(pal),
                                   **SCORE_TOL)


@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("T,pad,D", [(256, 60, 128), (200, 0, 16),
                                     (300, 17, 16)])
def test_flash_scores_row_stats_match_jax(mode, T, pad, D):
    # K4 fed with K2's row statistics (the plain versions' hand-off) against
    # JAX's chunked_attention(with_scores=True) and, at D 128, the Pallas
    # flash_scores in interpret mode, at the tolerance of the test above
    rng = np.random.default_rng(T + pad + D + 1)
    H, H_kv = 4, 2
    q, k, v = _rand(rng, H, T, D), _rand(rng, H_kv, T, D), _rand(
        rng, H_kv, T, D)
    _, ref = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), valid_lo=pad, block=64,
                                     with_scores=True, score_mode=mode)
    ref = np.asarray(ref)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _, m, l = attention_ref.chunked_attention(tq, tk, tv, valid_lo=pad,
                                              block=64, return_stats=True)
    outs = [attention_ref.flash_scores_ref(tq, tk, pad, score_mode=mode,
                                           row_stats=(m, l)),
            attention_ref.flash_scores_ref(tq, tk, pad, score_mode=mode,
                                           block=64, row_stats=(m, l)),
            flash_scores(tq, tk, valid_lo=pad, score_mode=mode,
                         row_stats=(m, l))]
    own = attention_ref.flash_scores_ref(tq, tk, pad, score_mode=mode)
    for got in outs:
        assert got.shape == (H, T) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, **SCORE_TOL)
        np.testing.assert_allclose(got.numpy(), own.numpy(), rtol=1e-5,
                                   atol=1e-7)
        assert torch.all(got[:, :pad] == 0)
    if D == 128:
        pal = jflash_scores(jnp.asarray(q), jnp.asarray(k), valid_lo=pad,
                            block_q=128, block_k=128, score_mode=mode,
                            interpret=True)
        np.testing.assert_allclose(outs[2].numpy(), np.asarray(pal),
                                   **SCORE_TOL)


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_dense_prefill_with_scores_matches_jax(mode):
    # the dispatcher on the CPU (K2's plain version with its row statistics,
    # then K4's column pass) against JAX's dispatcher on its XLA route:
    # attention on the real rows, scores everywhere
    rng = np.random.default_rng(7)
    H, H_kv, D, T, pad = 8, 2, 16, 320, 45
    q, k, v = _rand(rng, H, T, D), _rand(rng, H_kv, T, D), _rand(
        rng, H_kv, T, D)
    ref_out, ref_f = jdispatch.dense_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pad,
        with_scores=True, score_mode=mode, use_pallas=False)
    for use_kernel in (True, False):
        out, f = dense_prefill_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            pad, with_scores=True, score_mode=mode, use_kernel=use_kernel)
        np.testing.assert_allclose(out[:, pad:].numpy(),
                                   np.asarray(ref_out)[:, pad:], **F32_TOL)
        assert torch.all(out[:, :pad] == 0)
        np.testing.assert_allclose(f.numpy(), np.asarray(ref_f), **SCORE_TOL)


@pytest.mark.parametrize("bad", ["short", "single", "three"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_row_stats_of_wrong_shape_raise(bad, device):
    # checked before the device branch: the same ValueError on CPU tensors
    # and on tensors of a device the kernels never see
    H, H_kv, D, T = 4, 2, 16, 40
    q = torch.zeros((H, T, D), device=device)
    k = torch.zeros((H_kv, T, D), device=device)
    good = torch.zeros((H, T), device=device)
    row_stats = {"short": (good, torch.zeros((H, T - 1), device=device)),
                 "single": good, "three": (good, good, good)}[bad]
    for fn in (flash_scores, attention_ref.flash_scores_ref):
        with pytest.raises(ValueError, match="row_stats"):
            fn(q, k, 0, row_stats=row_stats)


def test_flash_scores_valid_len_and_modes():
    # rows and keys at or past valid_len take no part; an unknown mode
    # raises on both routes
    rng = np.random.default_rng(1)
    H, H_kv, D, T, pad, n = 4, 1, 16, 300, 17, 250
    q, k = _rand(rng, H, T, D), _rand(rng, H_kv, T, D)
    for mode in ("sum", "max"):
        got = attention_ref.flash_scores_ref(
            torch.from_numpy(q), torch.from_numpy(k), pad, n,
            score_mode=mode, block=128)
        _, ref = jattn.chunked_attention(
            jnp.asarray(q[:, :n]), jnp.asarray(k[:, :n]),
            jnp.asarray(k[:, :n]), valid_lo=pad, block=64, with_scores=True,
            score_mode=mode)
        np.testing.assert_allclose(got[:, :n].numpy(), np.asarray(ref),
                                   **SCORE_TOL)
        assert torch.all(got[:, n:] == 0)
        if mode == "sum":
            # each valid row's probabilities sum to 1
            np.testing.assert_allclose(float(got.sum()), H * (n - pad),
                                       rtol=1e-5)
    with pytest.raises(ValueError):
        flash_scores(torch.from_numpy(q), torch.from_numpy(k),
                     score_mode="mean")


@pytest.mark.parametrize("q_offset,valid_len,valid_lo", [
    (0, None, None), (40, 90, 7)])
def test_dense_attention_matches_jax(q_offset, valid_len, valid_lo):
    rng = np.random.default_rng(2)
    H, H_kv, D, Tq, Tk = 4, 2, 16, 60, 100
    q, k, v = _rand(rng, H, Tq, D), _rand(rng, H_kv, Tk, D), _rand(
        rng, H_kv, Tk, D)
    ref = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                q_offset=q_offset, valid_len=valid_len,
                                valid_lo=valid_lo)
    out = attention_ref.dense_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, q_offset=q_offset, valid_len=valid_len,
        valid_lo=valid_lo)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_decode_window_attention_matches_jax(masked):
    rng = np.random.default_rng(3)
    H, H_kv, D, W = 8, 2, 16, 37
    q, k, v = _rand(rng, H, 1, D), _rand(rng, H_kv, W, D), _rand(
        rng, H_kv, W, D)
    mask = rng.random((H_kv, W)) > 0.3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref, ref_p = jattn.decode_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
        return_probs=True)
    out, probs = attention_ref.decode_window_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tm,
        return_probs=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_p), **F32_TOL)
    # each q head's probabilities sum to 1: the group sum to `group`
    np.testing.assert_allclose(probs.sum(-1).numpy(), H // H_kv, rtol=1e-5)
    alone = attention_ref.decode_window_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tm)
    assert torch.equal(alone, out)
