"""The PyTorch port's attention ops and quantization against the JAX package.

Inputs come from a numpy seed and go through the JAX function (its XLA twin,
or a Pallas kernel in interpret mode) and through the port on the CPU, where
every kernel wrapper computes its plain PyTorch version. Tolerances: both
sides compute in float32 from the same inputs, so they differ only by
summation order (~1e-5 relative); int8 quantization is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu.core import quant as jquant
from pqcache_tpu.ops import attention_xla as jattn
from pqcache_tpu.ops.block_attn_pallas import block_topk_attention_xla
from pqcache_tpu.ops.flash_attention import flash_attention as jflash
from pqcache_tpu_torch.core import quant
from pqcache_tpu_torch.ops import attention_ref
from pqcache_tpu_torch.ops.block_attn import block_topk_attention
from pqcache_tpu_torch.ops.dispatch import dense_prefill_attention
from pqcache_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=0.5):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("T,pad,block", [(200, 0, 64), (300, 77, 128),
                                         (256, 130, 64)])
def test_chunked_attention_matches_jax(T, pad, block):
    rng = np.random.default_rng(T + pad)
    H, H_kv, D = 4, 2, 32
    q, k, v = _rand(rng, H, T, D), _rand(rng, H_kv, T, D), _rand(
        rng, H_kv, T, D)
    ref, _ = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), valid_lo=pad,
                                     block=block)
    out = attention_ref.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        valid_lo=pad, block=block)
    # rows before the pad see no key: the port writes 0 there (as the TPU
    # kernel does), the XLA twin the mean of V — compare the real rows
    np.testing.assert_allclose(out[:, pad:].numpy(),
                               np.asarray(ref)[:, pad:], **F32_TOL)
    assert torch.all(out[:, :pad] == 0)
    # the wrapper and the dispatcher take the plain version on the CPU
    for got in (flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), valid_lo=pad),
                dense_prefill_attention(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), pad)[0]):
        np.testing.assert_allclose(got[:, pad:].numpy(),
                                   np.asarray(ref)[:, pad:], **F32_TOL)


def test_plain_k2_matches_pallas_interpret():
    # the Pallas kernel writes 0 for rows that see no key, like the port:
    # every row compares; 2e-4 is the JAX tests' kernel-vs-oracle tolerance
    rng = np.random.default_rng(11)
    H, H_kv, D, T, pad = 4, 2, 128, 256, 60
    q, k, v = _rand(rng, H, T, D), _rand(rng, H_kv, T, D), _rand(
        rng, H_kv, T, D)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 valid_lo=pad, block_q=128, block_k=128, interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), valid_lo=pad)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_chunked_attention_valid_len_and_rect():
    # valid_len and a q chunk at q_offset against its key prefix, against
    # the XLA twins (chunked_attention_rect carries q_offset)
    rng = np.random.default_rng(5)
    H, H_kv, D, Tk, Tq, off, pad = 4, 2, 16, 320, 96, 200, 30
    q, k, v = _rand(rng, H, Tq, D), _rand(rng, H_kv, Tk, D), _rand(
        rng, H_kv, Tk, D)
    ref = jattn.chunked_attention_rect(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), valid_lo=pad,
                                       q_offset=off, block=64)
    out = attention_ref.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        valid_lo=pad, q_offset=off, block=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    T, n = 256, 180
    q, k, v = _rand(rng, H, T, D), _rand(rng, H_kv, T, D), _rand(
        rng, H_kv, T, D)
    ref, _ = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), valid_len=n, block=64)
    out = attention_ref.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        valid_len=n, block=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("T,Tk,pad,D,H,H_kv,q_offset,valid_len", [
    (200, 200, 0, 16, 4, 2, 0, None), (300, 300, 60, 128, 4, 1, 0, None),
    (96, 296, 5, 16, 8, 2, 200, None), (256, 256, 60, 16, 4, 4, 0, 180)])
def test_chunked_attention_row_stats_match_dense_lse(T, Tk, pad, D, H, H_kv,
                                                     q_offset, valid_len):
    # K2's row statistics from the plain version: m the row max of the
    # scaled logit, l = sum exp(logit - m) over the row's valid keys, both
    # from one dense masked pass in float64; rows that see no key, or whose
    # position lies outside [pad, valid_len), are (-1e30, 0)
    rng = np.random.default_rng(T + pad + D)
    q, k, v = _rand(rng, H, T, D), _rand(rng, H_kv, Tk, D), _rand(
        rng, H_kv, Tk, D)
    hi = Tk if valid_len is None else valid_len
    g = H // H_kv
    lg = np.einsum("hgqd,hkd->hgqk", q.reshape(H_kv, g, T, D).astype(
        np.float64), k.astype(np.float64)) / np.sqrt(D)
    qpos = q_offset + np.arange(T)[:, None]
    kpos = np.arange(Tk)[None, :]
    mask = (kpos >= pad) & (kpos < hi) & (kpos <= qpos)
    seen = mask.any(-1) & (qpos[:, 0] >= pad) & (qpos[:, 0] < hi)
    m_ref = np.where(seen, np.where(mask, lg, -np.inf).max(-1), -1e30)
    m_safe = np.where(seen, m_ref, 0.0)[..., None]
    l_ref = np.where(seen, (np.exp(lg - m_safe) * mask).sum(-1), 0)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    kw = dict(valid_lo=pad, valid_len=valid_len, q_offset=q_offset)
    out, m, l = attention_ref.chunked_attention(*args, block=64,
                                                return_stats=True, **kw)
    np.testing.assert_allclose(m.numpy(), m_ref.reshape(H, T), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(l.numpy(), l_ref.reshape(H, T), rtol=1e-5)
    assert torch.equal(out, attention_ref.chunked_attention(*args, block=64,
                                                            **kw))
    # the wrapper takes the plain version on the CPU, stats included
    got = flash_attention(*args, return_stats=True, **kw)
    for a, b in zip(got, attention_ref.chunked_attention(
            *args, return_stats=True, **kw)):
        assert torch.equal(a, b)


def _tail(rng, kv_int8, *shape):
    if kv_int8:
        return rng.integers(-127, 128, size=shape).astype(np.int8)
    return _rand(rng, *shape, scale=0.4)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bs,nb_sel,n_cand", [(128, 3, 512), (128, 4, 300),
                                              (256, 2, 512), (128, 5, 700),
                                              (128, 7, 1024)])
def test_block_topk_attention_matches_jax(bs, nb_sel, n_cand, kv_int8):
    # the grid of tests/test_block_attn.py::test_kernel_matches_xla_reference
    rng = np.random.default_rng(0)
    L, H_kv, group, N, D = 2, 2, 4, 1024, 128
    H = H_kv * group
    kv_tail = _tail(rng, kv_int8, L, H_kv, N, 2 * D)
    if not kv_int8:   # a bf16 tail: round through bf16 on the JAX side
        kv_tail = np.asarray(jnp.asarray(kv_tail).astype(jnp.bfloat16)
                             .astype(jnp.float32))
    q = _rand(rng, H, 1, D, scale=0.4 if not kv_int8 else 0.004)
    blk_idx = np.stack([rng.choice(N // bs, nb_sel, replace=False)
                        for _ in range(H_kv)]).astype(np.int32)
    mr, lr, accr = block_topk_attention_xla(
        jnp.asarray(q), jnp.asarray(kv_tail), jnp.asarray(1),
        jnp.asarray(blk_idx), jnp.asarray(n_cand), block=bs)
    kv_t = torch.from_numpy(np.array(kv_tail))
    if not kv_int8:
        kv_t = kv_t.to(torch.bfloat16)    # exact: values are bf16
    m, l, acc = block_topk_attention(torch.from_numpy(q), kv_t, 1,
                                     torch.from_numpy(blk_idx), n_cand,
                                     block=bs)
    # acc sums raw int8 V rows (values to 127): the absolute tolerance
    # scales with the largest entry
    for got, ref in ((m, mr), (l, lr), (acc, accr)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_block_topk_attention_per_head_counts_and_later_options():
    rng = np.random.default_rng(2)
    L, H_kv, group, N, D, bs = 1, 2, 2, 512, 64, 128
    kv = _rand(rng, L, H_kv, N, 2 * D)
    q = _rand(rng, H_kv * group, 1, D)
    blk = np.asarray([[0, 3], [1, 2]], np.int32)
    n_c = np.asarray([200, 300], np.int32)
    mr, lr, accr = block_topk_attention_xla(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(0), jnp.asarray(blk),
        jnp.asarray(n_c), block=bs)
    m, l, acc = block_topk_attention(
        torch.from_numpy(q), torch.from_numpy(kv), 0, torch.from_numpy(blk),
        torch.from_numpy(n_c), block=bs)
    for got, ref in ((m, mr), (l, lr), (acc, accr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    # head 0's block 3 (rows 384..511) is past n_cand=200: all masked there.
    # The options the batched path passes: a window of per-head length
    # (from a tensor, as the batched decode holds it) and the pair fetch
    wl = np.asarray([4, 8], np.int32)
    mr, lr, accr = block_topk_attention_xla(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(0), jnp.asarray(blk),
        jnp.asarray(300), block=bs, win_len=jnp.asarray(wl), win_max=8)
    for pair in (False, True):
        got = block_topk_attention(
            torch.from_numpy(q), torch.from_numpy(kv), 0,
            torch.from_numpy(blk), torch.tensor(300), block=bs, pair=pair,
            win_len=torch.from_numpy(wl), win_max=8)
        for g, ref in zip(got, (mr, lr, accr)):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref), **F32_TOL)
    with pytest.raises(ValueError, match="pair"):    # N % (2 * block) != 0
        block_topk_attention(torch.from_numpy(q),
                             torch.from_numpy(kv[:, :, :384]), 0,
                             torch.from_numpy(blk[:, :1]), 300, block=bs,
                             pair=True)


def _window_inputs(seed, L, H_kv, group, N, D):
    rng = np.random.default_rng(seed)
    kv = np.array(jnp.asarray(_rand(rng, L, H_kv, N, 2 * D, scale=1.0))
                  .astype(jnp.bfloat16).astype(jnp.float32))
    q = _rand(rng, H_kv * group, 1, D, scale=1.0)
    return rng, kv, q


def _k1(q, kv, layer, blk, nc, bs, **kw):
    """The port's K1 on the CPU (its plain version); numpy arrays among the
    inputs become tensors."""
    def t(x):
        return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) \
            else x
    return block_topk_attention(t(q), t(kv), layer, t(blk), t(nc), block=bs,
                                **{k: t(v) for k, v in kw.items()})


def _assert_partials(got, ref, tol=F32_TOL):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("pair,n_par,win_len", [(False, 4, 200),
                                                (False, 2, 0),
                                                (True, 4, 257),
                                                (False, 16, 384)])
def test_block_topk_window_matches_jax(pair, n_par, win_len):
    # the grid of tests/test_block_attn.py::test_window_coverage_matches_
    # xla_reference: win_len 0, an unaligned span crossing block
    # boundaries, block-unaligned per-head counts; against the XLA twin and
    # the Pallas kernel in interpret mode
    from pqcache_tpu.ops.block_attn_pallas import (
        block_topk_attention as jpallas)
    L, H_kv, group, N, D, bs, win_max = 2, 2, 4, 1024, 128, 128, 384
    rng, kv, q = _window_inputs(7, L, H_kv, group, N, D)
    blk = np.stack([rng.choice(N // bs, 3, replace=False)
                    for _ in range(H_kv)]).astype(np.int32)
    nc = np.asarray([300, 517], np.int32)
    args = (jnp.asarray(q), jnp.asarray(kv).astype(jnp.bfloat16),
            jnp.asarray(1), jnp.asarray(blk), jnp.asarray(nc))
    wl = jnp.asarray(win_len, jnp.int32)
    ref = block_topk_attention_xla(*args, block=bs, win_len=wl,
                                   win_max=win_max)
    pal = jpallas(*args, block=bs, n_par=n_par, pair=pair, win_len=wl,
                  win_max=win_max, interpret=True)
    got = _k1(q, kv, 1, blk, nc, bs, pair=pair, n_par=n_par,
              win_len=torch.tensor(win_len), win_max=win_max)
    _assert_partials(got, ref)
    _assert_partials(got, pal, dict(rtol=1e-4, atol=1e-4))


def test_block_topk_window_equals_separate_segment():
    # tests/test_block_attn.py::test_window_coverage_equals_separate_window_
    # segment: the window attended in K1's pass equals the blocks' partials
    # merged with an explicit local-window segment
    L, H_kv, group, N, D, bs, win = 1, 2, 2, 1024, 128, 128, 300
    _, kv, q = _window_inputs(8, L, H_kv, group, N, D)
    blk = np.asarray([[0, 1], [2, 0]], np.int32)
    nc = np.asarray([290, 401], np.int32)
    part = _k1(q, kv, 0, blk, nc, bs, win_len=win, win_max=win)
    out = attention_ref.decode_window_attention_segments(
        torch.from_numpy(q), [], partials=[part])
    sel = _k1(q, kv, 0, blk, nc, bs)
    qg = torch.from_numpy(q).reshape(H_kv, group, D)
    kvt = torch.from_numpy(kv)
    loc = [attention_ref.segment_partial(
        qg[h:h + 1], kvt[0, h:h + 1, nc[h]:nc[h] + win, :D],
        kvt[0, h:h + 1, nc[h]:nc[h] + win, D:]) for h in range(H_kv)]
    loc = tuple(torch.cat([p[i] for p in loc]) for i in range(3))
    ref = attention_ref.decode_window_attention_segments(
        torch.from_numpy(q), [], partials=[sel, loc])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)


def test_block_topk_window_at_tail_counts_no_row_twice():
    # tests/test_block_attn.py::test_window_at_tail_no_duplicate_block: a
    # window that ends on the tail's last row (head 0: 411 + 100 < 512, its
    # second aligned entry clamps onto the last block; head 1: 384 + 128 =
    # 512, aligned) equals the blocks plus an explicit window segment, on
    # the port and on JAX's XLA twin
    L, H_kv, group, N, D, bs, win_max = 1, 2, 2, 512, 128, 128, 128
    _, kv, q = _window_inputs(9, L, H_kv, group, N, D)
    blk = np.asarray([[0, 1], [1, 0]], np.int32)
    nc = np.asarray([411, 384], np.int32)
    wl = np.asarray([100, 128], np.int32)
    sel = _k1(q, kv, 0, blk, nc, bs)
    qg = torch.from_numpy(q).reshape(H_kv, group, D)
    kvt = torch.from_numpy(kv)
    loc = [attention_ref.segment_partial(
        qg[h:h + 1], kvt[0, h:h + 1, nc[h]:nc[h] + wl[h], :D],
        kvt[0, h:h + 1, nc[h]:nc[h] + wl[h], D:]) for h in range(H_kv)]
    loc = tuple(torch.cat([p[i] for p in loc]) for i in range(3))
    ref = attention_ref.decode_window_attention_segments(
        torch.from_numpy(q), [], partials=[sel, loc])
    jref = block_topk_attention_xla(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(0), jnp.asarray(blk),
        jnp.asarray(nc), block=bs, win_len=jnp.asarray(wl), win_max=win_max)
    got = _k1(q, kv, 0, blk, nc, bs, win_len=wl, win_max=win_max)
    _assert_partials(got, jref)
    out = attention_ref.decode_window_attention_segments(
        torch.from_numpy(q), [], partials=[got])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)


@pytest.mark.parametrize("nb_sel,n_cand,n_par", [(3, 512, 1), (5, 700, 2),
                                                 (7, 1024, 4), (4, 300, 16)])
def test_block_topk_pair_fetch_matches_jax(nb_sel, n_cand, n_par):
    # tests/test_block_attn.py::test_pair_fetch_matches_xla_reference: the
    # pair fetch gives the partials of the per-block fetch
    from pqcache_tpu.ops.block_attn_pallas import (
        block_topk_attention as jpallas)
    L, H_kv, group, N, D, bs = 2, 2, 4, 1024, 128, 128
    rng, kv, q = _window_inputs(2, L, H_kv, group, N, D)
    blk = np.sort(np.stack([rng.choice(N // bs, nb_sel, replace=False)
                            for _ in range(H_kv)]), -1).astype(np.int32)
    args = (jnp.asarray(q), jnp.asarray(kv).astype(jnp.bfloat16),
            jnp.asarray(1), jnp.asarray(blk), jnp.asarray(n_cand))
    ref = block_topk_attention_xla(*args, block=bs)
    pal = jpallas(*args, block=bs, n_par=n_par, pair=True, interpret=True)
    got = _k1(q, kv, 1, blk, n_cand, bs, pair=True, n_par=n_par)
    _assert_partials(got, ref)
    _assert_partials(got, pal, dict(rtol=1e-4, atol=1e-4))
    _assert_partials(got, _k1(q, kv, 1, blk, n_cand, bs))


def test_decode_segments_with_partials_matches_jax():
    rng = np.random.default_rng(3)
    L, H_kv, group, N, D, bs = 1, 2, 4, 512, 64, 128
    H = H_kv * group
    kv = _rand(rng, L, H_kv, N, 2 * D)
    q = _rand(rng, H, 1, D)
    blk = np.asarray([[0, 2], [1, 3]], np.int32)
    segs_np = [(_rand(rng, H_kv, 4, D), _rand(rng, H_kv, 4, D), None),
               (_rand(rng, H_kv, 7, D), _rand(rng, H_kv, 7, D),
                rng.random((H_kv, 7)) > 0.3),
               (_rand(rng, H_kv, 1, D), _rand(rng, H_kv, 1, D), None)]
    # one partial over real blocks, one fully masked (m = NEG_INF, l = 0)
    jpart = [block_topk_attention_xla(jnp.asarray(q), jnp.asarray(kv),
                                      jnp.asarray(0), jnp.asarray(blk),
                                      jnp.asarray(n), block=bs)
             for n in (400, 0)]
    ref = jattn.decode_window_attention_segments(
        jnp.asarray(q),
        [(jnp.asarray(k), jnp.asarray(v),
          None if m is None else jnp.asarray(m)) for k, v, m in segs_np],
        partials=jpart)
    tpart = [tuple(torch.from_numpy(np.asarray(x)) for x in p)
             for p in jpart]
    out = attention_ref.decode_window_attention_segments(
        torch.from_numpy(q),
        [(torch.from_numpy(k), torch.from_numpy(v),
          None if m is None else torch.from_numpy(m))
         for k, v, m in segs_np],
        partials=tpart)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    # segment_partial merged as a partial equals the segment itself
    qg = torch.from_numpy(q).reshape(H_kv, group, D)
    k1, v1, m1 = (torch.from_numpy(x) for x in segs_np[1])
    sp = attention_ref.segment_partial(qg, k1, v1, m1)
    jsp = jattn.segment_partial(jnp.asarray(q).reshape(H_kv, group, D),
                                jnp.asarray(segs_np[1][0]),
                                jnp.asarray(segs_np[1][1]),
                                jnp.asarray(segs_np[1][2]))
    for got, r in zip(sp, jsp):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), **F32_TOL)


def test_quant_kv_round_trip_matches_jax():
    rng = np.random.default_rng(4)
    H_kv, T, D, valid = 2, 40, 16, 33
    k = _rand(rng, H_kv, T, D, scale=2.0)
    v = _rand(rng, H_kv, T, D, scale=0.3)
    k[:, valid:] = 100.0             # garbage past valid_len must not count
    jks, jvs = jquant.kv_channel_scales(jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(valid))
    ks, vs = quant.kv_channel_scales(torch.from_numpy(k), torch.from_numpy(v),
                                     valid)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(jvs))
    jq = jquant.quantize_kv(jnp.asarray(k), jnp.asarray(v), jks, jvs)
    tq = quant.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), ks, vs)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    dk, dv = quant.dequant_kv(tq, ks, vs, dtype=torch.float32)
    jdk, jdv = jquant.dequant_kv(jq, jks, jvs, dtype=jnp.float32)
    np.testing.assert_array_equal(dk.numpy(), np.asarray(jdk))
    np.testing.assert_array_equal(dv.numpy(), np.asarray(jdv))
    # round trip within half a quantization step on the valid tokens
    assert np.all(np.abs(dk.numpy()[:, :valid] - k[:, :valid])
                  <= ks.numpy() / 2 + 1e-6)
    assert np.all(np.abs(dv.numpy()[:, :valid] - v[:, :valid])
                  <= vs.numpy() / 2 + 1e-6)
