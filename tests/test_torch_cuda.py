"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped without a GPU (the kernels have no CPU mode;
the CPU tests hold the plain versions against the JAX package). Run on a
machine with an H100 and nvcc with
``python -m pytest tests/test_torch_cuda.py --noconftest`` (the repo conftest
needs jax, which that machine may not have).
Tolerances: K2 rounds P to bf16 before PV and writes bf16, so it is held at
bf16 resolution (2e-2) entry by entry and to 1e-2 in each row's norm; its
row statistics sum the same f32 logits in another order with base-2
exponentials (m to 1e-4 absolute, l to 1e-4 relative); K1
computes in float32 from the same inputs as its
plain version (1e-4). K5 sums the same float32 LUT entries in the plain
version's order for S <= 2 (exact) and in its own order above (1e-6
relative); K3 sums exp terms in another order than the plain softmax (1e-5
relative to each row's largest entry, and the same block selection); K1 and
K3 merge on chip in a fixed order, so two calls give bitwise the same
output, and each call is one CUDA kernel; K4
sums its bf16 tensor-core logits in another order and uses the fast exp
(1e-4 of each head's largest entry); K6 copies bytes (exact). The W8
kernel sums the same exact bf16 products as its plain version (int8 is exact
in bf16) in another f32 order, then rounds at the same points: a sum near a
bf16 rounding boundary may land one bf16 unit (2^-8 relative) apart, and
the scale's rounding another, so it is held at 2e-2 relative and 2e-2 of
the largest |entry| absolute; the CTA that owns a tile cut along K adds the
other CTAs' partials in CTA order, so two calls (eager or replayed) give
bitwise the same output. The joint-histogram scorer sums the same f32
products of exact counts as its plain version's f32 GEMM in another order
(1e-5 relative), adds the pending joins in order, and gives the same block
top-k but at near ties (1e-5 of the boundary's group mass); two calls give
bitwise the same output.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pqcache_tpu_torch import config
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.ops.adc import (adc_block_scores, adc_block_scores_ref,
                                       adc_scores, adc_scores_ref)
from pqcache_tpu_torch.ops.attention_ref import (chunked_attention,
                                                 flash_scores_ref)
from pqcache_tpu_torch.ops.block_attn import (block_topk_attention,
                                              block_topk_attention_ref)
from pqcache_tpu_torch.ops.flash_attention import flash_attention
from pqcache_tpu_torch.ops.flash_attention import row_stats as k2_row_stats
from pqcache_tpu_torch.ops.flash_scores import flash_scores
from pqcache_tpu_torch.ops.gather import gather_rows, gather_rows_ref
from pqcache_tpu_torch.ops.jhist import jhist_block_mass, jhist_block_mass_ref
from pqcache_tpu_torch.ops.w8 import (w8_matmul, w8_matmul_group,
                                      w8_matmul_group_ref, w8_matmul_ref)
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.generate import Engine

pytestmark = pytest.mark.cuda
K4_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_stats_close(got, ref):
    # (m, l) from the kernel against the plain version: the same logits in
    # another summation order and base-2 exponentials; rows that see no key
    # exactly (-1e30, 0)
    m, l = got
    m_ref, l_ref = ref
    assert m.shape == m_ref.shape and l.shape == l_ref.shape
    assert m.dtype == l.dtype == torch.float32
    none = l_ref == 0
    assert (m[none] == -1e30).all() and (l[none] == 0).all()
    torch.testing.assert_close(m[~none], m_ref[~none], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(l[~none], l_ref[~none], rtol=1e-4, atol=0)


@pytest.mark.parametrize("stats", [False, True], ids=["out", "stats"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T,pad,q_offset,causal,H,H_kv", [
    (300, 77, 0, True, 8, 2), (1024, 0, 0, True, 8, 2),
    (96, 5, 200, True, 8, 2), (257, 10, 0, False, 8, 2),
    (1, 0, 0, True, 8, 1), (63, 5, 0, True, 8, 1), (129, 77, 0, True, 16, 2),
    (2100, 77, 0, True, 8, 1), (300, 130, 40, True, 4, 4)])
def test_flash_attention_kernel_matches_plain(dev, D, T, pad, q_offset,
                                              causal, H, H_kv, stats):
    # T from 1 to past 2048, pads that are not multiples of 64, a q chunk at
    # q_offset, the rectangular (non-causal) grid, H_kv 1 and GQA group 8
    g = torch.Generator(device=dev).manual_seed(T + D)
    Tk = T + q_offset
    q = torch.randn((H, T, D), generator=g, device=dev).bfloat16()
    k = torch.randn((H_kv, Tk, D), generator=g, device=dev).bfloat16()
    v = torch.randn((H_kv, Tk, D), generator=g, device=dev).bfloat16()
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, valid_lo=pad, causal=causal,
                          q_offset=q_offset, return_stats=stats)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    ref = chunked_attention(q, k, v, valid_lo=pad, causal=causal,
                            q_offset=q_offset, return_stats=stats)
    if stats:
        _assert_stats_close(got[1:], ref[1:])
        got, ref = got[0], ref[0]
    out = got
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    # row by row too: a row that sees many keys has entries far below atol
    err = (out.float() - ref.float()).norm(dim=-1)
    nrm = ref.float().norm(dim=-1)
    assert (err[nrm == 0] == 0).all()      # rows that see no key give 0
    assert (err[nrm > 0] / nrm[nrm > 0]).max() <= 1e-2


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T,pad,valid_len,H,H_kv", [
    (1000, 60, None, 8, 4), (2100, 77, 1900, 8, 1), (63, 0, None, 2, 2)])
def test_row_stats_only_mode_matches_plain(dev, D, T, pad, valid_len, H,
                                           H_kv):
    # K2 without v: no P V, no output, only (m, l); rows outside
    # [pad, valid_len) are written as rows that see no key
    g = torch.Generator(device=dev).manual_seed(T + 3)
    q = torch.randn((H, T, D), generator=g, device=dev).bfloat16()
    k = torch.randn((H_kv, T, D), generator=g, device=dev).bfloat16()
    hi = T if valid_len is None else valid_len
    n0 = flash_attention.launches
    got = k2_row_stats(q, k, pad, hi)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0    # not a flash_attention launch
    _, m_ref, l_ref = chunked_attention(q, k, k, valid_lo=pad,
                                        valid_len=valid_len, causal=True,
                                        return_stats=True)
    _assert_stats_close(got, (m_ref, l_ref))
    assert (got[1][:, :pad] == 0).all() and (got[1][:, hi:] == 0).all()


@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("D,T,pad,valid_len,H,H_kv", [
    (128, 1000, 60, None, 8, 4), (64, 777, 0, None, 4, 2),
    (128, 2048, 300, 1900, 4, 1), (64, 200, 150, None, 2, 2),
    (128, 64, 0, None, 2, 1), (128, 2100, 77, None, 8, 1)])
def test_flash_scores_kernel_matches_plain(dev, mode, D, T, pad, valid_len,
                                           H, H_kv):
    # standalone (K2's stats-only mode, then the column pass) and fed with
    # the row statistics of K2's attention call, each against the plain
    # version and against each other
    g = torch.Generator(device=dev).manual_seed(T + D)
    q = torch.randn((H, T, D), generator=g, device=dev).bfloat16()
    k = torch.randn((H_kv, T, D), generator=g, device=dev).bfloat16()
    v = torch.randn((H_kv, T, D), generator=g, device=dev).bfloat16()
    n0, a0 = flash_scores.launches, flash_attention.launches
    got = flash_scores(q, k, valid_lo=pad, valid_len=valid_len,
                       score_mode=mode)
    torch.cuda.synchronize()
    assert flash_scores.launches == n0 + 1
    assert flash_attention.launches == a0
    _, m, l = flash_attention(q, k, v, valid_lo=pad, valid_len=valid_len,
                              return_stats=True)
    fed = flash_scores(q, k, valid_lo=pad, valid_len=valid_len,
                       score_mode=mode, row_stats=(m, l))
    torch.cuda.synchronize()
    assert flash_scores.launches == n0 + 2
    ref = flash_scores_ref(q, k, pad, valid_len, score_mode=mode)
    # per head, relative to the head's largest entry
    scale = ref.abs().amax(-1, keepdim=True)
    hi = T if valid_len is None else valid_len
    for x in (got, fed):
        assert x.shape == (H, T) and torch.isfinite(x).all()
        assert ((x - ref).abs() <= K4_TOL * scale).all()
        assert (x[:, :pad] == 0).all() and (x[:, hi:] == 0).all()
    assert ((fed - got).abs() <= K4_TOL * scale).all()


def _block_attn_inputs(dev, kv_dtype, D, bs, nb_sel, group, L=2, H_kv=4,
                       N=1536):
    rng = np.random.default_rng(D + bs)
    H = H_kv * group
    if kv_dtype == torch.int8:
        kv = torch.from_numpy(rng.integers(-127, 128, (L, H_kv, N, 2 * D),
                                           dtype=np.int8)).to(dev)
        q = torch.from_numpy(rng.normal(size=(H, 1, D)).astype(
            np.float32) * 0.01).to(dev)
    else:
        kv = torch.from_numpy(rng.normal(size=(L, H_kv, N, 2 * D)).astype(
            np.float32)).to(dev).bfloat16()
        q = torch.from_numpy(rng.normal(size=(H, 1, D)).astype(
            np.float32)).to(dev).bfloat16()
    blk = torch.from_numpy(np.stack([rng.choice(N // bs, nb_sel, replace=False)
                                     for _ in range(H_kv)])).to(dev)
    return q, kv, blk


# K1 at the decode cells' one layer (N the prompt's rows): folded kv heads
# (slots x kv heads), g, N, selected blocks of 256 rows, win_max (the local
# window) and win_len (win_max less a full ring of 128)
K1_CELLS = {
    "nemo12b-128k": (192, 4, 131072, 52, 13104, 12976),
    "mistral7b-32k": (416, 4, 32000, 13, 3196, 3068),
    "trinity-128k": (320, 8, 131072, 52, 13104, 12976),
}


def _k1_cell_inputs(dev, kv_dtype, cell):
    """K1's inputs at a cell's shape, drawn on the card (the tail is 3.4 to
    21.5 GB): per-head n_cand a little below N - win_max, the blocks drawn
    from those below each head's n_cand."""
    H_kv, g, N, nb_sel, win_max, win_len = K1_CELLS[cell]
    gen = torch.Generator(device=dev).manual_seed(H_kv + N)
    if kv_dtype == torch.int8:
        kv = torch.randint(-128, 128, (1, H_kv, N, 256), generator=gen,
                           device=dev, dtype=torch.int8)
        q = torch.randn((H_kv * g, 1, 128), generator=gen, device=dev) * 0.01
    else:
        kv = torch.randn((1, H_kv, N, 256), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        q = torch.randn((H_kv * g, 1, 128), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    rng = np.random.default_rng(H_kv)
    nc = N - win_max - rng.integers(1, 700, H_kv)
    blk = np.stack([rng.choice(-(-n // 256), nb_sel, replace=False)
                    for n in nc])
    return (q, kv, torch.from_numpy(blk).to(dev),
            torch.from_numpy(nc.astype(np.int32)).to(dev), win_len, win_max)


def _poison_past(kv, layer, ends):
    """Fill the 8 rows of each head past ends[h] (the last rows a range's
    8-row box may fetch without using them) with NaN in a bf16 tail, the
    largest value in an int8 one; returns what restores them."""
    ends = [int(e) for e in ends]
    saved = [(h, e, kv[layer, h, e:e + 8].clone()) for h, e in enumerate(ends)]
    bad = float("nan") if kv.dtype == torch.bfloat16 else 127
    for h, e, _ in saved:
        kv[layer, h, e:e + 8] = bad
    return saved


def _restore(kv, layer, saved):
    for h, e, rows in saved:
        kv[layer, h, e:e + 8] = rows


@pytest.mark.parametrize("idx_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("D,bs,nb_sel,n_cand,group,bad_ids", [
    (128, 256, 5, 1100, 4, False), (64, 16, 9, 333, 8, False),
    (128, 128, 3, 0, 1, False), (64, 256, 4, 900, 2, False),
    # many small blocks; a selection that does not divide evenly among a
    # cluster's CTAs; ids out of range (all masked); a per-head n_cand
    # that includes 0
    (64, 16, 80, 1000, 4, False), (128, 48, 9, 1300, 4, False),
    (128, 128, 6, 1000, 4, True), (128, 64, 7, [0, 700, 1536, 300], 8, False),
    # blocks of 48 rows (boxes of 32, 8, 8): the next block's 32-row box
    # starts at stage row 48, its run of marks across two mask words; stages
    # that end mid-block; n_cand off the 8-row grid
    (128, 48, 30, 1101, 4, False), (64, 48, 25, [1021, 0, 997, 555], 2, False)])
def test_block_attn_kernel_matches_plain(dev, kv_dtype, idx_dtype, D, bs,
                                         nb_sel, n_cand, group, bad_ids):
    N = 1536
    q, kv, blk = _block_attn_inputs(dev, kv_dtype, D, bs, nb_sel, group, N=N)
    nc = (torch.tensor(n_cand, dtype=torch.int32, device=dev)
          if isinstance(n_cand, list) else n_cand)
    # the rows past n_cand that a block's last box fetches are not used:
    # NaN there (bf16) must not reach the output
    saved = _poison_past(kv, 1, n_cand if isinstance(n_cand, list)
                         else [n_cand] * kv.shape[1])
    blk_ref = blk
    if bad_ids:
        # the kernel masks an id out of range; the plain version indexes
        # every id, so it gets the last block instead, all past n_cand
        blk, blk_ref = blk.clone(), blk.clone()
        blk[0, 1], blk[1, 0], blk[2, 5] = N // bs, -2, N // bs + 7
        blk_ref[0, 1] = blk_ref[1, 0] = blk_ref[2, 5] = N // bs - 1
        assert (N // bs - 1) * bs >= n_cand
    n0 = block_topk_attention.launches
    got = block_topk_attention(q, kv, 1, blk.to(idx_dtype), nc, block=bs)
    torch.cuda.synchronize()
    assert block_topk_attention.launches == n0 + 1
    _restore(kv, 1, saved)
    ref = block_topk_attention_ref(q, kv, 1, blk_ref, nc, block=bs)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * max(1.0, b.abs().max().item()))
    if isinstance(n_cand, list):    # a head with no candidate
        h = n_cand.index(0)
        assert got[0][h].eq(-1e30).all() and not got[1][h].any()
        assert not got[2][h].any()


@pytest.mark.parametrize("round_bf16", [False, True])
@pytest.mark.parametrize("lead,H_kv,g,S,C,T,off", [
    ((), 8, 4, 2, 64, 33024, 0), ((), 2, 8, 1, 256, 300, 0),
    ((3,), 2, 2, 4, 16, 1000, 0), ((), 1, 1, 16, 256, 77, 0),
    # T not a multiple of 16 (the scalar path, and a last unit cut short);
    # codes one byte into a larger buffer (the scalar path at T % 16 == 0);
    # g 3 (scalar LUT loads); bench.py's batched per-token shapes, 64
    # folded heads
    ((), 8, 4, 2, 64, 33023, 0), *[((), 2, 4, 2, 64, t, 0) for t in range(1, 16)],
    ((), 8, 4, 2, 64, 4096, 1), ((), 4, 3, 2, 64, 2000, 0),
    ((8,), 8, 4, 2, 64, 33280, 0)])
def test_adc_scores_kernel_matches_plain(dev, lead, H_kv, g, S, C, T, off,
                                         round_bf16):
    rng = np.random.default_rng(T + S)
    lut = torch.from_numpy(rng.normal(size=(*lead, H_kv, g, S, C)).astype(
        np.float32)).to(dev)
    shape = (*lead, H_kv, S, T)
    codes_np = rng.integers(0, C, size=shape).astype(np.uint8)
    # a contiguous view `off` bytes into a larger buffer
    buf = torch.zeros(off + codes_np.size, dtype=torch.uint8, device=dev)
    codes = buf[off:].view(shape)
    codes.copy_(torch.from_numpy(codes_np))
    assert codes.is_contiguous() and codes.data_ptr() % 16 == off
    n0 = adc_scores.launches
    got = adc_scores(lut, codes, round_lut_bf16=round_bf16)
    torch.cuda.synchronize()
    assert adc_scores.launches == n0 + 1
    ref = adc_scores_ref(lut, codes, round_lut_bf16=round_bf16)
    assert got.shape == (*lead, H_kv, g, T)
    if S <= 2:
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def _adc_block_inputs(dev, B, H_kv, g, S, C, T, seed):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    lut = torch.from_numpy(rng.normal(size=(*lead, H_kv, g, S, C)).astype(
        np.float32) * 4).to(dev)
    codes = torch.from_numpy(rng.integers(0, C, size=(*lead, H_kv, S, T))
                             .astype(np.uint8)).to(dev)
    return lut, codes


@pytest.mark.parametrize("B,H_kv,g,S,C,T,bs,n_cand", [
    (None, 8, 4, 2, 64, 33024, 256, 25570), (None, 2, 8, 2, 256, 2048, 16, 1999),
    (3, 2, 2, 2, 64, 2048, 128, [2048, 700, 0]), (None, 2, 4, 2, 64, 4096, 512, 0),
    # a long row (two rounds per CTA); the largest LUT (g 8, S 16, C 256);
    # B 8 with a [B] n_cand that includes 0 and T; blocks longer than 4096
    # tokens; T and sel_block that are not multiples of 16 (byte loads)
    (None, 8, 4, 2, 64, 131072, 256, 100000), (None, 2, 8, 16, 256, 4096, 256, 3000),
    (8, 8, 4, 2, 64, 8192, 256, [8192, 0, 5000, 1, 8191, 256, 0, 4000]),
    (None, 2, 2, 2, 64, 16384, 8192, 12000), (None, 2, 4, 4, 16, 1000, 40, 777)])
def test_adc_block_scores_kernel_matches_plain(dev, B, H_kv, g, S, C, T, bs,
                                               n_cand):
    lut, codes = _adc_block_inputs(dev, B, H_kv, g, S, C, T, T + bs)
    nc = (torch.tensor(n_cand, dtype=torch.int32, device=dev)
          if isinstance(n_cand, list) else n_cand)
    n0 = adc_block_scores.launches
    got = adc_block_scores(lut, codes, nc, sel_block=bs, head_dim=128)
    torch.cuda.synchronize()
    assert adc_block_scores.launches == n0 + 1
    ref = adc_block_scores_ref(lut, codes, nc, sel_block=bs, head_dim=128)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    scale = ref.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    assert ((got - ref).abs() / scale).max().item() <= 1e-5
    assert (got[ref.sum(-1) == 0] == 0).all()       # n_cand 0: zeros
    if B is None and n_cand and 13 * bs <= n_cand:
        k = 13 * bs
        assert torch.equal(
            pq.topk_from_block_mass(got, n_cand, k, group=g, block=bs),
            pq.topk_from_block_mass(ref, n_cand, k, group=g, block=bs))


def _decode_kernel_calls(dev):
    """K1 with int64 block ids and K3, each at the 32k decode widths (8 kv
    heads, g 4, D 128; 13 of 129 blocks of 256 rows), and K1 on an int8
    tail at g 4 and g 8 with a local window read from the card."""
    q, kv, blk = _block_attn_inputs(dev, torch.bfloat16, 128, 256, 13, 4,
                                    L=1, H_kv=8, N=33024)
    lut, codes = _adc_block_inputs(dev, None, 8, 4, 2, 64, 33024, 0)
    assert blk.dtype == torch.int64
    calls = [lambda: block_topk_attention(q, kv, 0, blk, 25570, block=256),
             lambda: (adc_block_scores(lut, codes, 25570, sel_block=256,
                                       head_dim=128),)]
    wl = torch.tensor(3068, dtype=torch.int32, device=dev)
    for g in (4, 8):
        qi, kvi, blki = _block_attn_inputs(dev, torch.int8, 128, 256, 13, g,
                                           L=1, H_kv=8, N=33024)
        calls.append(lambda qi=qi, kvi=kvi, blki=blki: block_topk_attention(
            qi, kvi, 0, blki, 25570, block=256, win_len=wl, win_max=3196))
    return calls


def test_decode_kernels_are_deterministic(dev):
    # the on-chip merges sum in a fixed order, with no atomics: two eager
    # calls and a CUDA-graph replay give bitwise the same output
    for call in _decode_kernel_calls(dev):
        a, b = call(), call()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            c = call()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert all(torch.equal(x, y) for x, y in zip(a, c))


def test_decode_kernels_launch_once(dev):
    # one CUDA kernel per call, and no cast, memset or copy beside it
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for call in _decode_kernel_calls(dev):
        call()                                  # build and load first
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        ev = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        assert len(ev) == 1, ev


@pytest.mark.parametrize("dtype,D2", [(torch.bfloat16, 256),
                                      (torch.int8, 256), (torch.float32, 128),
                                      (torch.int8, 6)])
@pytest.mark.parametrize("idx_dtype", [torch.int64, torch.int32])
def test_gather_rows_kernel_matches_plain(dev, dtype, D2, idx_dtype):
    rng = np.random.default_rng(D2)
    L, H, T, K = 3, 8, 1030, 3273
    x = torch.from_numpy(rng.normal(size=(L * H, T, D2)).astype(np.float32)
                         * 50).to(dev)
    src = x.to(dtype)
    idx = torch.from_numpy(rng.integers(-5, T + 5, size=(H, K))).to(dev).to(
        idx_dtype)
    n0 = gather_rows.launches
    got = gather_rows(src, idx, H)
    torch.cuda.synchronize()
    assert gather_rows.launches == n0 + 1
    assert torch.equal(got, gather_rows_ref(src, idx, H))


@pytest.mark.parametrize("pq_kw", [
    dict(select_block=64), dict(select_block=1, gather_mode="pallas"),
    dict(select_block=64, scorer="kernel")],
    ids=["jhist", "per-token", "kernel-scorer"])
def test_engine_kernels_match_plain_versions(dev, pq_kw):
    # head_dim 64: the smallest head dim the kernels take
    cfg = config.tiny_model_config(hidden_size=256, num_heads=4,
                                   num_kv_heads=2, head_dim=64,
                                   intermediate_size=512, num_layers=2)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=1500)
    toks = {}
    for kernels in ("auto", "xla"):
        ecfg = config.EngineConfig(
            model=cfg,
            pq=config.PQConfig(n_subbits=4, kmeans_iters=4, **pq_kw),
            budget=config.BudgetConfig(compress_ratio=0.3, sink_size=4),
            cache=config.CacheConfig(kv_dtype="int8"),
            runtime=config.RuntimeConfig(prefill_bucket=256,
                                         max_new_tokens=8, max_seq_len=4096,
                                         kernels=kernels))
        res = Engine(ecfg, params).generate(ids, 8)
        assert res.policy_name == "pq_search"
        toks[kernels] = res.tokens
    assert len(toks["auto"]) == 8
    # first token from the prefill logits; later ones may part at a near tie
    assert toks["auto"][0] == toks["xla"][0]


# the evaluation path's branches: (PQConfig overrides, RuntimeConfig
# overrides, kv tail, the decode kernels each layer-step launches)
BRANCH_CASES = {
    "ip-block": (dict(metric="ip", select_block=64), {}, "bf16",
                 {"adc_scores", "block_topk_attention"}),
    "ip-token": (dict(metric="ip", select_block=1), {}, "int8",
                 {"adc_scores"}),
    "nogqa": (dict(select_block=1), dict(gqa=False), "bf16",
              {"adc_scores"}),
    "masked": (dict(select_block=1, fetch_mode="masked"), {}, "bf16",
               {"adc_scores"}),
    "masked-int8": (dict(select_block=1, fetch_mode="masked"), {}, "int8",
                    {"adc_scores"}),
    "no_drop_lb": ({}, dict(policy="no_drop_lb"), "bf16", set()),
    "sparq_f": ({}, dict(policy="sparq_f", sparq_topr=16), "bf16", set()),
}
_DECODE_KERNELS = {"adc_scores": adc_scores,
                   "block_topk_attention": block_topk_attention,
                   "gather_rows": gather_rows,
                   "adc_block_scores": adc_block_scores}


@pytest.mark.parametrize("case", list(BRANCH_CASES))
def test_branch_kernels_match_plain_versions(dev, case):
    # kernels="auto" against kernels="xla" on the card: the prefill logits
    # (K2 against its plain version), then 6 decode steps each taken from
    # one shared state (the kernel route's, copied for the plain route) fed
    # the same tokens, logits within 2% of the largest |logit|: K5 sums the
    # same LUT entries as its plain version (the same selections), K1 is
    # float32 against float32, and their outputs round to bf16 in another
    # order. Each layer-step launches exactly the branch's kernels.
    import copy
    pq_kw, rt, kv, kernels = BRANCH_CASES[case]
    cfg = config.tiny_model_config(hidden_size=256, num_heads=4,
                                   num_kv_heads=2, head_dim=64,
                                   intermediate_size=512, num_layers=2)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)

    def ecfg(kn):
        return config.EngineConfig(
            model=cfg, pq=config.PQConfig(n_subbits=4, kmeans_iters=4,
                                          **pq_kw),
            budget=config.BudgetConfig(compress_ratio=0.3, sink_size=4),
            cache=config.CacheConfig(kv_dtype=kv),
            runtime=config.RuntimeConfig(**dict(dict(
                prefill_bucket=256, max_new_tokens=8, max_seq_len=4096,
                kernels=kn), **rt)))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=1500)
    P, pad = 1536, 36
    toks = torch.zeros(P, dtype=torch.long, device=dev)
    toks[pad:] = torch.from_numpy(ids).to(dev)
    budget = compute_budget(ecfg("auto").budget, P, 8)
    pols = {kn: get_policy(ecfg(kn), budget, device=dev)
            for kn in ("auto", "xla")}
    logits = {}
    for kn, pol in pols.items():
        st = pol.init_state(torch.bfloat16)
        n0 = flash_attention.launches
        logits[kn] = llama.prefill(cfg, params, pol, st, toks, pad, len(ids))
        assert flash_attention.launches == n0 + cfg.num_layers * (
            kn == "auto")
        if kn == "auto":
            state = st
    scale = logits["xla"].abs().max()
    assert (logits["auto"] - logits["xla"]).abs().max() <= 0.02 * scale
    tok = int(logits["xla"].argmax())
    for i in range(6):
        plain_state = copy.deepcopy(state)
        n0 = {k: f.launches for k, f in _DECODE_KERNELS.items()}
        la = llama.decode_step(cfg, params, pols["auto"], state,
                               torch.full((), tok, device=dev), len(ids) + i)
        assert {k: f.launches - n0[k] for k, f in _DECODE_KERNELS.items()} \
            == {k: cfg.num_layers * (k in kernels) for k in _DECODE_KERNELS}
        lx = llama.decode_step(cfg, params, pols["xla"], plain_state,
                               torch.full((), tok, device=dev), len(ids) + i)
        assert (la - lx).abs().max() <= 0.02 * lx.abs().max(), i
        tok = int(lx.argmax())
    # end to end: the first token comes from the prefill logits
    got = {kn: Engine(ecfg(kn), params, device=dev).generate(ids, 8)
           for kn in pols}
    assert got["auto"].policy_name == rt.get("policy", "pq_search")
    assert got["auto"].tokens[0] == got["xla"].tokens[0]


@pytest.mark.parametrize("policy,score_func", [
    ("h2o", "sum"), ("h2o", "max"), ("infllm", "sum")])
def test_score_policies_kernels_match_plain(dev, policy, score_func):
    # one layer's prefill from identical bf16 q, k, v: on the card through
    # K2 + K4, on the CPU through the plain versions. K2's rows are held as
    # in its own test; the scores differ by K4's error (K4_TOL of each
    # head's largest entry), which may move a near tie at the top-k
    # boundary: the kept sets may differ in at most 1% of the valid slots
    cfg = config.tiny_model_config(hidden_size=256, num_heads=4,
                                   num_kv_heads=2, head_dim=64,
                                   intermediate_size=512, num_layers=2)

    def ecfg(kernels):
        return config.EngineConfig(
            model=cfg,
            budget=config.BudgetConfig(compress_ratio=0.3, sink_size=4),
            cache=config.CacheConfig(block_size=32),
            runtime=config.RuntimeConfig(policy=policy, score_func=score_func,
                                         prefill_bucket=256, max_new_tokens=8,
                                         max_seq_len=4096, kernels=kernels))
    rng = np.random.default_rng(1)
    P, pad = 1024, 90
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .bfloat16() for s in ((4, P, 64), (2, P, 64), (2, P, 64)))
    budget = compute_budget(ecfg("auto").budget, P, 8)
    got = {}
    for device, kernels in (("cuda", "auto"), ("cpu", "xla")):
        pol = get_policy(ecfg(kernels), budget, device=device)
        st = pol.init_state(torch.bfloat16)
        n0 = flash_scores.launches
        out = pol.prefill_attn(st, 0, q.to(device), k.to(device),
                               v.to(device), pad, P)
        assert flash_scores.launches == n0 + (device == "cuda")
        got[device] = (out.cpu().float(), st)
    (out, st), (ref, st_ref) = got["cuda"], got["cpu"]
    err = (out - ref).norm(dim=-1)[:, pad:]
    assert (err / ref.norm(dim=-1)[:, pad:]).max() <= 1e-2
    if policy == "h2o":
        mask, mask_ref = st.mask[0].cpu(), st_ref.mask[0]
        assert (mask != mask_ref).sum() <= 0.01 * 2 * (P - pad)
        both = mask & mask_ref
        scale = st_ref.scores[0].abs().amax(-1, keepdim=True)
        diff = (st.scores[0].cpu() - st_ref.scores[0]).abs()
        assert (diff[both] <= (K4_TOL * scale).expand_as(diff)[both]).all()
    else:
        valid = st_ref.repr_valid[0]
        assert torch.equal(st.repr_valid[0].cpu(), valid)
        same = (st.k_repr[0].cpu() == st_ref.k_repr[0]).all(-1)[valid]
        assert same.float().mean() >= 0.99
    # end to end on the card: the first token comes from the prefill logits
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    ids = rng.integers(0, cfg.vocab_size, size=1500)
    toks = {kn: Engine(ecfg(kn), params).generate(ids, 8).tokens
            for kn in ("auto", "xla")}
    assert len(toks["auto"]) == 8 and toks["auto"][0] == toks["xla"][0]


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("case", ["vector", "zero", "tail-end", "scalar",
                                  "pair", *K1_CELLS])
def test_block_attn_window_matches_plain(dev, kv_dtype, case):
    # K1's local-window coverage at the batched decode's widths (B 8 x 8
    # kv heads folded: 64 heads, g 4, D 128, blocks of 256): win_len read
    # from device memory, per head or one 0-d value for every head (the
    # batched path passes local - ring_r); win_len 0; windows that end on
    # the tail's last row; the pair fetch (blocks of 128); and each decode
    # cell's one layer (K1_CELLS), a full ring's win_len as one 0-d value
    if case in K1_CELLS:
        q, kv, blk, nc, win_len, win_max = _k1_cell_inputs(dev, kv_dtype,
                                                           case)
        N, bs, layer = kv.shape[2], 256, 0
        wl = torch.tensor(win_len, dtype=torch.int32, device=dev)
    else:
        H_kv, bs, N, win_max, layer = 64, 256, 4096, 700, 1
        if case == "pair":
            bs = 128
        q, kv, blk = _block_attn_inputs(dev, kv_dtype, 128, bs, 5, 4, L=2,
                                        H_kv=H_kv, N=N)
        g = torch.Generator(device=dev).manual_seed(11)
        nc = torch.randint(0, N - win_max, (H_kv,), generator=g, device=dev,
                           dtype=torch.int32)
        wl = torch.randint(0, win_max + 1, (H_kv,), generator=g, device=dev,
                           dtype=torch.int32)
        if case == "zero":
            wl.zero_()
        elif case == "tail-end":
            nc = N - wl                 # every window ends on the last row
        elif case == "scalar":
            wl = torch.tensor(win_max - 3, dtype=torch.int32, device=dev)
    kw = dict(block=bs, win_len=wl, win_max=win_max, pair=case == "pair")
    # the rows past a window's end that its last box fetches are not used
    saved = _poison_past(kv, layer, (nc + wl).tolist())
    n0 = block_topk_attention.launches
    got = block_topk_attention(q, kv, layer, blk, nc, **kw)
    torch.cuda.synchronize()
    assert block_topk_attention.launches == n0 + 1
    # the same launch reads a changed window from the card: a graph replay
    # after an in-place update of win_len follows it
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = block_topk_attention(q, kv, layer, blk, nc, **kw)
    wl0 = wl.clone()
    wl.copy_(torch.clamp(wl - 37, min=0))
    graph.replay()
    torch.cuda.synchronize()
    _restore(kv, layer, saved)
    for out, w in ((got, wl0), (cap, wl)):
        ref = block_topk_attention_ref(q, kv, layer, blk, nc,
                                       **dict(kw, win_len=w))
        for a, b in zip(out, ref):
            torch.testing.assert_close(
                a, b, rtol=1e-4, atol=1e-4 * max(1.0, b.abs().max().item()))


def test_adc_scores_largest_lut_captures_into_a_graph(dev):
    # K5 with the largest LUT (g 8, S 16, C 256: 128 KB of shared memory)
    # sets its attribute once per process, so a launch inside a capture
    # makes no attribute call: captured, replayed, and held to its plain
    # version (S 16: its own summation order, 1e-6)
    rng = np.random.default_rng(3)
    lut = torch.from_numpy(rng.normal(size=(2, 8, 16, 256)).astype(
        np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, 256, size=(2, 16, 4096))
                             .astype(np.uint8)).to(dev)
    for rnd in (False, True):
        adc_scores(lut, codes, round_lut_bf16=rnd)       # built, loaded
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = adc_scores(lut, codes, round_lut_bf16=rnd)
        lut.mul_(0.5)                    # the replay reads the new values
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out, adc_scores_ref(lut, codes, round_lut_bf16=rnd), rtol=1e-6,
            atol=1e-6)


def test_adc_scores_batched_shapes_capture_into_a_graph(dev):
    # K5 at bench.py's batched per-token shapes (B 8 x 8 kv heads folded,
    # T 33280) captured into a CUDA graph: the replay reads new LUT values
    # and new codes in place and gives the eager launch's scores, bit for bit
    rng = np.random.default_rng(5)
    lut = torch.from_numpy(rng.normal(size=(8, 8, 4, 2, 64)).astype(
        np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, 64, size=(8, 8, 2, 33280))
                             .astype(np.uint8)).to(dev)
    for rnd in (False, True):
        adc_scores(lut, codes, round_lut_bf16=rnd)       # built, loaded
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = adc_scores(lut, codes, round_lut_bf16=rnd)
        lut.mul_(0.5)
        codes.copy_(codes.flip(-1))
        graph.replay()
        eager = adc_scores(lut, codes, round_lut_bf16=rnd)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert torch.equal(out, adc_scores_ref(lut, codes,
                                               round_lut_bf16=rnd))


def _batched_setup(dev, policy, pq_kw, kv_dtype="int8", B=3):
    """A 2-layer model at the kernels' smallest head dim, B slots prefilled
    through the port (its own codebooks) and inserted into a batched state;
    the slots' first tokens and positions."""
    cfg = config.tiny_model_config(hidden_size=256, num_heads=4,
                                   num_kv_heads=2, head_dim=64,
                                   intermediate_size=512, num_layers=2)
    ecfg = config.EngineConfig(
        model=cfg, pq=config.PQConfig(n_subbits=4, kmeans_iters=4, **pq_kw),
        budget=config.BudgetConfig(compress_ratio=0.3, sink_size=4),
        cache=config.CacheConfig(kv_dtype=kv_dtype),
        runtime=config.RuntimeConfig(policy=policy, max_new_tokens=24))
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    P = 1536
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, 24), device=dev)
    bstate = pol.init_batched_state(B)
    rng = np.random.default_rng(0)
    first, pos = [], []
    for slot in range(B):
        n = P - 61 * slot
        ids = np.zeros(P, np.int64)
        ids[P - n:] = rng.integers(0, cfg.vocab_size, size=n)
        st = pol.init_state()
        logits = llama.prefill(cfg, params, pol, st,
                               torch.from_numpy(ids).to(dev), P - n, n)
        pol.insert_slot(bstate, st, slot)
        first.append(int(torch.argmax(logits)))
        pos.append(n)
    return (cfg, params, pol, bstate, torch.tensor(first, device=dev),
            torch.tensor(pos, device=dev))


BATCHED_GRAPH_CASES = {
    "jhist": ("pq_search", dict(select_block=64)),
    "jhist-deferred": ("pq_search", dict(select_block=64, jhist_defer="on")),
    "k3": ("pq_search", dict(select_block=64, scorer="kernel")),
    "per-token": ("pq_search", dict(select_block=1, gather_mode="pallas")),
    "original": ("original", {}),
}


@pytest.mark.parametrize("case", list(BATCHED_GRAPH_CASES))
def test_graph_replay_matches_eager_decode(dev, case):
    # the batched decode replayed from a CUDA graph gives the eager decode's
    # tokens over 2 chunks (a flush between them) and leaves the state where
    # eager decoding leaves it: counters, ring, histogram, codes and tail
    import copy
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    policy, pq_kw = BATCHED_GRAPH_CASES[case]
    cfg, params, pol, state, tok, pos = _batched_setup(dev, policy, pq_kw)
    chunk = 6
    twin = copy.deepcopy(state)
    eager = BatchedDecoder(cfg, params, pol, twin, chunk=chunk, graph=False)
    want = eager.generate(tok, pos, 2 * chunk)
    replay = BatchedDecoder(cfg, params, pol, state, chunk=chunk)
    got = replay.generate(tok, pos, 2 * chunk)
    torch.cuda.synchronize()
    assert replay.graph is not None and replay.capture_seconds > 0
    assert torch.equal(got, want), (got, want)
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(twin, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    if policy == "pq_search":
        assert int(state.ring_r) == 0
        assert torch.equal(state.n_cand.cpu(),
                           twin.n_cand.cpu())


def test_decompose_replayed_joins_every_replayed_kernel(dev, tmp_path):
    # harness/trace.py's split of a replayed BatchedDecoder: every device
    # event of 4 replays joined, by launch order, to the eager step's
    # kernels (what the host launches around a replay joins its host op);
    # K1 under pq_fetch, the scorer under pq_score; the split's total the
    # replayed profile's device time; one graph launch a step
    from pqcache_tpu_torch.harness import trace
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    cfg, params, pol, state, tok, pos = _batched_setup(
        dev, "pq_search", dict(select_block=64))
    dec = BatchedDecoder(cfg, params, pol, state, chunk=12)
    res = trace.decompose_replayed(dec, tok, pos, steps=4,
                                   trace_dir=str(tmp_path))
    s = res["summary"]
    assert dec.replays == 5
    assert res["joined"] == res["kernels"] * 4
    assert res["joined"] + res["launched"] == round(
        (s["kernels"] + s["copies"]) * 4)
    assert res["unmapped_ms"] == 0.0, res
    assert res["pq_ms"] > 0 and res["fetch_ms"] > 0 and res["model_ms"] > 0
    assert res["total_ms"] == pytest.approx(s["dev_ms"] + s["copy_ms"])
    assert res["total_ms"] == pytest.approx(
        sum(res[f"{b}_ms"] for b in trace.BUCKETS))
    assert s["graph_launches"] == 1.0
    # the eager split of the same decoder's steps joins its launches too
    dec.begin(tok, pos)
    eager = trace.decompose(lambda: [dec.step(eager=True) for _ in range(2)],
                            steps=2)
    assert eager["unmapped_ms"] == 0.0 and eager["fetch_ms"] > 0

def test_segment_merge_in_bf16_gemms_matches_f32_copies(dev):
    # the decode segment merge multiplies bf16 q, keys and probabilities
    # with bf16 values as bf16 GEMMs that write f32: the same products as
    # f32 copies of the operands, summed in another order, and written in
    # bf16 (bf16 resolution: 1e-2 of the largest entry); masked rows and a
    # second segment as in the dense arm
    from pqcache_tpu_torch.ops.attention_ref import (
        decode_window_attention_segments)
    gen = torch.Generator(device=dev).manual_seed(11)
    Hf, g, T, D = 16, 4, 3000, 128
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in ((Hf * g, 1, D), (Hf, T, D), (Hf, T, D)))
    kn, vn = (torch.randn((Hf, 1, D), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    hi = torch.randint(1, T, (Hf,), generator=gen, device=dev)
    mask = torch.arange(T, device=dev)[None] < hi[:, None]
    got = decode_window_attention_segments(q, [(k, v, mask), (kn, vn, None)])
    # the f32 route, with p rounded to bf16 before PV as the bf16 route does
    f = decode_window_attention_segments(
        q.float(), [(k.float(), v, mask), (kn.float(), vn, None)])
    assert got.dtype == torch.bfloat16
    err = (got.float() - f).abs().max().item()
    assert err <= 1e-2 * f.abs().max().item(), err


def _w8_inputs(dev, M, N, K, seed=0):
    """bf16 x [M, K] of unit scale, int8 w [K, N] over the whole int8 range,
    bf16 scales [1, N] of the size quantize_weight_mat gives 0.02-scale
    weights."""
    g = torch.Generator(device=dev).manual_seed(seed + M + N + K)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    s = (torch.rand((1, N), generator=g, device=dev) * 4e-4 + 1e-4).bfloat16()
    return x, w, s


def _assert_w8_close(got, ref):
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                               atol=2e-2 * ref.float().abs().max().item())


@pytest.mark.parametrize("lm_head", [False, True], ids=["layer", "head"])
@pytest.mark.parametrize("K", [4096, 14336])
@pytest.mark.parametrize("N", [1024, 4096, 14336, 128256, 1000])
@pytest.mark.parametrize("M", [1, 2, 8, 16, 64])
def test_w8_kernel_matches_plain(dev, M, N, K, lm_head):
    # the path's shapes at Llama-3.1-8B width (wk/wv, wq/wo, gate/up, down,
    # the LM head) at the Engine's and bench.py's rows and up to 64, split
    # along K in clusters of 1 to 16 CTAs; N 1000 is no multiple of a
    # tile's columns nor of 16 bytes; the layer epilogue writes bf16, the
    # head's f32
    x, w, s = _w8_inputs(dev, M, N, K)
    n0 = w8_matmul.launches
    got = w8_matmul(x, w, s, lm_head=lm_head)
    again = w8_matmul(x, w, s, lm_head=lm_head)
    torch.cuda.synchronize()
    assert w8_matmul.launches == n0 + 2
    assert got.shape == (M, N)
    assert got.dtype == (torch.float32 if lm_head else torch.bfloat16)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    _assert_w8_close(got, w8_matmul_ref(x, w, s, lm_head=lm_head))


@pytest.mark.parametrize("M", [1, 8, 40])
def test_w8_kernel_narrowest_loads(dev, M):
    # N 4100: a multiple of 4, not of 8 (4-byte loads at every M)
    x, w, s = _w8_inputs(dev, M, 4100, 14336, seed=1)
    got = w8_matmul(x, w, s)
    torch.cuda.synchronize()
    _assert_w8_close(got, w8_matmul_ref(x, w, s))


def test_w8_kernel_captures_into_a_graph(dev):
    # captured (a cluster launch splitting K), replayed on new inputs
    # written in place: the eager call's output, bit for bit
    x, w, s = _w8_inputs(dev, 8, 4096, 14336, seed=2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w8_matmul(x, w, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = w8_matmul(x, w, s)
    x.mul_(-0.5)
    w.copy_(w.flip(0))
    graph.replay()
    eager = w8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    _assert_w8_close(out, w8_matmul_ref(x, w, s))


def test_w8_kernel_refuses_what_it_does_not_take(dev):
    x, w, s = _w8_inputs(dev, 65, 1024, 4096)
    with pytest.raises(ValueError, match="rows"):
        w8_matmul(x, w, s)                       # prefill rows
    with pytest.raises(ValueError, match="device"):
        w8_matmul(x[:8], w.cpu(), s)
    with pytest.raises(ValueError, match="contiguous"):
        w8_matmul(x[:8], w.t().contiguous().t(), s)
    with pytest.raises(TypeError):
        w8_matmul(x[:8].float(), w, s)


# the decode path's groups at Llama-3.1-8B width: (K, N of each product)
W8_GROUPS = {"qkv": (4096, (4096, 1024, 1024)),
             "gate/up": (4096, (14336,) * 2), "wo": (4096, (4096,)),
             "down": (14336, (4096,)), "tiny-qkv": (256, (256, 128, 128))}


def _w8_group_inputs(dev, M, K, Ns, seed=0, offset=0):
    """x [M, K] and the products (w, s) of _w8_inputs, each w a view
    ``offset`` bytes into its buffer."""
    g = torch.Generator(device=dev).manual_seed(seed + M + K + sum(Ns))
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    prods = []
    for N in Ns:
        buf = torch.randint(-128, 128, (K * N + 16,), generator=g, device=dev,
                            dtype=torch.int8)
        s = (torch.rand((1, N), generator=g, device=dev) * 4e-4
             + 1e-4).bfloat16()
        prods.append((buf[offset:offset + K * N].view(K, N), s))
    return x, prods


@pytest.mark.parametrize("group", list(W8_GROUPS))
@pytest.mark.parametrize("M", [1, 3, 8, 13, 33, 64])
def test_w8_group_matches_plain(dev, M, group):
    # one launch for the group: each product within W8_TOL of its plain
    # version, two calls bitwise equal, one count per launch
    K, Ns = W8_GROUPS[group]
    x, prods = _w8_group_inputs(dev, M, K, Ns)
    n0 = w8_matmul.launches
    got = w8_matmul_group(x, prods)
    again = w8_matmul_group(x, prods)
    torch.cuda.synchronize()
    assert w8_matmul.launches == n0 + 2
    for y, y2, ref, N in zip(got, again, w8_matmul_group_ref(x, prods), Ns):
        assert y.shape == (M, N) and y.dtype == torch.bfloat16
        assert torch.isfinite(y).all() and torch.equal(y, y2)
        _assert_w8_close(y, ref)


@pytest.mark.parametrize("offset", [4, 8])
@pytest.mark.parametrize("group", ["qkv", "down"])
def test_w8_group_unaligned_weights(dev, group, offset):
    # weights 4 and 8 bytes past a 16-byte boundary: no tensor map, the
    # producer warp's own loads
    K, Ns = W8_GROUPS[group]
    x, prods = _w8_group_inputs(dev, 8, K, Ns, seed=3, offset=offset)
    assert all(w.data_ptr() % 16 == offset for w, _ in prods)
    got = w8_matmul_group(x, prods)
    torch.cuda.synchronize()
    for y, ref in zip(got, w8_matmul_group_ref(x, prods)):
        _assert_w8_close(y, ref)


@pytest.mark.parametrize("group", ["qkv", "gate/up"])
def test_w8_group_captures_into_a_graph(dev, group):
    # captured, replayed on new inputs written in place: the eager call's
    # outputs bit for bit
    K, Ns = W8_GROUPS[group]
    x, prods = _w8_group_inputs(dev, 8, K, Ns, seed=4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w8_matmul_group(x, prods)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = w8_matmul_group(x, prods)
    x.mul_(-0.5)
    for w, _ in prods:
        w.copy_(w.flip(0))
    graph.replay()
    eager = w8_matmul_group(x, prods)
    torch.cuda.synchronize()
    for y, e, ref in zip(outs, eager, w8_matmul_group_ref(x, prods)):
        assert torch.equal(y, e)
        _assert_w8_close(y, ref)


def test_w8_engine_launches_per_step(dev):
    # Engine.generate with W8 weights: the LM head of the prefill's last
    # row, then 4 L + 1 launches per decode step
    from pqcache_tpu_torch.core import quant
    from pqcache_tpu_torch.ops import w8
    cfg = config.tiny_model_config(hidden_size=256, num_heads=4,
                                   num_kv_heads=2, head_dim=64,
                                   intermediate_size=512, num_layers=2)
    params = quant.quantize_weight_tree(llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    ecfg = config.EngineConfig(
        model=cfg, pq=config.PQConfig(n_subbits=4, kmeans_iters=4),
        budget=config.BudgetConfig(compress_ratio=0.3, sink_size=4),
        cache=config.CacheConfig(kv_dtype="int8"),
        runtime=config.RuntimeConfig(prefill_bucket=256, max_new_tokens=8,
                                     max_seq_len=4096))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=1500)
    n0 = w8.w8_matmul.launches
    res = Engine(ecfg, params).generate(ids, 8)
    torch.cuda.synchronize()
    steps = len(res.tokens) - 1
    assert steps == 7
    assert w8.w8_matmul.launches - n0 == 1 + steps * (4 * cfg.num_layers + 1)


def test_w8_graph_replay_matches_eager_decode(dev):
    # the batched decode with W8 weights replayed from a CUDA graph gives
    # the eager decode's tokens and state; the W8 kernel ran in both
    import copy
    from pqcache_tpu_torch.core import quant
    from pqcache_tpu_torch.ops import w8
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    cfg, params, pol, state, tok, pos = _batched_setup(
        dev, "pq_search", dict(select_block=64))
    params = quant.quantize_weight_tree(params)
    twin = copy.deepcopy(state)
    n0 = w8.w8_matmul.launches
    want = BatchedDecoder(cfg, params, pol, twin, chunk=6,
                          graph=False).generate(tok, pos, 12)
    # per step one launch for q/k/v, wo, gate/up and down, and the LM head
    assert w8.w8_matmul.launches - n0 == 12 * (4 * cfg.num_layers + 1)
    got = BatchedDecoder(cfg, params, pol, state, chunk=6).generate(tok, pos,
                                                                    12)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(twin, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name


def _serving_engine(dev, policy="pq_search", pq_kw=None, kv_dtype="int8",
                    graph=True, w8=False, prefix_len=0, interleave="auto",
                    **rt):
    """A BatchEngine over the 2-layer model of _batched_setup (2 slots,
    pool length 1024, 12 new tokens) and 5 prompts for it."""
    from pqcache_tpu_torch.core import quant
    from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
    cfg = config.tiny_model_config(hidden_size=256, num_heads=4,
                                   num_kv_heads=2, head_dim=64,
                                   intermediate_size=512, num_layers=2)
    ecfg = config.EngineConfig(
        model=cfg, pq=config.PQConfig(n_subbits=4, kmeans_iters=4,
                                      **(pq_kw or dict(select_block=64))),
        budget=config.BudgetConfig(compress_ratio=0.3, sink_size=4),
        cache=config.CacheConfig(kv_dtype=kv_dtype),
        runtime=config.RuntimeConfig(policy=policy, max_new_tokens=12,
                                     max_seq_len=2048, **rt))
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    if w8:
        params = quant.quantize_weight_tree(params)
    rng = np.random.default_rng(0)
    prefix = None
    if prefix_len:
        from pqcache_tpu_torch.runtime.generate import Engine as E
        prefix = E(ecfg, params, device=dev).prefill_prefix(
            rng.integers(0, cfg.vocab_size, prefix_len))
    be = BatchEngine(ecfg, params, batch_size=2, prefill_len=1024,
                     max_new_tokens=12, prefix=prefix, device=dev,
                     graph=graph, interleave=interleave)
    n_max = 1024 - prefix_len
    prompts = [rng.integers(0, cfg.vocab_size, n_max - 97 * i)
               for i in range(5)]
    return be, list(enumerate(prompts))


def _same_bstate(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a)
               if isinstance(getattr(a, f.name), torch.Tensor))


@pytest.mark.parametrize("rt", [dict(prefill_chunk=256),
                                dict(temperature=0.8, top_k=50, top_p=0.9,
                                     sample_seed=3, prefill_chunk=256),
                                dict(temperature=0.8, top_k=50, top_p=0.9,
                                     sample_seed=3)])
def test_batch_engine_replay_matches_eager(dev, rt):
    # 5 requests through 2 slots: admissions (interleaved slabs, or
    # monolithic) run eagerly between replays of the captured step; the
    # replayed engine gives the eager engine's tokens, sampled or greedy,
    # and leaves the batched state where the eager one leaves it
    rep, reqs = _serving_engine(dev, **rt)
    eager, _ = _serving_engine(dev, graph=False, **rt)
    assert rep.interleave == ("prefill_chunk" in rt)
    want = eager.run(reqs, chunk=5)
    got = rep.run(reqs, chunk=5)
    torch.cuda.synchronize()
    assert rep.decoder.graph is not None and rep.decoder.replays > 0
    assert got == want
    assert all(len(v) == 12 for v in got.values())
    assert _same_bstate(rep.bstate, eager.bstate)


def test_batched_decoder_sampled_replay_matches_eager(dev):
    # the captured step samples from the static noise buffer refilled
    # before each replay: replayed and eager decoding from one generator
    # seed give the same tokens and states. top_k 1 keeps every logit tied
    # at the largest (as JAX's `>= kth` does) and the noise picks one: at
    # every step and slot the token is the tied token with the largest
    # noise, greedy's argmax unless bf16 logits tie
    import copy
    from pqcache_tpu_torch.core.sampling import GumbelNoise, make_sampler
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    cfg, params, pol, state, tok, pos = _batched_setup(
        dev, "pq_search", dict(select_block=64))
    twin, one_st, one_eager_st = (copy.deepcopy(state) for _ in range(3))
    one_hot, seen = make_sampler(0.8, 1), []

    def recording(lg, noise):
        seen.append((lg.float().clone(), noise.clone()))
        return one_hot(lg, noise)

    def run(st, sample, graph=True):
        return BatchedDecoder(cfg, params, pol, st, chunk=6, graph=graph,
                              sample=sample, noise=GumbelNoise(9, dev)
                              ).generate(tok, pos, 12)
    hot = make_sampler(0.8, 50, 0.9)
    got, want = run(state, hot), run(twin, hot, graph=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and _same_bstate(state, twin)
    one, one_eager = run(one_st, one_hot), run(one_eager_st, recording,
                                                graph=False)
    assert torch.equal(one, one_eager)
    lg = torch.stack([x for x, _ in seen])
    noise = torch.stack([g for _, g in seen])
    tied = lg == lg.amax(-1, keepdim=True)
    rule = torch.where(tied, noise, -torch.inf).argmax(-1).to(torch.int32)
    assert lg.shape[:2] == one_eager.shape
    assert torch.equal(one_eager, rule)


SERVING_CASES = {
    "block-int8": dict(),
    "block-bf16-interleaved": dict(kv_dtype="bf16", prefill_chunk=256),
    "per-token": dict(pq_kw=dict(select_block=1)),
    "w8-interleaved": dict(w8=True, prefill_chunk=256),
    "prefix": dict(prefix_len=512),
    "original": dict(policy="original"),
    "original-mono": dict(policy="original", prefill_chunk=256,
                          interleave="off"),
}


@pytest.mark.parametrize("case", list(SERVING_CASES))
def test_batch_engine_on_cuda_takes_what_the_cpu_takes(dev, case):
    # every configuration the CPU engine serves, the CUDA engine serves too
    outs = {}
    for d in (torch.device("cpu"), dev):
        be, reqs = _serving_engine(d, graph=d.type == "cuda",
                                   **SERVING_CASES[case])
        outs[d.type] = be.run(reqs[:3], chunk=4)
    for out in outs.values():
        assert sorted(out) == [0, 1, 2]
        assert all(len(v) == 12 for v in out.values())


# ---------------------------------------------------------------------------
# The host-offload tier on the card: the pinned store, staging without a host
# sync, the block cache after churn; W8 on two streams at once

def _offload_store(dev, cache_tokens=96, dtype=torch.bfloat16):
    from pqcache_tpu_torch.runtime.host_offload import HostKVStore
    s = HostKVStore(2, 8, 2048, 128, block_size=32,
                    hbm_cache_tokens=cache_tokens, cache_topk_blocks=4,
                    dtype=dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    for layer in range(2):
        k, v = (torch.randn((8, 2048, 128), generator=g, device=dev)
                for _ in range(2))
        s.offload_layer_device(layer, k, v, 2048)
    s.copy_stream.synchronize()
    return s


def test_offload_host_store_is_pinned(dev):
    s = _offload_store(dev)
    assert all(h.is_pinned() for h in s.host_kv)
    assert s.pinned_bytes == sum(h.numel() * 2 for h in s.host_kv)
    assert s.stored.all() and s.copy_stream is not None


def test_offload_miss_staging_needs_no_host_sync(dev):
    # classify (LFU, staging on the copy stream), assembly and admission
    # read no count on the host: set_sync_debug_mode("error") raises on any
    # synchronizing call, such as a copy from pageable memory
    from pqcache_tpu_torch.runtime.host_offload import assemble_blocks
    s = _offload_store(dev)
    blk = np.asarray([[0, 5, 6, 7, 40, 41]] * 8)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            slots, miss, staged, cache = s.classify_blocks(1, blk)
            got = assemble_blocks(cache, staged, s.device_index(slots),
                                  s.device_index(miss))
            s.admit(1)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    assert s.hits > 0 and s.misses > 0 and s.h2d_copies > 0
    want = s.host_kv[1][torch.from_numpy(blk[0])]
    assert torch.equal(got.cpu(), want[None].expand(8, -1, -1, -1, -1)[
        torch.arange(8)[:, None], torch.arange(6)[None],
        torch.arange(8)[:, None]])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_offload_cache_after_churn_equals_host_rows(dev, dtype):
    # a 3-block cache under a rotating selection: every assembled block is
    # the host block, and so is every cache slot the proxy points at
    from pqcache_tpu_torch.runtime.host_offload import assemble_blocks
    s = _offload_store(dev, cache_tokens=96, dtype=dtype)
    rng = np.random.default_rng(7)
    for step in range(40):
        blk = np.stack([rng.choice(12, 4, replace=False) for _ in range(8)])
        blk[:, 0] = 0                         # one hot block
        slots, miss, staged, cache = s.classify_blocks(0, blk)
        got = assemble_blocks(cache, staged, s.device_index(slots),
                              s.device_index(miss))
        s.admit(0)
        host = s.host_kv[0][torch.from_numpy(blk)]      # [8, 4, 8, bs, 2D]
        want = host[torch.arange(8)[:, None], torch.arange(4)[None],
                    torch.arange(8)[:, None]]
        assert torch.equal(got.cpu(), want), step
    s.flush()
    torch.cuda.synchronize()
    res = np.flatnonzero(s.block_slot[0] >= 0)
    assert 0 < len(res) <= s.n_cache_blocks and s.hits > 0
    for b in res:
        assert torch.equal(s.cache_kv[0][int(s.block_slot[0][b])].cpu(),
                           s.host_kv[0][int(b)])


def test_offload_store_on_cuda_needs_the_native_lfu(dev, monkeypatch):
    # the Python LFU model is for CPU stores: a card store without the
    # library raises rather than time the model under the native tier's name
    from pqcache_tpu_torch.native import lfu_cache
    from pqcache_tpu_torch.runtime.host_offload import HostKVStore
    monkeypatch.setattr(lfu_cache, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="native LFU"):
        HostKVStore(1, 8, 256, 128, block_size=32, device=dev)
    assert not HostKVStore(1, 8, 256, 128, block_size=32,
                           device="cpu").lfu[0].native


def test_offload_transfer_events_fold_into_totals(dev):
    # a long-lived store keeps a bounded list of timing events: finished
    # copies fold into the device seconds, which only grow
    from pqcache_tpu_torch.runtime import host_offload
    s = _offload_store(dev, cache_tokens=96)
    rng = np.random.default_rng(3)
    seen = []
    for step in range(3 * host_offload.EVENT_FOLD):
        blk = np.stack([rng.choice(64, 4, replace=False) for _ in range(8)])
        s.classify_blocks(step % 2, blk)
        s.admit(step % 2)
        assert len(s._h2d_ev) <= host_offload.EVENT_FOLD + 1
        if step % host_offload.EVENT_FOLD == 0:
            seen.append(s.transfer_stats()["h2d_s"])
    t = s.transfer_stats()
    assert not s._h2d_ev and not s._d2h_ev
    assert 0 < seen[0] <= seen[-1] <= t["h2d_s"] and t["d2h_s"] > 0
    assert t["h2d_copies"] >= 3 * host_offload.EVENT_FOLD


def test_w8_two_streams_at_once_match_one_stream(dev):
    # each stream has its own split-K scratch: products launched on two
    # streams at once give what each gives alone (bit for bit: the fix-up
    # adds partials in CTA order)
    K, Ns = 4096, (14336, 14336)
    a = _w8_group_inputs(dev, 8, K, Ns, seed=11)
    b = _w8_group_inputs(dev, 8, K, Ns, seed=12)
    want = [w8_matmul_group(x, p) for x, p in (a, b)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, (st, (x, p)) in enumerate(zip(streams, (a, b))):
            with torch.cuda.stream(st):
                outs[i].append(w8_matmul_group(x, p))
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            assert all(torch.equal(g, w) for g, w in zip(got, want[i]))


# ---------------------------------------------------------------------------
# The parallel engines on the card: ranks are processes that share the one
# card over gloo (NCCL refuses two ranks on one device)

def _launch_on_card(fn, n, *args, **kwargs):
    from pqcache_tpu_torch.parallel import launch
    return launch.launch(fn, n, backend="gloo", devices=["cuda:0"] * n,
                         args=args, kwargs=kwargs, timeout=600)


def test_parallel_collective_routes_on_cuda(dev):
    """Every Comm operation on CUDA tensors between two ranks of one card:
    gloo's collectives take them directly, its point-to-point does not (it
    hands the device pointer to its socket), so ring_shift takes the named
    pinned-host route."""
    from pqcache_tpu_torch.parallel import collectives, workers
    res = _launch_on_card(workers.comm_ops, 2)
    for r, out in enumerate(res):
        assert out["all_reduce"].tolist() == [3.0] * 3
        assert out["all_reduce_max"].tolist() == [1.0]
        assert out["all_gather"].tolist() == [[0.0, 1.0]] * 2
        want = torch.cat([torch.arange(12.).reshape(4, 3)[2 * r:2 * r + 2]
                          + 100 * s for s in range(2)], 1)
        assert torch.equal(out["all_to_all"], want)
        assert out["ring_shift"][0].tolist() == [float(1 - r)] * 4
        assert out["ring_shift"][1].tolist() == [1 - r]
        assert out["all_true"] == (False, True)
        routes = {k: s["route"] for k, s in out["stats"].items()}
        assert routes.pop("ring_shift") == collectives.STAGED_ROUTE
        assert set(routes.values()) == {"direct"}


def test_parallel_tp2_on_one_card_matches_engine(dev):
    """TPEngine at tp 2, two gloo ranks on the card, kernels on (K2 at
    prefill, K1 at decode, each at the shard's 4 q / 2 kv heads), against
    the single-process Engine: both teacher-forced with the Engine's
    tokens, every step's logits within 0.125 (bf16; the all-reduce sums
    the wo / down partials in another order). Budget 1.0: the top-k takes
    every candidate, so a near tie of random weights' block masses cannot
    part the two runs' selections."""
    from pqcache_tpu_torch.parallel import workers
    m = config.ModelConfig(name="tp-card", vocab_size=2048, hidden_size=1024,
                           intermediate_size=2048, num_layers=2, num_heads=8,
                           num_kv_heads=4, head_dim=128)
    cfg = config.EngineConfig(
        model=m, pq=config.PQConfig(n_subvec_per_head=2, n_subbits=6,
                                    kmeans_iters=4, select_block=256),
        budget=config.BudgetConfig(compress_ratio=1.0, recent_ratio=0.5,
                                   sink_size=32),
        cache=config.CacheConfig(kv_dtype="int8"),
        runtime=config.RuntimeConfig(policy="pq_search", prefill_bucket=1024,
                                     max_new_tokens=16, max_seq_len=8192))
    params = llama.init_params(m, torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.bfloat16, device=dev)
    ids = np.random.default_rng(0).integers(0, m.vocab_size, 4000)
    ref = Engine(cfg, params, device=dev).generate(ids, 12).tokens
    pol = get_policy(cfg, compute_budget(cfg.budget, 4096, 16), dev)
    state = pol.init_state(torch.bfloat16)
    toks = np.zeros(4096, np.int64)
    toks[96:] = ids
    with torch.no_grad():
        own = [llama.prefill(m, params, pol, state,
                             torch.from_numpy(toks).to(dev), 96, 4000)]
        own += [llama.decode_step(m, params, pol, state,
                                  torch.tensor(t, device=dev), 4000 + i)
                for i, t in enumerate(ref[:-1])]
    own = torch.stack(own).float().cpu()
    res = _launch_on_card(workers.tp_generate, 2, cfg, 0, ids, 4096, 16,
                          forced=ref, dtype=torch.bfloat16)
    assert res[0]["tokens"] == res[1]["tokens"]
    assert (res[0]["forced_logits"] - own).abs().max().item() <= 0.125
    steps = len(res[0]["tokens"]) - 1
    for r in res:
        assert r["launches"]["flash_attention"] == m.num_layers
        assert r["launches"]["block_topk_attention"] == m.num_layers * steps


# (Hf, g, C, NB, K, ring_r, block[, e1's floor]): the decode cells'
# one-layer shapes (NeMo 128k: 24 slots x 8 kv heads, 514 blocks; Mistral
# 32k: 52 x 8, 127 blocks; Trinity 128k: 80 x 4 at g 8), a single sequence
# at 128k, the largest histogram rows (C 256) with a pending span over many
# blocks, every lane layout of the kernel (C 128 to 2, g 1 to 8, 3 and 5
# padded to 4 and 8), and factors down to 1e-30 that a rounded or flushed
# factor format would lose
JHIST_CASES = {
    "128k": (192, 4, 64, 514, 128, 77, 256),
    "32k": (416, 4, 64, 127, 128, 128, 256),
    "trinity-128k": (320, 8, 64, 514, 128, 100, 256),
    "single-128k": (8, 4, 64, 514, 0, None, 256),
    "C256": (4, 4, 256, 9, 128, 100, 16),
    "C128-g2": (7, 2, 128, 20, 0, None, 64),
    "C16-g8": (6, 8, 16, 33, 64, 1, 16),
    "C16-g5": (3, 5, 16, 40, 64, 64, 16),
    "C8-g3": (5, 3, 8, 70, 32, 0, 8),
    "C4-g1": (3, 1, 4, 300, 16, 16, 4),
    "C2-g2": (3, 2, 2, 41, 8, 5, 2),
    "C64-g8-tiny": (24, 8, 64, 66, 128, 77, 256, 1e-30),
}


def _jhist_inputs(dev, Hf, g, C, NB, K, ring_r, block, floor=None, seed=0):
    """Exp-LUT factors, a histogram built from skewed codes (the last two
    rows empty, a few counts saturated) and the pending span of the
    slots' last ring_r candidates (or None); each kv head's n_cand. With a
    floor, e1's LUT is scaled up into a ramp, e1 = floor^((C-1-c)/(C-1)),
    and the even blocks hold only the codes c1 < 4 (e1 within 30x of the
    floor), whose mass only those factors carry."""
    gen = torch.Generator(device=dev).manual_seed(seed + Hf * NB + C)
    lut = torch.randn((Hf * g, 2, C), generator=gen, device=dev) * 4
    if floor is not None:
        ramp = torch.arange(C - 1, -1, -1, device=dev) / (C - 1)
        lut[:, 1] = ramp * (128 ** 0.5 * math.log(floor))
    e = pq.jhist_exp_lut(lut, 128)
    T = NB * block
    u = torch.rand((Hf, 2, T), generator=gen, device=dev)
    codes = (C * u * u).long().clamp(max=C - 1).to(torch.uint8)
    if floor is not None:
        codes[:, 1].view(Hf, NB, block)[:, ::2] %= 4
    n_cand = T - 2 * block
    J = pq.build_joint_hist(codes, n_cand, n_centroids=C, block=block)
    J[:, 1:-2:5, ::97] = 255
    nc = torch.full((Hf,), n_cand, device=dev)
    if ring_r is None:
        return e, J, None, nc
    pos = (nc - ring_r)[:, None] + torch.arange(K, device=dev)
    cp = torch.randint(0, C, (Hf, 2, K), generator=gen, device=dev)
    return e, J, (pos, cp, torch.tensor(ring_r, dtype=torch.int32,
                                        device=dev)), nc


def _assert_same_blocks(got, ref, n_cand, g, block):
    """The block top-k of both masses (10% of the candidates), equal but
    where the blocks one side takes alone tie within 1e-5 in the
    reference's group mass."""
    def norm(m):
        return m / m.sum(-1, keepdim=True).clamp(min=1e-30)
    k_tokens = max(int(n_cand[0]) // 10, 1)
    a, b = (torch.sort(pq.topk_from_block_mass(norm(m), n_cand, k_tokens,
                                               group=g, block=block),
                       -1).values for m in (got, ref))
    gm = norm(ref).reshape(-1, g, ref.shape[-1]).sum(1)
    for row in (a != b).any(-1).nonzero()[:, 0].tolist():
        alone = sorted(set(a[row].tolist()) ^ set(b[row].tolist()))
        v = gm[row, alone]
        assert (v.max() - v.min()).item() <= 1e-5 * v.max().item(), (row,
                                                                     alone)


@pytest.mark.parametrize("case", list(JHIST_CASES))
def test_jhist_block_mass_kernel_matches_plain(dev, case):
    Hf, g, C, NB, K, ring_r, block, *floor = JHIST_CASES[case]
    e, J, pending, nc = _jhist_inputs(dev, Hf, g, C, NB, K, ring_r, block,
                                      *floor)
    if floor:
        assert e[:, 1].min().item() <= floor[0] * 1.01
    n0, m0 = jhist_block_mass.launches, jhist_block_mass.mma_launches
    got = jhist_block_mass(e, J, pending, block=block)
    again = jhist_block_mass(e, J, pending, block=block)
    torch.cuda.synchronize()
    assert jhist_block_mass.launches == n0 + 2
    assert jhist_block_mass.mma_launches == m0 + 2   # on the tensor cores
    assert torch.equal(got, again)                   # bit for bit
    ref = jhist_block_mass_ref(e, J, pending, block=block)
    assert got.shape == ref.shape == (Hf * g, NB)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
    assert (got[:, -2:] == ref[:, -2:]).all()        # empty rows exact
    _assert_same_blocks(got, ref, nc, g, block)


def test_jhist_block_mass_rejects_what_the_kernel_cannot_take(dev):
    e, J, pending, _ = _jhist_inputs(dev, 4, 4, 64, 10, 16, 3, 64)
    with pytest.raises(ValueError, match="power of two"):
        jhist_block_mass(e[..., :48].contiguous(),
                         J[..., :48 * 48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        jhist_block_mass(e, J[:, ::2])
    with pytest.raises(ValueError, match="int64"):
        pos, cp, rr = pending
        jhist_block_mass(e, J, (pos.int(), cp, rr), block=64)
    with pytest.raises(ValueError, match="one CUDA device"):
        jhist_block_mass(e, J.cpu())


def test_jhist_block_mass_replays_in_a_graph(dev):
    # captured once (one launch counted, at the capture), the kernel reads
    # new factors, counts and ring count in place at every replay: bit for
    # bit the eager launch's output
    e, J, pending, _ = _jhist_inputs(dev, 16, 4, 64, 40, 128, 50, 64)
    jhist_block_mass(e, J, pending, block=64)        # built, loaded
    torch.cuda.synchronize()
    n0 = jhist_block_mass.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = jhist_block_mass(e, J, pending, block=64)
    assert jhist_block_mass.launches == n0 + 1
    e2, J2, p2, _ = _jhist_inputs(dev, 16, 4, 64, 40, 128, 50, 64, seed=9)
    e.copy_(e2)
    J.copy_(J2)
    pending[2].fill_(17)
    for _ in range(3):
        graph.replay()
    eager = jhist_block_mass(e, J, pending, block=64)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    torch.testing.assert_close(
        out, jhist_block_mass_ref(e, J, pending, block=64), rtol=1e-5, atol=0)


def test_jhist_kernel_once_per_layer_per_replayed_step(dev):
    # the deferred-join batched decode: the scorer's one kernel per layer
    # per step, replayed and eager; inside the scorer's wrapper (a
    # pq_score scope within joint_block_mass's) that kernel and nothing
    # else: no f32 copy of the histogram, no GEMM, no one-hot correction
    import copy
    from pqcache_tpu_torch.harness import trace
    from pqcache_tpu_torch.runtime import stages
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    cfg, params, pol, state, tok, pos = _batched_setup(
        dev, "pq_search", dict(select_block=64, jhist_defer="on"))
    assert pol._jhist_defer(state)
    L = cfg.num_layers
    twin = copy.deepcopy(state)
    dec = BatchedDecoder(cfg, params, pol, state, chunk=12)
    res = trace.decompose_replayed(dec, tok, pos, steps=4)
    by_name = res["summary"]["by_name"]
    assert sum(n for k, n in by_name.items()
               if "jhist_mass_kernel" in k) == 4 * L, by_name
    eager = BatchedDecoder(cfg, params, pol, twin, chunk=12, graph=False)
    eager.begin(tok, pos)
    eager.step(eager=True)
    n0 = jhist_block_mass.launches
    with stages.recording(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eager.step(eager=True)
        torch.cuda.synchronize()
    assert jhist_block_mass.launches == n0 + L
    evs = prof.events()
    host = {ev.id: ev for ev in evs if ev.device_type ==
            torch.autograd.DeviceType.CPU and "Launch" in ev.name}
    in_scorer = []
    for ev in evs:
        if ev.device_type == torch.autograd.DeviceType.CPU or \
                ev.id not in host:
            continue
        p, names = host[ev.id], []
        while p is not None:
            names.append(p.name)
            p = p.cpu_parent
        if names.count("scope:pq_score") >= 2:
            in_scorer.append(ev.name)
    assert len(in_scorer) == L and all(
        "jhist_mass_kernel" in k for k in in_scorer), in_scorer


# -- DeepSeek-V2's latent attention (MLA) --------------------------------------
#
# K1's latent variant computes what its plain version does from the same bf16
# rows and queries, P entering the value product as bf16 hi + lo pairs (2^-17)
# and the splits merged in a fixed order, its f32 sums over ~26k rows in
# another order: the output to 1e-4 of its largest entry (K1's tolerance; the
# cell's shape reads 1.1e-5), m to 1e-5, l to 1e-5 relative, and two calls
# (eager or replayed) bitwise equal. K2's 192 / 128 variant is K2 (bf16 P, bf16 output): held as
# _check_flash holds K2, entry by entry at 2e-2 and each row to 1e-2 of its
# norm.

MLA_CELL = (40, 131840, 52, 256, 13104, 12976)   # the 128k MLA cell's layer


def _latent_inputs(dev, Hf, N, nb, bs, win_max, win_len, seed=0):
    """The latent tail [1, Hf, N, 576] and queries [16 Hf, 1, 576] in bf16,
    n_cand a little below N - win_max, the blocks drawn below it; head 1's
    n_cand 0 (no candidate) and, given three heads or more, head 2's first
    id out of range, which the plain version is handed as a block wholly
    at or past its n_cand."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kv = torch.randn((1, Hf, N, 576), generator=g, device=dev).bfloat16()
    q = (torch.randn((Hf * 16, 1, 576), generator=g, device=dev)
         * 0.5).bfloat16()
    n_cand = torch.full((Hf,), N - win_max - 3 * bs - 5, dtype=torch.int32,
                        device=dev)
    n_cand[1] = 0
    blk = torch.stack([torch.randperm(int(n_cand[0]) // bs, generator=g,
                                      device=dev)[:nb]
                       for _ in range(Hf)]).int()
    win = torch.full((Hf,), win_len, dtype=torch.int32, device=dev)
    bad, ref_blk = blk.clone(), blk.clone()
    if Hf > 2:
        bad[2, 0] = N // bs + 7
        ref_blk[2, 0] = (int(n_cand[2]) + bs - 1) // bs   # all masked rows
    return q, kv, bad, ref_blk, n_cand, win


def _assert_latent_close(got, ref):
    m, l, acc = got
    mr, lr, accr = ref
    assert torch.allclose(m, mr, atol=1e-5, rtol=0)
    assert ((l - lr).abs() <= 1e-5 * lr.abs()).all()
    out = acc / l.clamp(min=1e-30)[..., None]
    outr = accr / lr.clamp(min=1e-30)[..., None]
    assert (out - outr).abs().max() <= 1e-4 * outr.abs().max()


@pytest.mark.parametrize("shape", ["cell", "small"])
def test_latent_k1_matches_plain(dev, shape):
    from pqcache_tpu_torch.ops.block_attn import (
        block_topk_latent_attention, block_topk_latent_attention_ref)
    Hf, N, nb, bs, win_max, win_len = (MLA_CELL if shape == "cell"
                                       else (3, 4096, 5, 64, 300, 211))
    q, kv, blk, ref_blk, n_cand, win = _latent_inputs(
        dev, Hf, N, nb, bs, win_max, win_len)
    n0 = block_topk_latent_attention.launches
    got = block_topk_latent_attention(q, kv, 0, blk, n_cand, block=bs,
                                      v_dim=512, win_len=win,
                                      win_max=win_max)
    assert block_topk_latent_attention.launches == n0 + 1
    ref = block_topk_latent_attention_ref(q, kv, 0, ref_blk, n_cand,
                                          block=bs, v_dim=512, win_len=win,
                                          win_max=win_max)
    _assert_latent_close(got, ref)
    # n_cand 0 with no window row: no row at all
    lone = block_topk_latent_attention(q, kv, 0, blk, torch.zeros_like(
        n_cand), block=bs, v_dim=512, win_len=0, win_max=win_max)
    assert (lone[0] == -1e30).all() and (lone[1] == 0).all()
    assert (lone[2] == 0).all()
    again = block_topk_latent_attention(q, kv, 0, blk, n_cand, block=bs,
                                        v_dim=512, win_len=win,
                                        win_max=win_max)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_latent_k1_replays_in_a_graph(dev):
    from pqcache_tpu_torch.ops.block_attn import block_topk_latent_attention
    q, kv, blk, _, n_cand, win = _latent_inputs(dev, 8, 8192, 6, 256, 700,
                                                650, seed=1)

    def call():
        return block_topk_latent_attention(q, kv, 0, blk, n_cand, block=256,
                                           v_dim=512, win_len=win,
                                           win_max=700)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [t.clone() for t in call()]
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            out = call()
    torch.cuda.current_stream().wait_stream(side)
    n_cand += 3
    win -= 3
    g.replay()
    torch.cuda.synchronize()
    moved = call()
    assert all(torch.equal(a, b) for a, b in zip(out, moved))
    assert not torch.equal(out[2], eager[2])


def test_latent_k1_rejects_what_it_cannot_take(dev):
    from pqcache_tpu_torch.ops.block_attn import block_topk_latent_attention
    q, kv, blk, _, n_cand, _ = _latent_inputs(dev, 2, 1024, 2, 64, 0, 0)
    with pytest.raises(ValueError, match="unsupported shapes"):
        block_topk_latent_attention(q, kv, 0, blk, n_cand, block=64,
                                    v_dim=256)
    with pytest.raises(ValueError, match="unsupported shapes"):
        block_topk_latent_attention(q[:16], kv, 0, blk, n_cand, block=64,
                                    v_dim=512)
    with pytest.raises(TypeError):
        block_topk_latent_attention(q.float(), kv, 0, blk, n_cand, block=64,
                                    v_dim=512)


@pytest.mark.parametrize("q_offset,Tq", [(0, 32768), (98304, 32768),
                                         (1000, 777)])
def test_k2_mla_192_128_on_the_prefill_slabs(dev, q_offset, Tq):
    # the 128k MLA cell's prefill: 16 expanded heads, a slab of 32768 rows
    # against the keys before it (131072 at the last slab), the cell's scale
    H, Tk = 16, q_offset + Tq
    g = torch.Generator(device=dev).manual_seed(Tq + q_offset)
    q = torch.randn((H, Tq, 192), generator=g, device=dev).bfloat16()
    k = torch.randn((H, Tk, 192), generator=g, device=dev).bfloat16()
    v = torch.randn((H, Tk, 128), generator=g, device=dev).bfloat16()
    sc = 192 ** -0.5 * 1.5896
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, valid_lo=0, causal=True,
                          q_offset=q_offset, scale=sc)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1 and out.shape == (H, Tq, 128)
    rows = torch.arange(0, Tq, 97 if Tq > 4096 else 1, device=dev)
    ref = chunked_attention(q[:, rows[0]:], k, v, causal=True,
                            q_offset=q_offset + int(rows[0]),
                            scale=sc) if Tq <= 4096 else None
    if ref is None:
        # every 97th row, from dense f32 logits
        s = torch.einsum("hqd,hkd->hqk", q[:, rows].float(), k.float()) * sc
        kp = torch.arange(Tk, device=dev)
        s = torch.where(kp[None, None] <= (q_offset + rows)[None, :, None],
                        s, -torch.inf)
        ref = torch.softmax(s, -1) @ v.float()
    got = out[:, rows].float()
    torch.testing.assert_close(got, ref.float(), rtol=2e-2, atol=2e-2)
    err = (got - ref.float()).norm(dim=-1)
    assert (err / ref.float().norm(dim=-1)).max() <= 1e-2


def test_jhist_kernel_at_16_heads(dev):
    # the MLA cell's layer: 40 slots of one latent kv head, 16 heads, C 64
    g = torch.Generator(device=dev).manual_seed(16)
    Hf, NB, C, K = 40, 514, 64, 128
    e = torch.rand((Hf * 16, 2, C), generator=g, device=dev)
    J = torch.randint(0, 256, (Hf, NB, C * C), generator=g, device=dev,
                      dtype=torch.uint8)
    pend = (torch.randint(0, NB * 256, (Hf, K), generator=g, device=dev),
            torch.randint(0, C, (Hf, 2, K), generator=g, device=dev),
            torch.tensor(77, dtype=torch.int32, device=dev))
    got = jhist_block_mass(e, J, pend, block=256)
    ref = jhist_block_mass_ref(e, J, pend, block=256)
    assert ((got - ref).abs() <= 1e-5 * ref.abs()).all()
    assert torch.equal(got, jhist_block_mass(e, J, pend, block=256))
    with pytest.raises(ValueError, match="C >= 16"):
        jhist_block_mass(torch.rand((3 * 16, 2, 8), device=dev),
                         torch.zeros((3, 4, 64), dtype=torch.uint8,
                                     device=dev))


def test_deepseek_replayed_step_is_the_eager_step(dev):
    # the model at MLA's published head widths (two layers, a smaller
    # hidden size and fewer experts): a chunk replayed from the CUDA graph
    # gives the eager chunk's tokens and state, the latent K1 and the
    # 16-head scorer on the path
    from pqcache_tpu_torch.config import (BudgetConfig, DeepseekV2Config,
                                          EngineConfig, PQConfig,
                                          RuntimeConfig)
    from pqcache_tpu_torch.models import deepseek_v2
    from pqcache_tpu_torch.ops.block_attn import block_topk_latent_attention
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    cfg = DeepseekV2Config(
        name="card-dsv2", vocab_size=4096, hidden_size=512,
        intermediate_size=1024, num_layers=2, num_heads=16, num_kv_heads=1,
        head_dim=576, rms_norm_eps=1e-6, max_position_embeddings=8192,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, first_k_dense_replace=1, num_experts=16,
        num_experts_per_tok=6, moe_intermediate_size=256,
        num_shared_experts=2, yarn_factor=40.0, yarn_mscale=0.707,
        yarn_mscale_all_dim=0.707)
    params = deepseek_v2.init_params(cfg, torch.Generator(device=dev)
                                     .manual_seed(0), torch.bfloat16, dev)
    ecfg = EngineConfig(model=cfg, pq=PQConfig(select_block=64, ring_cap=16),
                        budget=BudgetConfig(),
                        runtime=RuntimeConfig(policy="pq_search",
                                              max_new_tokens=32))
    P = 4096
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, 32), dev)
    assert pol.latent and pol.use_jhist
    st = pol.init_state()
    prompt = torch.randint(0, cfg.vocab_size, (P,), device=dev)
    deepseek_v2.prefill_chunked(cfg, params, pol, st, prompt, 0, P,
                                chunk=2048)
    n0 = block_topk_latent_attention.launches
    outs, states = [], []
    for graph in (True, False):
        bs = pol.init_batched_state(8)
        for s in range(8):
            pol.insert_slot(bs, st, s)
        dec = BatchedDecoder(cfg, params, pol, bs, graph=graph, device=dev)
        outs.append(dec.generate(torch.arange(8, dtype=torch.int32,
                                              device=dev),
                                 torch.full((8,), P, dtype=torch.int32,
                                            device=dev), 32))
        states.append(bs)
    assert block_topk_latent_attention.launches > n0
    assert torch.equal(outs[0], outs[1])
    for f in ("kv_tail", "codes", "jhist", "n_cand", "pos"):
        assert torch.equal(getattr(states[0], f), getattr(states[1], f)), f
