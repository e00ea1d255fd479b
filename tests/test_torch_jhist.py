"""The joint-histogram block scorer's wrapper (``ops/jhist.py``) on the CPU.

On a CPU tensor the wrapper computes its plain version. It is held to the
scorer's definition in float64 (the factored double sum over the uint8
counts plus the live pending joins' terms) and to the arithmetic the
policy ran before the scorer had a kernel: ``core/pq.joint_block_mass``'s
pair table against an f32 copy of the histogram, plus the one-hot product
of the deferred-join correction. The kernel's exact arithmetic on the
tensor cores rests on two facts held here: a count byte read as bf16 bits
is the count times 2^-133, and ``split_factors`` cuts every factor into
three bf16 pieces that sum back to it exactly. The CUDA kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py -k
jhist``).
"""

import numpy as np
import pytest
import torch

from pqcache_tpu_torch import config
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.ops.jhist import (FACTOR_SCALE, jhist_block_mass,
                                         split_factors)
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.state import per_head

torch.set_num_threads(1)
BLOCK, K = 16, 40           # pending joins per folded kv head


def _mass_before(lut, J, head_dim, pending=None, block=BLOCK):
    """The raw block mass as the policy computed it before the kernel:
    the [g, C^2] pair table times an f32 copy of the histogram, plus the
    pending joins' one-hot product."""
    H, _, C = lut.shape
    H_kv, NB, _ = J.shape
    g = H // H_kv
    e = pq.jhist_exp_lut(lut, head_dim)
    pair = (e[:, 0, :, None] * e[:, 1, None, :]).reshape(H_kv, g, C * C)
    mass = torch.bmm(pair, J.float().transpose(1, 2)).reshape(H, -1)
    if pending is None:
        return mass
    pos, cp, ring_r = pending
    ok = torch.arange(pos.shape[1]) < ring_r
    c = per_head(cp, g)
    val = torch.where(ok, e[:, 0].gather(1, c[:, 0])
                      * e[:, 1].gather(1, c[:, 1]), 0.0)
    cols = per_head(torch.div(pos, block, rounding_mode="floor").clamp(
        0, NB - 1), g)
    onehot = (cols[..., None] == torch.arange(NB)).float()
    return mass + torch.bmm(val[:, None, :], onehot)[:, 0]


def _mass_f64(e, J, pending=None, block=BLOCK):
    """The scorer's definition in float64, term by term."""
    H, _, C = e.shape
    H_kv, NB, _ = J.shape
    g = H // H_kv
    e = e.double()
    Jh = per_head(J.double(), g).reshape(H, NB, C, C)
    mass = torch.einsum("hc,hd,hncd->hn", e[:, 0], e[:, 1], Jh)
    if pending is not None:
        pos, cp, ring_r = pending
        for h in range(H):
            for t in range(int(ring_r)):
                n = min(max(int(pos[h // g, t]) // block, 0), NB - 1)
                mass[h, n] += (e[h, 0, int(cp[h // g, 0, t])]
                               * e[h, 1, int(cp[h // g, 1, t])])
    return mass


def _case(C, g, NB, ring_r, seed=0, H_kv=3):
    """lut, a histogram with saturated counts, and a pending span that
    crosses a block boundary (or None)."""
    rng = np.random.default_rng(seed)
    lut = torch.from_numpy(rng.normal(0.0, 4.0, (H_kv * g, 2, C))).float()
    J = torch.from_numpy(rng.integers(0, 4, (H_kv, NB, C * C),
                                      dtype=np.uint8))
    J[:, ::3, ::7] = 255                  # saturated counts
    J[:, -1] = 0                          # a row past every candidate
    if ring_r is None:
        return lut, J, None
    # each head's span starts a few tokens before a block boundary, one
    # head's at the last block (its tail positions clamp into it)
    start = torch.tensor([BLOCK * (NB // 2) - 5, BLOCK - 3,
                          BLOCK * NB - 2])[:H_kv]
    pos = start[:, None] + torch.arange(K)
    cp = torch.from_numpy(rng.integers(0, C, (H_kv, 2, K)))
    return lut, J, (pos, cp, torch.tensor(ring_r, dtype=torch.int32))


@pytest.mark.parametrize("ring_r", [None, 0, 1, K],
                         ids=["no-pending", "ring0", "ring1", "ringK"])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("C", [16, 64, 256])
def test_wrapper_matches_scorer_before_and_definition(C, g, ring_r):
    # NB 13 is a multiple of no tile; the pending span crosses a boundary
    D = 64
    lut, J, pending = _case(C, g, 13, ring_r)
    n0 = jhist_block_mass.launches
    e = pq.jhist_exp_lut(lut, D)
    got = jhist_block_mass(e, J, pending, block=BLOCK)
    assert jhist_block_mass.launches == n0     # the plain version, no launch
    assert got.shape == (lut.shape[0], 13) and got.dtype == torch.float32
    before = _mass_before(lut, J, D, pending)
    np.testing.assert_allclose(got.numpy(), before.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.double().numpy(),
                               _mass_f64(e, J, pending).numpy(), rtol=1e-5)
    # the normalised mass through core/pq, on both routes
    for kernel in (True, False):
        norm = pq.joint_block_mass(lut, J, head_dim=D, pending=pending,
                                   block=BLOCK, kernel=kernel)
        np.testing.assert_allclose(
            norm.numpy(), (before / before.sum(-1, keepdim=True)).numpy(),
            rtol=1e-5)


def test_wrapper_raises_outside_its_limits():
    lut, J, pending = _case(16, 4, 5, 1)
    e = pq.jhist_exp_lut(lut, 64)
    with pytest.raises(ValueError, match="C > 256"):
        jhist_block_mass(torch.ones(1, 2, 512), torch.zeros(
            1, 1, 512 * 512, dtype=torch.uint8))
    with pytest.raises(ValueError, match="at most 16"):
        jhist_block_mass(torch.ones(17 * 3, 2, 16), J)
    with pytest.raises(TypeError, match="uint8"):
        jhist_block_mass(e, J.float())
    with pytest.raises(ValueError, match="block 512"):
        jhist_block_mass(e, J, pending, block=512)


def test_count_bytes_read_as_bf16_are_exact():
    # the kernel's A operand: a byte zero-extended to 16 bits, read as a
    # bf16, is b 2^-133 for every count (subnormal below 128)
    b = torch.arange(256, dtype=torch.int16)
    got = b.view(torch.bfloat16).double()
    assert torch.equal(got, b.double() * 2.0 ** -133)


def _factors(spread: float, seed: int) -> torch.Tensor:
    """Exp-LUT factors whose logits spread over `spread` (as
    jhist_exp_lut's exponent), from 1 down past f32's smallest subnormal,
    with 0, 1 and the edges of the subnormal range appended."""
    rng = np.random.default_rng(seed)
    lut = torch.from_numpy(-rng.random((64, 2, 64)) * spread
                           * 128 ** 0.5).float()
    e = pq.jhist_exp_lut(lut, 128).reshape(-1)
    tiny = torch.finfo(torch.float32).tiny
    edges = torch.tensor([0.0, 1.0, 1 - 2 ** -24, tiny, tiny * (1 - 2 ** -23),
                          2.0 ** -149, 2.0 ** -126 * 3, 1e-30])
    return torch.cat([e, edges])


@pytest.mark.parametrize("spread", [4.0, 70.0, 110.0])
def test_split_factors_sum_back_exactly(spread):
    e = _factors(spread, int(spread))
    assert e.min() == 0 and (e[e > 0].min() < 2 ** -126 or spread < 100)
    p = split_factors(e)
    assert p.shape == (3,) + e.shape and p.dtype == torch.bfloat16
    assert torch.equal(p.double().sum(0), e.double() * FACTOR_SCALE)


@pytest.mark.parametrize("spread", [4.0, 110.0])
def test_split_factor_pieces_are_normal_bf16s(spread):
    # every nonzero piece is a normal bf16 holding at most 8 significant
    # bits, so a count (8 bits) times a piece is exact in the MMA; for a
    # factor >= 2^-119 the count 1 times its top piece, 2^-133 hi, is a
    # normal f32, so the kernel's sums T (2^-7 of the true ones) are too
    e = _factors(spread, 7)
    p = split_factors(e).double()
    nz = p[p != 0]
    assert (nz.abs() >= 2.0 ** -126).all()
    lead = torch.floor(torch.log2(nz))
    assert torch.equal(torch.frac(nz * 2 ** (7 - lead)), torch.zeros_like(nz))
    big = e.double() >= 2.0 ** -119
    assert (p[0][big] * 2.0 ** -133 >= 2.0 ** -126).all()


def _decoding_state(defer: str, steps: int = 3):
    """A 2-layer policy and its batched state of 3 slots that decoded
    ``steps`` tokens since the last flush (the ring holds them; deferred,
    the histogram does not count them yet)."""
    P = 256
    ecfg = config.EngineConfig(
        model=config.tiny_model_config(num_heads=8, num_kv_heads=2),
        pq=config.PQConfig(n_subvec_per_head=2, n_subbits=4, kmeans_iters=4,
                           select_block=BLOCK, jhist_defer=defer),
        budget=config.BudgetConfig(compress_ratio=0.3, recent_ratio=0.5,
                                   sink_size=4),
        runtime=config.RuntimeConfig(prefill_bucket=64, max_new_tokens=24,
                                     max_seq_len=512))
    params = llama.init_params(ecfg.model, torch.Generator().manual_seed(3),
                               dtype=torch.float32, device="cpu")
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P,
                                          ecfg.runtime.max_new_tokens),
                     device="cpu")
    rng = np.random.default_rng(11)
    state = pol.init_batched_state(3, torch.float32)
    first = []
    for slot, n in enumerate((P, 241, 230)):
        ids = torch.zeros(P, dtype=torch.long)
        ids[P - n:] = torch.from_numpy(
            rng.integers(0, ecfg.model.vocab_size, size=n))
        st = pol.init_state(torch.float32)
        logits = llama.prefill(ecfg.model, params, pol, st, ids, P - n, n)
        pol.insert_slot(state, st, slot)
        first.append(int(torch.argmax(logits)))
    tok, pos = torch.tensor(first), torch.tensor([P, 241, 230])
    for _ in range(steps):
        logits = llama.decode_step_batched(ecfg.model, params, pol, state,
                                           tok, pos)
        tok, pos = torch.argmax(logits, -1), pos + 1
    return pol, state


@pytest.mark.parametrize("defer", ["on", "off"])
def test_select_blocks_picks_the_blocks_it_picked_before(defer):
    pol, state = _decoding_state(defer)
    assert pol._jhist_defer(state) == (defer == "on")
    assert int(state.ring_r) == 3
    n_cand_h = per_head(state.n_cand, pol.H_kv)
    gen = torch.Generator().manual_seed(5)
    for idx in range(state.jhist.shape[0]):
        q = torch.randn(n_cand_h.shape[0] * pol.group, pol.D, generator=gen)
        lut = pq.adc_lut(q, state.centroids[idx], pol.S, pol.metric)
        pending = None
        if defer == "on":
            pending = pol._pending_span(state, n_cand_h, idx) + (
                state.ring_r,)
        got = pol._select_blocks(state, idx, lut, n_cand_h,
                                 slot_counts=state.n_cand, pending=pending)
        raw = _mass_before(lut, state.jhist[idx], pol.D, pending)
        want = pq.topk_from_block_mass(
            raw / torch.clamp(raw.sum(-1, keepdim=True), min=1e-30),
            n_cand_h, pol.budget.topk, group=pol.group,
            block=pol.select_block)
        assert torch.equal(got, torch.sort(want, -1).values), idx
