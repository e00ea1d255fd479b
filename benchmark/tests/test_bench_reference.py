"""The plain reference against the port at toy widths on the CPU, and the
comparison that decides ``correct`` against the faults a decode cell can
have and against its control."""

import numpy as np
import pytest
import torch

from benchmark import calibrate, weights
from benchmark.drivers import decode_turns
from benchmark.reference.pqcache import Reference, kmeans
from benchmark.tests import tiny

SEEDS = (1, 2, 3)
FORMATS = pytest.mark.parametrize("int8", (False, True),
                                  ids=("bf16", "int8"))


def test_kmeans_is_the_ports():
    # the same draws, the same Lloyd steps: the port's k-means on the same
    # points gives the same codebooks and codes
    from pqcache_tpu_torch.core import pq
    x = torch.randn(4, 700, 8, generator=torch.Generator().manual_seed(0))
    cent, codes = kmeans(x, 16, 3, 4321)
    want = pq.kmeans(x, 16, iters=3, valid_len=700,
                     generator=torch.Generator().manual_seed(4321))
    assert torch.allclose(cent, want.centroids, atol=1e-5)
    assert torch.equal(codes, want.codes)


def test_reference_follows_the_ports_first_step():
    # with the port's codebooks and codes, the reference's first decode
    # step gives the port's logits to within bf16 rounding
    from pqcache_tpu_torch.models import llama
    wl = tiny.cell()
    seed = 4
    prog = decode_turns.Program(wl, seed, torch.device("cpu"), False)
    B, P = wl["batch"], wl["prompt_tokens"]
    first = np.arange(1, B + 1)
    prog.reset()
    got = llama.decode_step_batched(
        prog.model, prog.params, prog.policy, prog.bstate,
        torch.as_tensor(first, dtype=torch.int32),
        torch.full((B,), P, dtype=torch.int32))
    ref = Reference(wl, weights.draw(wl["model"], seed, "cpu"), "cpu")
    ref.prefill(prog.ids, prog.state.centroids.float(), prog.state.codes)
    gaps, best = ref.decode(first[:, None], [got.argmax(-1)[:, None]])
    assert np.array_equal(best[:, 0], got.argmax(-1).numpy())
    assert gaps[0].max() == 0.0
    assert decode_turns.code_mismatch(ref, prog.state.codes) < 0.01


@pytest.mark.parametrize("seed", (3, 5))
def test_reference_is_the_ports_decode_in_float32(seed):
    # the port in float32 (weights, states, no rounding anywhere) through a
    # whole turn, flushes of the ring included: the reference in its f32
    # mode, on the port's codebooks and codes, gives the same logits
    from pqcache_tpu_torch.models import llama
    from pqcache_tpu_torch.policies.base import get_policy
    wl = tiny.cell()
    cfg, budget = decode_turns.engine_config(wl)
    pol = get_policy(cfg, budget, "cpu")
    w = weights.draw(wl["model"], seed, "cpu")
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float()) for k, v in w.items()}
    P, B, T, ch = (wl["prompt_tokens"], wl["batch"], wl["turn_tokens"],
                   wl["chunk"])
    ids = np.random.default_rng(seed).integers(0, cfg.model.vocab_size, P)
    st = pol.init_state(torch.float32)
    llama.prefill(cfg.model, p32, pol, st, torch.from_numpy(ids), 0, P)
    bs = pol.init_batched_state(B, torch.float32)
    for s in range(B):
        pol.insert_slot(bs, st, s)
    tok = torch.arange(5, 5 + B, dtype=torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32)
    got, inputs = [], []
    for j in range(T):
        inputs.append(tok.numpy().copy())
        logits = llama.decode_step_batched(cfg.model, p32, pol, bs, tok,
                                           pos + j)
        got.append(logits)
        tok = logits.argmax(-1).int()
        if (j + 1) % ch == 0:
            pol.flush_ring_batched(bs)
    ref = Reference(wl, w, "cpu", "f32")
    ref.prefill(ids, st.centroids, st.codes)
    keep = []
    ref.decode(np.stack(inputs, 1), [], keep=keep)
    assert max(float((a - b).abs().max()) for a, b in zip(keep, got)) < 1e-4


@FORMATS
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(seed, int8):
    res = tiny.run(seed, int8=int8)
    assert all(c["ok"] for c in res["checks"]), res["checks"]


@pytest.fixture
def token_altered(monkeypatch):
    # every decode step serves its second-best token
    from pqcache_tpu_torch.models import llama
    orig = llama.decode_step_batched

    def altered(*a, **k):
        logits = orig(*a, **k)
        return logits.scatter(-1, logits.argmax(-1, keepdim=True), -1e30)
    monkeypatch.setattr(llama, "decode_step_batched", altered)


@pytest.fixture
def state_unchanged(monkeypatch):
    # a step leaves the decode state as it found it: no append, no count
    from pqcache_tpu_torch.policies.pq_search import PQSearchPolicy
    for name in ("commit_appends_batched", "shared_post_batched",
                 "flush_ring_batched"):
        monkeypatch.setattr(PQSearchPolicy, name, lambda *a, **k: None)


@pytest.fixture
def kmeans_cut_short(monkeypatch):
    # the codebooks are k-means++'s seeds: no Lloyd step is run
    from pqcache_tpu_torch.core import pq
    orig = pq.kmeans
    monkeypatch.setattr(pq, "kmeans",
                        lambda *a, **k: orig(*a, **dict(k, iters=0)))


@pytest.fixture
def centroids_perturbed(monkeypatch):
    # every centroid moved by noise of a tenth of the centroids' spread;
    # the codes are those of the trained codebook
    from pqcache_tpu_torch.core import pq
    orig = pq.kmeans

    def noisy(*a, **k):
        r = orig(*a, **k)
        c = r.centroids
        g = torch.Generator().manual_seed(7)
        return r._replace(centroids=c + 0.1 * c.std() * torch.randn(
            c.shape, generator=g))
    monkeypatch.setattr(pq, "kmeans", noisy)


@FORMATS
@pytest.mark.parametrize("seed", SEEDS)
def test_kmeans_cut_short_is_not_correct(kmeans_cut_short, seed, int8):
    c = tiny.checks(tiny.run(seed, int8=int8))
    assert not c["codebook_excess"]["ok"]


@FORMATS
@pytest.mark.parametrize("seed", SEEDS)
def test_centroids_perturbed_is_not_correct(centroids_perturbed, seed, int8):
    c = tiny.checks(tiny.run(seed, int8=int8))
    assert not c["codebook_excess"]["ok"]


@FORMATS
@pytest.mark.parametrize("seed", SEEDS)
def test_token_altered_is_not_correct(token_altered, seed, int8):
    c = tiny.checks(tiny.run(seed, int8=int8))
    assert not c["logit_gap"]["ok"]


@FORMATS
@pytest.mark.parametrize("seed", SEEDS)
def test_state_unchanged_is_not_correct(state_unchanged, seed, int8):
    c = tiny.checks(tiny.run(seed, int8=int8))
    assert not c["logit_gap"]["ok"]


@FORMATS
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_the_limits(seed, int8):
    # the reference in the port's place, one format below the stated one
    wl = tiny.cell(int8)
    r = calibrate.readings(wl, seed, torch.device("cpu"), True)
    assert r["correct"]
    assert not r["control_correct"]
    # the codebooks alone: fit to fp8 or int4 keys
    assert r["control_codebook_excess"] > wl["limits"]["codebook_excess"]
