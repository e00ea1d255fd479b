"""pq_search's non-default branches in the port against the JAX package.

On the CPU, float32 on both sides: the "ip" metric (the MIPS-to-L2 lift,
its LUT and selections; single-sequence per-token and block paths, int8
tails, the batch-as-heads decode, the offload engine), gqa=False (per-q-head
retrieval) and fetch_mode="masked" (thresholded attention over the whole
tail), bf16 and int8 tails. Decode starts from the JAX prefill state
transplanted through ``bridge`` (phi included), since the port's k-means++
draws from torch; where a test runs the port's own prefill, its k-means
starts from JAX's k-means++ seeds of the same points. The JAX side runs its
XLA route; the port both of its routes (``kernels="xla"`` and the kernel
wrappers, which take their plain versions on a CPU tensor), adc_mode "v1"
(JAX's XLA route sums the f32 LUT) and exact top-k. Selections must be
identical, attention outputs within 1e-5 and logits within 1e-4 (the same
float32 arithmetic in another summation order), greedy tokens identical,
codes bit for bit. ``torch.set_num_threads(1)``: the suite runs with
several workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu import config as jconfig
from pqcache_tpu.core import pq as jpq
from pqcache_tpu.core.budget import compute_budget as jcompute_budget
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.policies.base import get_policy as jget_policy
from pqcache_tpu.runtime.generate import Engine as JEngine
from pqcache_tpu.runtime.offload_engine import OffloadEngine as JOffload
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
from pqcache_tpu_torch.runtime.generate import Engine
from pqcache_tpu_torch.runtime.offload_engine import OffloadEngine

torch.set_num_threads(1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
N_STEPS = 12


# ---------------------------------------------------------------------------
# the ip core functions

@pytest.mark.parametrize("n_valid", ["scalar", "per_head"])
def test_ip_core_matches_jax(n_valid):
    rng = np.random.default_rng(0)
    H_kv, g, S, d, C, T, block = 2, 2, 2, 8, 16, 256, 16
    H = H_kv * g
    x = rng.normal(size=(H_kv * S, T, d)).astype(np.float32)
    jl, jphi = jpq.ip2l2_lift(jnp.asarray(x), jnp.asarray(200))
    tl, tphi = pq.ip2l2_lift(torch.from_numpy(x), 200)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), **OUT_TOL)
    new = x[:, :3]
    np.testing.assert_allclose(
        pq.ip2l2_lift_with_phi(torch.from_numpy(new), tphi).numpy(),
        np.asarray(jpq.ip2l2_lift_with_phi(jnp.asarray(new), jphi)),
        **OUT_TOL)
    q = rng.normal(size=(H, S, d)).astype(np.float32)
    np.testing.assert_array_equal(
        pq.lift_query(torch.from_numpy(q)).numpy(),
        np.asarray(jpq.lift_query(jnp.asarray(q))))
    cent = rng.normal(size=(H_kv, S, C, d + 1)).astype(np.float32)
    jlut = jpq.adc_lut_ip(jpq.lift_query(jnp.asarray(q)), jnp.asarray(cent))
    tlut = pq.adc_lut_ip(pq.lift_query(torch.from_numpy(q)),
                         torch.from_numpy(cent))
    np.testing.assert_allclose(tlut.numpy(), np.asarray(jlut), **OUT_TOL)
    codes = rng.integers(0, C, size=(H_kv, S, T)).astype(np.uint8)
    # the same scores on both sides (the LUT's last-ulp differences would
    # reorder near ties); integer-valued scores tie often
    scores = np.round(np.asarray(jpq.adc_gather_scores(
        jlut, jnp.asarray(codes))))
    nv = 200 if n_valid == "scalar" else np.array([200, 131])
    jn = jnp.asarray(nv, jnp.int32)
    tn = 200 if n_valid == "scalar" else torch.from_numpy(nv)
    ts = torch.from_numpy(scores)
    jg = jpq.group_scores(jnp.asarray(scores), jn, group=g, head_dim=d,
                          metric="ip")
    tg = pq.group_scores(ts, tn, group=g, head_dim=d, metric="ip")
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    ji, jsum = jpq.mips_topk(jnp.asarray(scores), jn, 40, group=g,
                             head_dim=d, metric="ip")
    ti, tsum = pq.mips_topk(ts, tn, 40, group=g, head_dim=d, metric="ip")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tsum.numpy(), np.asarray(jsum))
    jb, _ = jpq.mips_topk_blocks(jnp.asarray(scores), jn, 40, group=g,
                                 head_dim=d, block=block, metric="ip",
                                 approx=False)
    tb, _ = pq.mips_topk_blocks(ts, tn, 40, group=g, head_dim=d,
                                block=block, metric="ip")
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    with pytest.raises(ValueError):
        pq.mips_topk(ts, tn, 4, group=g, head_dim=d, metric="cos")


def _mixture_keys(rng, H_kv, T, D, n_modes=32):
    modes = rng.normal(size=(H_kv, n_modes, D)).astype(np.float32) * 2.0
    which = rng.integers(0, n_modes, size=(H_kv, T))
    noise = rng.normal(size=(H_kv, T, D)).astype(np.float32) * 0.7
    return np.take_along_axis(modes, which[..., None], axis=1) + noise


@pytest.mark.parametrize("metric", ["euc", "ip"])
def test_port_recall_at_paper_operating_point(metric):
    # tests/test_recall.py's case (S 2, 64 centroids, top 1/5, its keys and
    # thresholds) through the port's lift, Lloyd iterations, LUT and
    # selection, from the JAX test's k-means++ seeds: the port must reach
    # the JAX pipeline's recall
    rng = np.random.default_rng(0)
    H_kv, group, T, D, S, C = 2, 2, 2048, 128, 2, 64
    H = H_kv * group
    d_sub = D // S
    keys_np = _mixture_keys(rng, H_kv, T, D)
    queries_np = rng.normal(size=(H, D)).astype(np.float32)
    keys, queries = torch.from_numpy(keys_np), torch.from_numpy(queries_np)
    xb = (keys.reshape(H_kv, T, S, d_sub).transpose(1, 2)
          .reshape(H_kv * S, T, d_sub))
    jxb = jnp.asarray(xb.numpy())
    if metric == "ip":
        xb, _ = pq.ip2l2_lift(xb)
        jxb, _ = jpq.ip2l2_lift(jxb)
    j0 = jpq.kmeans(jxb, C, iters=0, seed=0)
    jres = jpq.kmeans(jxb, C, iters=12, seed=0)
    res = pq.kmeans(xb, C, iters=12, init_centroids=torch.from_numpy(
        np.array(j0.centroids)))
    cent = res.centroids.reshape(H_kv, S, C, -1)
    codes = res.codes.reshape(H_kv, S, T)
    q_sub = queries.reshape(H, S, d_sub)
    lut = (pq.adc_lut_ip(pq.lift_query(q_sub), cent) if metric == "ip"
           else pq.adc_lut_euc(q_sub, cent))
    k = T // 5
    idx, _ = pq.mips_topk(pq.adc_gather_scores(lut, codes), T, k,
                          group=group, head_dim=D, metric=metric)
    exact = pq.exact_topk(queries, keys, T, k, group=group)
    r = pq.topk_recall(idx, exact, group=group)
    ex_scores = torch.einsum("hd,htd->ht", queries,
                             keys.repeat_interleave(group, 0))
    ceil_idx, _ = pq.mips_topk(ex_scores, T, k, group=group, head_dim=D)
    ceiling = pq.topk_recall(ceil_idx, exact, group=group)
    assert r > 0.8 * ceiling, f"{metric}: recall {r} vs ceiling {ceiling}"
    assert r > 0.4, f"{metric} absolute recall {r}"
    # the JAX pipeline on the same inputs
    jq = jnp.asarray(queries_np.reshape(H, S, d_sub))
    jcent = jres.centroids.reshape(H_kv, S, C, -1)
    jlut = (jpq.adc_lut_ip(jpq.lift_query(jq), jcent) if metric == "ip"
            else jpq.adc_lut_euc(jq, jcent))
    jidx, _ = jpq.mips_topk(jpq.adc_gather_scores(
        jlut, jres.codes.reshape(H_kv, S, T)), jnp.asarray(T), k,
        group=group, head_dim=D, metric=metric)
    jr = float(jpq.topk_recall(jidx, jnp.asarray(exact.numpy()),
                               group=group))
    assert abs(r - jr) <= 0.01, (r, jr)


# ---------------------------------------------------------------------------
# one layer's decode from a transplanted JAX state: selections and outputs

def _ecfgs(metric="euc", select_block=1, kv="bf16", gqa=True,
           fetch="gather", layers=2, kernels="xla", **kw):
    pq_kw = dict(n_subvec_per_head=2, n_subbits=4, kmeans_iters=4,
                 select_block=select_block, metric=metric, adc_mode="v1",
                 approx_topk=False, fetch_mode=fetch)

    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=layers),
            pq=mod.PQConfig(**pq_kw),
            budget=mod.BudgetConfig(compress_ratio=0.3, recent_ratio=0.5,
                                    sink_size=4),
            cache=mod.CacheConfig(kv_dtype=kv),
            runtime=mod.RuntimeConfig(**dict(
                dict(policy="pq_search", prefill_bucket=64,
                     max_new_tokens=32, max_seq_len=2048, gqa=gqa,
                     kernels=kernels), **kw)))
    return build(jconfig), build(config)


def _with_kernels(ecfg, kernels):
    return dataclasses.replace(ecfg, runtime=dataclasses.replace(
        ecfg.runtime, kernels=kernels))


# (metric, select_block, kv tail, gqa, fetch)
BRANCHES = [
    ("ip", 1, "bf16", True, "gather"), ("ip", 1, "int8", True, "gather"),
    ("ip", 16, "bf16", True, "gather"), ("ip", 16, "int8", True, "gather"),
    ("euc", 1, "bf16", False, "gather"), ("ip", 1, "int8", False, "gather"),
    ("euc", 1, "bf16", True, "masked"), ("euc", 1, "int8", True, "masked"),
    ("ip", 1, "bf16", True, "masked"), ("euc", 16, "bf16", True, "masked"),
]


def _branch_id(c):
    metric, sb, kv, gqa, fetch = c
    return "-".join([metric, "token" if sb == 1 else f"block{sb}", kv]
                    + (["nogqa"] if not gqa else [])
                    + (["masked"] if fetch == "masked" else []))


class _Record:
    """Records the first output (the selection) of the named selection
    functions of a pq module while active."""

    def __init__(self, mod, names=("mips_topk", "mips_topk_blocks")):
        self.mod, self.names, self.seen = mod, names, []

    def __enter__(self):
        self._orig = {n: getattr(self.mod, n) for n in self.names}
        for n, fn in self._orig.items():
            def rec(*a, _fn=fn, **kw):
                out = _fn(*a, **kw)
                self.seen.append(np.sort(np.asarray(out[0]), -1))
                return out
            setattr(self.mod, n, rec)
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self.mod, n, fn)


@pytest.mark.parametrize("case", BRANCHES,
                         ids=[_branch_id(c) for c in BRANCHES])
def test_branch_layer_decode_matches_jax(case):
    metric, sb, kv, gqa, fetch = case
    jecfg, ecfg = _ecfgs(metric, sb, kv, gqa, fetch, layers=1)
    P, pad, new = 512, 40, 6
    m = ecfg.model
    H, H_kv, D = m.num_heads, m.num_kv_heads, m.head_dim
    jpol = jget_policy(jecfg, jcompute_budget(jecfg.budget, P, 32))
    rng = np.random.default_rng(5)
    rand = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, k, v = rand(H, P, D), rand(H_kv, P, D), rand(H_kv, P, D)
    _, jstate = jpol.prefill_attn(
        jpol.init_state(jnp.float32), jnp.asarray(0), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad), jnp.asarray(P))
    assert jpol.deferred_appends == (gqa and fetch == "gather")
    if metric == "ip":
        assert float(np.asarray(jstate.phi).min()) > 0
    for kernels in ("xla", "auto"):
        pol = get_policy(_with_kernels(ecfg, kernels),
                         compute_budget(ecfg.budget, P, 32), device="cpu")
        assert pol.deferred_appends == jpol.deferred_appends
        assert not pol.use_jhist and not pol.fused_blockscore
        js = jstate
        state = bridge.pq_state_from_numpy(jax.tree.map(np.asarray, js),
                                           device="cpu")
        step_rng = np.random.default_rng(6)
        for i in range(new):
            qs, ks, vs = (step_rng.normal(size=s).astype(np.float32)
                          for s in ((H, 1, D), (H_kv, 1, D), (H_kv, 1, D)))
            shared = jpol.shared_pre(js)
            with _Record(jpq) as jrec:
                jout, res = jpol.decode_attn(js, jnp.asarray(0),
                                             *map(jnp.asarray, (qs, ks, vs)),
                                             shared)
            js = (jpol.commit_appends(js, (res[0][None], res[1][None]),
                                      shared)
                  if jpol.deferred_appends else res)
            js = jpol.shared_post(js, shared)
            tshared = pol.shared_pre(state)
            with _Record(pq) as trec:
                out, payload = pol.decode_attn(
                    state, 0, *map(torch.from_numpy, (qs, ks, vs)), tshared)
            if pol.deferred_appends:
                pol.commit_appends(state, (payload[0][None],
                                           payload[1][None]), tshared)
            pol.shared_post(state, tshared)
            # masked: JAX thresholds group_scores, which records nothing
            assert len(trec.seen) == len(jrec.seen) == (fetch != "masked"
                                                        or sb > 1)
            for a, b in zip(trec.seen, jrec.seen):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                       err_msg=f"{kernels} step {i}",
                                       **OUT_TOL)
        assert state.n_cand == int(js.n_cand)
        np.testing.assert_array_equal(state.codes.numpy(),
                                      np.asarray(js.codes))
        np.testing.assert_allclose(state.kv_tail.float().numpy(),
                                   np.asarray(js.kv_tail, np.float32),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the whole model: transplanted decode and the Engine's tokens

@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.tiny_model_config(num_layers=2)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rng = np.random.default_rng(3)
    motif = rng.integers(0, jcfg.vocab_size, size=16)
    ids = np.concatenate([motif, rng.integers(0, jcfg.vocab_size, size=1000),
                          motif, rng.integers(0, jcfg.vocab_size, size=60)])
    return jparams, params, ids


MODEL_CASES = [BRANCHES[i] for i in (0, 2, 3, 4, 5, 6, 7, 8)]


@pytest.mark.parametrize("case", MODEL_CASES,
                         ids=[_branch_id(c) for c in MODEL_CASES])
def test_branch_decode_matches_jax(model, case):
    jparams, params, ids = model
    jecfg, ecfg = _ecfgs(*case)
    true_len, P = len(ids), 1152
    pad = P - true_len
    tokens = np.zeros(P, np.int32)
    tokens[pad:] = ids
    jpol = jget_policy(jecfg, jcompute_budget(jecfg.budget, P, 32))
    jlogits, jstate = jax.jit(lambda p, s, t: jllama.prefill(
        jecfg.model, p, jpol, s, t, jnp.asarray(pad),
        jnp.asarray(true_len)))(jparams, jpol.init_state(jnp.float32),
                                jnp.asarray(tokens))
    jnp_state = jax.tree.map(np.asarray, jstate)
    jstep = jax.jit(lambda p, s, t, pos: jllama.decode_step(
        jecfg.model, p, jpol, s, t, pos))
    tok = int(jnp.argmax(jlogits))
    jlog, jtoks = [], []
    for i in range(N_STEPS):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(true_len + i, jnp.int32))
        jlog.append(np.asarray(jl))
        jtoks.append(tok)
        tok = int(jnp.argmax(jl))
    budget = compute_budget(ecfg.budget, P, 32)
    for kernels in ("xla", "auto"):
        pol = get_policy(_with_kernels(ecfg, kernels), budget, device="cpu")
        state = bridge.pq_state_from_numpy(jnp_state, device="cpu")
        for i in range(N_STEPS):
            tl = llama.decode_step(ecfg.model, params, pol, state,
                                   torch.tensor(jtoks[i]), true_len + i)
            np.testing.assert_allclose(tl.numpy(), jlog[i],
                                       err_msg=f"{kernels} step {i}",
                                       **LOGIT_TOL)
            assert int(torch.argmax(tl)) == int(np.argmax(jlog[i]))
        assert state.n_cand == int(jstate.n_cand)
        np.testing.assert_array_equal(state.codes.numpy(),
                                      np.asarray(jstate.codes))


_jax_seeds = jax.jit(lambda x, n, C: jpq.kmeans(
    x, C, iters=0, seed=4321, valid_len=n).centroids, static_argnums=2)


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    """The port's k-means starts from JAX's k-means++ centroids of the same
    points and seed (the default kmeans_seed, group offset 0)."""
    orig = pq.kmeans

    def kmeans(x, C, iters, *, valid_len=None, generator=None, **kw):
        c0 = _jax_seeds(jnp.asarray(x.numpy()),
                        jnp.asarray(valid_len, jnp.int32), C)
        return orig(x, C, iters, valid_len=valid_len,
                    init_centroids=torch.from_numpy(np.array(c0)), **kw)
    monkeypatch.setattr(pq, "kmeans", kmeans)


ENGINE_CASES = [BRANCHES[i] for i in (1, 2, 4, 7)]


@pytest.mark.parametrize("case", ENGINE_CASES,
                         ids=[_branch_id(c) for c in ENGINE_CASES])
def test_engine_branch_tokens_match_jax(model, jax_kmeans_init, case):
    jparams, params, ids = model
    jecfg, ecfg = _ecfgs(*case)
    want = JEngine(jecfg, jparams, dtype=jnp.float32).generate(ids, 12)
    for kernels in ("auto", "xla"):
        got = Engine(_with_kernels(ecfg, kernels), params,
                     dtype=torch.float32, device="cpu").generate(ids, 12)
        assert got.policy_name == "pq_search"
        assert got.tokens == want.tokens, kernels


def test_branch_configuration_checks(model):
    _, params, _ = model
    _, ecfg = _ecfgs(gqa=False, select_block=16)
    budget = compute_budget(ecfg.budget, 1152, 32)
    with pytest.raises(ValueError, match="gqa=False"):
        get_policy(ecfg, budget, device="cpu")
    _, ecfg = _ecfgs(gqa=False, fetch="masked")
    with pytest.raises(ValueError, match="gqa=False"):
        get_policy(ecfg, budget, device="cpu")
    # no batched route for the in-layer appends, as in the JAX package
    for kw in (dict(gqa=False), dict(fetch="masked")):
        _, ecfg = _ecfgs(**kw)
        pol = get_policy(ecfg, budget, device="cpu")
        assert not pol.deferred_appends
        with pytest.raises(ValueError, match="single-sequence"):
            pol.init_batched_state(2, torch.float32)
        with pytest.raises(ValueError, match="single-sequence"):
            BatchEngine(ecfg, params, batch_size=2, prefill_len=256,
                        max_new_tokens=8, dtype=torch.float32,
                        device="cpu")
    # ip: centroids one column wider, a histogram never allocated
    _, ecfg = _ecfgs("ip", select_block=16)
    st = get_policy(ecfg, budget, device="cpu").init_state(torch.float32)
    assert st.centroids.shape[-1] == ecfg.model.head_dim // 2 + 1
    assert st.jhist is None


# ---------------------------------------------------------------------------
# the batch-as-heads decode with ip

BP, B_LENGTHS, CHUNK = 256, (256, 243, 230), 5


@pytest.mark.parametrize("select_block,kv", [(16, "bf16"), (1, "int8")],
                         ids=["block16-bf16", "token-int8"])
def test_batched_ip_decode_matches_jax(select_block, kv):
    jecfg, ecfg = _ecfgs("ip", select_block, kv, max_seq_len=512,
                         max_new_tokens=24)
    jparams = jllama.init_params(jecfg.model, jax.random.PRNGKey(7),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    jpol = jget_policy(jecfg, jcompute_budget(jecfg.budget, BP, 24))
    jstate = jpol.init_batched_state(len(B_LENGTHS), jnp.float32)
    prefill = jax.jit(lambda p, s, t, pad, n: jllama.prefill(
        jecfg.model, p, jpol, s, t, pad, n))
    rng = np.random.default_rng(21)
    toks, pos = [], []
    for slot, n in enumerate(B_LENGTHS):
        ids = np.zeros(BP, np.int32)
        ids[BP - n:] = rng.integers(0, jecfg.model.vocab_size, size=n)
        lg, s = prefill(jparams, jpol.init_state(jnp.float32),
                        jnp.asarray(ids), jnp.asarray(BP - n, jnp.int32),
                        jnp.asarray(n, jnp.int32))
        jstate = jpol.insert_slot(jstate, s, jnp.asarray(slot, jnp.int32))
        toks.append(int(jnp.argmax(lg)))
        pos.append(n)
    pol = get_policy(_with_kernels(ecfg, "auto"),
                     compute_budget(ecfg.budget, BP, 24), device="cpu")
    assert pol.ring_k == jpol.ring_k > CHUNK
    state = bridge.pq_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                       device="cpu")
    jstep = jax.jit(lambda p, s, t, q: jllama.decode_step_batched(
        jecfg.model, p, jpol, s, t, q))
    jflush = jax.jit(jpol.flush_ring_batched)
    jtok = jnp.asarray(toks, jnp.int32)
    jpos = jnp.asarray(pos, jnp.int32)
    tok, tpos = torch.tensor(toks, dtype=torch.int32), torch.tensor(
        pos, dtype=torch.int32)
    for c in range(3):
        for i in range(CHUNK):
            jl, jstate = jstep(jparams, jstate, jtok, jpos)
            tl = llama.decode_step_batched(ecfg.model, params, pol, state,
                                           tok, tpos)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       err_msg=f"chunk {c} step {i}",
                                       **LOGIT_TOL)
            jtok = jnp.argmax(jl, -1).astype(jnp.int32)
            tok = torch.argmax(tl, -1).to(torch.int32)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            jpos, tpos = jpos + 1, tpos + 1
        jstate = jflush(jstate)
        pol.flush_ring_batched(state)
        np.testing.assert_array_equal(state.codes.numpy(),
                                      np.asarray(jstate.codes))
        np.testing.assert_array_equal(state.n_cand.numpy(),
                                      np.asarray(jstate.n_cand))


# ---------------------------------------------------------------------------
# the offload engine with ip

@pytest.mark.parametrize("kv,stale", [("bf16", False), ("int8", True)],
                         ids=["bf16-exact", "int8-stale"])
def test_offload_ip_gives_jax_tokens(model, jax_kmeans_init, kv, stale):
    jparams, params, ids = model
    ids = ids[:260]

    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=2),
            pq=mod.PQConfig(n_subvec_per_head=2, n_subbits=4,
                            kmeans_iters=8, approx_topk=False,
                            select_block=32, metric="ip"),
            budget=mod.BudgetConfig(compress_ratio=0.3, recent_ratio=0.5,
                                    sink_size=4),
            cache=mod.CacheConfig(offload=True, block_size=32,
                                  hbm_cache_tokens=128, cache_topk_blocks=4,
                                  kv_dtype=kv, stale_select=stale),
            runtime=mod.RuntimeConfig(policy="pq_search", prefill_bucket=64,
                                      max_new_tokens=16, max_seq_len=1024))
    je = JOffload(build(jconfig), jparams, dtype=jnp.float32)
    want = je.generate(ids, 10)
    pe = OffloadEngine(build(config), params, dtype=torch.float32,
                       device="cpu")
    assert not pe.use_jhist
    got = pe.generate(ids, 10)
    assert got == list(want)
    assert (pe.store.hits, pe.store.misses) == (je.store.hits,
                                                je.store.misses)
