"""The port's chunked and prefix prefill against the JAX package's, on the CPU.

The same float32 parameters go through both packages (JAX ``init_params``
moved through ``bridge``); the JAX side runs its XLA route
(``kernels="xla"``: ``chunked_attention_rect`` for a chunk at q_offset), the
port its kernel route (``kernels="auto"``: K2's wrapper, which takes its
plain version on a CPU tensor). Logits agree to float32 summation order
(rtol = atol = 1e-4); K/V to 1e-5 on the rows a real token holds (left-pad
rows see no key: the port writes 0 there, JAX's XLA twin the mean of V, and
nothing reads them). ``pq_search`` trains codebooks from k-means++ seeds
that torch cannot replay from ``jax.random``, so the port's k-means is
handed JAX's initial centroids (``kmeans(iters=0)``), as
``tests/test_torch_pq.py`` does; its codes then agree on the valid rows.
``torch.set_num_threads(1)``: the suite runs with several workers.
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
from pqcache_tpu.ops.attention_xla import chunked_attention_rect
from pqcache_tpu.ops.flash_attention import flash_attention as jflash
from pqcache_tpu.policies.base import get_policy as jget_policy
from pqcache_tpu.runtime import generate as jgenerate
from pqcache_tpu_torch import bench, bridge, config
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.ops.dispatch import prefill_chunk_attention
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime import generate

torch.set_num_threads(1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
P, TRUE_LEN, CHUNK = 1152, 1092, 384      # 3 chunks; pad 60


@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.tiny_model_config(num_layers=2)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, TRUE_LEN)
    return jcfg, jparams, config.tiny_model_config(num_layers=2), params, ids


def _ecfgs(jcfg, cfg, policy, **rt):
    kw = dict(
        pq=dict(n_subvec_per_head=2, n_subbits=4, kmeans_iters=4,
                select_block=16, adc_mode="v1", approx_topk=False),
        budget=dict(compress_ratio=0.3, recent_ratio=0.5, sink_size=4),
        runtime=dict(dict(policy=policy, prefill_bucket=64,
                          max_new_tokens=16, max_seq_len=2048,
                          kernels="xla"), **rt))

    def build(mod, m):
        return mod.EngineConfig(
            model=m, pq=mod.PQConfig(**kw["pq"]),
            budget=mod.BudgetConfig(**kw["budget"]),
            runtime=mod.RuntimeConfig(**kw["runtime"]))
    return build(jconfig, jcfg), build(config, cfg)


def _auto(ecfg):
    return dataclasses.replace(ecfg, runtime=dataclasses.replace(
        ecfg.runtime, kernels="auto"))


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    """The port's k-means starts from JAX's k-means++ centroids of the
    same points and seed."""
    orig = pq.kmeans

    def kmeans(x, C, iters, *, valid_len=None, generator=None, **kw):
        j0 = jpq.kmeans(jnp.asarray(x.numpy()), C, iters=0, seed=4321,
                        valid_len=valid_len)
        return orig(x, C, iters, valid_len=valid_len, init_centroids=(
            torch.from_numpy(np.asarray(j0.centroids))), **kw)
    monkeypatch.setattr(pq, "kmeans", kmeans)


def _policies(jecfg, ecfg, Ptot):
    jpol = jget_policy(jecfg, jcompute_budget(
        jecfg.budget, Ptot, jecfg.runtime.max_new_tokens))
    pol = get_policy(_auto(ecfg), compute_budget(
        ecfg.budget, Ptot, ecfg.runtime.max_new_tokens), device="cpu")
    return jpol, pol


def _assert_state_close(policy, state, jstate, valid: int, pad: int = 0):
    """K/V of the rows real tokens hold; a PQ state's centroids and the
    codes of its valid rows too."""
    js = jax.tree.map(np.asarray, jstate)
    if policy == "original":
        span = slice(pad, pad + valid)
        for a, b in ((state.k_cache, js.k_cache), (state.v_cache, js.v_cache)):
            np.testing.assert_allclose(a[:, :, span].numpy(), b[:, :, span],
                                       **KV_TOL)
        assert (state.length, state.start, state.pos) == (
            int(js.length), int(js.start), int(js.pos))
        return
    sink = state.k_sink.shape[2]
    np.testing.assert_allclose(state.k_sink.numpy(), js.k_sink, **KV_TOL)
    np.testing.assert_allclose(state.kv_tail[:, :, :valid - sink].numpy(),
                               js.kv_tail[:, :, :valid - sink], **KV_TOL)
    np.testing.assert_allclose(state.centroids.numpy(), js.centroids,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(state.codes[..., :valid - sink].numpy(),
                                  js.codes[..., :valid - sink])
    assert (state.n_cand, state.pos) == (int(js.n_cand), int(js.pos))


# (P, ch, quantum): prompts around and between chunk multiples
PLAN_GRID = [(p, ch, qu) for p in (1, 255, 256, 1024, 1025, 33792, 98305,
                                   131072, 131073)
             for ch in (256, 512, 8192, 32768) for qu in (256, 1024)]


def test_chunk_plan_matches_jax():
    for p, ch, qu in PLAN_GRID:
        got = generate.chunk_plan(p, ch, qu)
        assert got == jgenerate.chunk_plan(p, ch, qu), (p, ch, qu)
        assert generate.chunk_plan(*got[:1], ch, qu)[0] == got[0]
    # the cap: the default plan, the finer 256 quantum, and the unchunked
    # fallback each taken somewhere on the grid
    seen = set()
    for p, ch, _ in PLAN_GRID:
        for cap in (p, p + 255, p + 1023, p + 4096):
            got = generate.chunk_plan_capped(p, ch, cap)
            assert got == jgenerate.chunk_plan_capped(p, ch, cap)
            assert got[1] == 0 or got[0] <= cap
            seen.add("fallback" if got[1] == 0 else
                     "default" if got == generate.chunk_plan(p, ch) else
                     "fine")
    assert seen == {"fallback", "default", "fine"}


@pytest.mark.parametrize("Tq,q_offset,pad", [
    (128, 0, 0), (128, 256, 37), (96, 200, 5), (300, 512, 130)])
def test_prefill_chunk_attention_matches_jax(Tq, q_offset, pad):
    # the plain twin of K2 at q_offset against JAX's chunked_attention_rect
    # and the Pallas kernel in interpret mode, on the rows that see a key;
    # keys past the chunk (Tk > q_offset + Tq) are masked by causality
    rng = np.random.default_rng(Tq + q_offset)
    H, H_kv, D = 4, 2, 128
    Tk = q_offset + Tq + 64
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((H, Tq, D), (H_kv, Tk, D), (H_kv, Tk, D)))
    got = prefill_chunk_attention(*map(torch.from_numpy, (q, k, v)), pad,
                                  q_offset=q_offset).numpy()
    plain = prefill_chunk_attention(*map(torch.from_numpy, (q, k, v)), pad,
                                    q_offset=q_offset,
                                    use_kernel=False).numpy()
    np.testing.assert_array_equal(got, plain)
    kq, vq = k[:, :q_offset + Tq], v[:, :q_offset + Tq]
    rect = np.asarray(chunked_attention_rect(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), valid_lo=pad,
        q_offset=q_offset))
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(kq),
                               jnp.asarray(vq), pad, q_offset=q_offset,
                               interpret=True))
    rows = q_offset + np.arange(Tq) >= pad
    np.testing.assert_allclose(got[:, rows], rect[:, rows], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[:, rows], pallas[:, rows], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[:, ~rows], 0)


@pytest.mark.parametrize("policy", ["pq_search", "original"])
def test_prefill_chunked_matches_jax(model, policy, jax_kmeans_init):
    jcfg, jparams, cfg, params, ids = model
    jecfg, ecfg = _ecfgs(jcfg, cfg, policy)
    pad = P - TRUE_LEN
    tokens = np.zeros(P, np.int32)
    tokens[pad:] = ids
    jpol, pol = _policies(jecfg, ecfg, P)
    jlogits, jstate = jax.jit(lambda p, s, t: jllama.prefill_chunked(
        jcfg, p, jpol, s, t, jnp.asarray(pad), jnp.asarray(TRUE_LEN),
        chunk=CHUNK))(jparams, jpol.init_state(jnp.float32),
                      jnp.asarray(tokens))
    state = pol.init_state(torch.float32)
    t = torch.from_numpy(tokens).long()
    logits = llama.prefill_chunked(cfg, params, pol, state, t, pad,
                                   TRUE_LEN, chunk=CHUNK)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_state_close(policy, state, jstate, TRUE_LEN, pad)
    # and the port's one-pass prefill: the same function
    one = pol.init_state(torch.float32)
    np.testing.assert_allclose(
        llama.prefill(cfg, params, pol, one, t, pad, TRUE_LEN).numpy(),
        logits.numpy(), **LOGIT_TOL)
    with pytest.raises(ValueError, match="multiple"):
        llama.prefill_chunked(cfg, params, pol, one, t, pad, TRUE_LEN,
                              chunk=500)


@pytest.mark.parametrize("policy", ["pq_search", "original"])
def test_prefix_prefill_matches_jax(model, policy, jax_kmeans_init):
    # a 700-token prefix snapshot, then a 392-token suffix right-padded to
    # 448: logits and the state over [prefix | suffix] against JAX's
    jcfg, jparams, cfg, params, ids = model
    jecfg, ecfg = _ecfgs(jcfg, cfg, policy)
    T_pre, true_suf, P_suf = 700, TRUE_LEN - 700, 448
    pre = ids[:T_pre].astype(np.int32)
    suf = np.zeros(P_suf, np.int32)
    suf[:true_suf] = ids[T_pre:]
    jk, jv = jax.jit(lambda p, t: jllama.prefill_capture_kv(
        jcfg, p, t, use_pallas=False))(jparams, jnp.asarray(pre))
    k, v = llama.prefill_capture_kv(cfg, params, torch.from_numpy(pre).long())
    assert k.shape == (cfg.num_layers, cfg.num_kv_heads, T_pre, cfg.head_dim)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **KV_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **KV_TOL)
    jpol, pol = _policies(jecfg, ecfg, T_pre + P_suf)
    jlogits, jstate = jax.jit(lambda p, s, a, b, t: jllama.prefill_with_prefix(
        jcfg, p, jpol, s, a, b, t, jnp.asarray(true_suf)))(
        jparams, jpol.init_state(jnp.float32), jk, jv, jnp.asarray(suf))
    state = pol.init_state(torch.float32)
    logits = llama.prefill_with_prefix(cfg, params, pol, state, k, v,
                                       torch.from_numpy(suf).long(), true_suf)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_state_close(policy, state, jstate, TRUE_LEN)


def test_engine_chunked_and_prefix_match_jax_engine(model):
    # `original` draws nothing at random: the port's Engine gives the JAX
    # Engine's tokens with prefill_chunk (the 1152-token bucket planned as 3 chunks of 512) and from a
    # prefix, on both of its routes
    jcfg, jparams, cfg, params, ids = model
    jecfg, ecfg = _ecfgs(jcfg, cfg, "original", prefill_chunk=512)
    jeng = jgenerate.Engine(jecfg, jparams, dtype=jnp.float32)
    want = jeng.generate(ids, 12).tokens
    jpre = jeng.prefill_prefix(ids[:700])
    want_pre = jeng.generate(ids[700:], 12, prefix=jpre).tokens
    for kernels in ("auto", "xla"):
        e = dataclasses.replace(ecfg, runtime=dataclasses.replace(
            ecfg.runtime, kernels=kernels))
        eng = generate.Engine(e, params, dtype=torch.float32, device="cpu")
        calls = []
        orig = llama.prefill_chunked

        def spy(*a, **kw):
            calls.append(kw["chunk"])
            return orig(*a, **kw)
        llama.prefill_chunked = spy
        try:
            got = eng.generate(ids, 12)
        finally:
            llama.prefill_chunked = orig
        assert calls == [512] and got.policy_name == "original"
        assert got.tokens == want, kernels
        pre = eng.prefill_prefix(ids[:700])
        assert pre.n == 700 and pre.k.shape[2] == 700
        assert eng.generate(ids[700:], 12, prefix=pre).tokens == want_pre
    with pytest.raises(ValueError, match="no room"):
        eng.prefill_prefix(np.zeros(2048, np.int64))
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(ids, 12, prefix=eng.prefill_prefix(ids[:1000]))


def test_engine_chunk_cap_falls_back_unchunked(model):
    # a plan past max_seq_len falls back to one unchunked pass at the
    # bucket, as chunk_plan_capped decides for JAX's Engine
    jcfg, jparams, cfg, params, ids = model
    jecfg, ecfg = _ecfgs(jcfg, cfg, "original", prefill_chunk=500,
                         max_seq_len=1160)
    assert jgenerate.chunk_plan_capped(P, 500, 1160) == (P, 0)
    eng = generate.Engine(_auto(ecfg), params, dtype=torch.float32,
                          device="cpu")
    got = eng.generate(ids, 6)
    want = jgenerate.Engine(jecfg, jparams, dtype=jnp.float32).generate(
        ids, 6)
    assert got.tokens == want.tokens
    assert list(eng._policies) == [(P, "original")]


def test_bench_run_on_cpu(capsys):
    # the port's bench driver at a tiny width on the CPU, eagerly: one JSON
    # line with bench.py's keys, a budget that covers every decoded step
    model = config.tiny_model_config(num_layers=2)
    kw = dict(ctx=1024, gen=8, ring=8, batch=2, pq_block=16, fetch_par=32,
              w_int8=True, prefill_chunk=0, fetch_pair=False,
              skip_base=False, kv_int8=True)
    with pytest.raises(RuntimeError, match="cpu"):
        bench.run(model, **kw, device="cpu", graph=True)
    out = bench.run(model, **kw, device="cpu", graph=False)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert set(out["detail"]) == {
        "baseline_full_attn_tok_s", "pq_step_ms", "base_step_ms",
        "pq_prefill_s", "base_prefill_s", "ctx", "layers", "batch",
        "select_block", "pq_kv_dtype", "w_int8"}
    assert out["value"] > 0 and out["vs_baseline"] > 0
    assert out["detail"]["w_int8"] and out["detail"]["pq_kv_dtype"] == "int8"
    assert "cpu" in out["metric"]
    # single stream through decode_loop, chunked prefill, no baseline
    one = bench.run(model, **dict(kw, batch=1, prefill_chunk=512,
                                  skip_base=True), device="cpu", graph=False)
    assert one["vs_baseline"] is None and one["value"] > 0
    assert one["detail"]["baseline_full_attn_tok_s"] == "OOM (skipped)"
