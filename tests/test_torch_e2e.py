"""The PyTorch port's main path against the JAX package, end to end on the CPU.

The same float32 parameters (JAX ``init_params`` moved through
``bridge.params_from_numpy``) go through both packages; the JAX side runs its
XLA path (``kernels="xla"``), the port its plain versions on the CPU, once
with ``kernels="xla"`` and once with ``kernels="auto"`` (the kernel wrappers,
which compute their plain versions for CPU tensors). Both sides run
``adc_mode="v1"`` (JAX's XLA route sums the f32 LUT) and exact top-k.
Prefill logits agree to float32 summation order (1e-4 absolute on logits of
order 1e-1). Decode starts from the JAX prefill state transplanted into the
port (the port's k-means++ draws from torch, so its own codebooks differ)
and must give identical greedy tokens with per-step logits within 1e-4.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu import config as jconfig
from pqcache_tpu.core.budget import compute_budget as jcompute_budget
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.policies.base import get_policy as jget_policy
from pqcache_tpu.runtime.generate import Engine as JEngine
import pqcache_tpu_torch
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.harness import latency, serving
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
from pqcache_tpu_torch.runtime.generate import Engine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
N_STEPS = 16


@pytest.fixture(scope="module")
def model():
    cfg_kw = dict(num_layers=2)
    jcfg = jconfig.tiny_model_config(**cfg_kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rng = np.random.default_rng(3)
    motif = rng.integers(0, jcfg.vocab_size, size=16)
    ids = np.concatenate([motif, rng.integers(0, jcfg.vocab_size, size=1000),
                          motif, rng.integers(0, jcfg.vocab_size, size=60)])
    return jcfg, jparams, config.tiny_model_config(**cfg_kw), params, ids


def _ecfgs(jcfg, cfg, policy, select_block, kv_dtype, scorer="auto",
           score_func="sum"):
    kw = dict(
        pq=dict(n_subvec_per_head=2, n_subbits=4, kmeans_iters=4,
                select_block=select_block, scorer=scorer, adc_mode="v1",
                gather_mode="pallas", approx_topk=False),
        budget=dict(compress_ratio=0.3, recent_ratio=0.5, sink_size=4),
        # infllm: 16-token blocks, so generated tokens complete a block
        # within the test's decode steps (the default 128 would not)
        cache=dict(kv_dtype=kv_dtype,
                   block_size=16 if policy == "infllm" else 128),
        runtime=dict(policy=policy, prefill_bucket=64, max_new_tokens=32,
                     max_seq_len=2048, kernels="xla", score_func=score_func))

    def build(mod, model_cfg):
        return mod.EngineConfig(
            model=model_cfg, pq=mod.PQConfig(**kw["pq"]),
            budget=mod.BudgetConfig(**kw["budget"]),
            cache=mod.CacheConfig(**kw["cache"]),
            runtime=mod.RuntimeConfig(**kw["runtime"]))
    return build(jconfig, jcfg), build(config, cfg)


def _with_kernels(ecfg, kernels):
    return dataclasses.replace(ecfg, runtime=dataclasses.replace(
        ecfg.runtime, kernels=kernels))


# select_block 1 is the per-token path (K5, K6); 16 with scorer "kernel"
# the fused block scorer (K3) on the "auto" route, mips_topk_blocks on
# the "xla" route; 16 and 256 with scorer "auto" the joint histogram.
# h2o (both score modes) and infllm read K4's scores at prefill.
SLICE_CASES = [
    ("pq_search", 16, "bf16", "auto"), ("pq_search", 16, "int8", "auto"),
    ("pq_search", 256, "bf16", "auto"), ("pq_search", 256, "int8", "auto"),
    ("original", 16, "bf16", "auto"),
    ("pq_search", 1, "bf16", "auto"), ("pq_search", 1, "int8", "auto"),
    ("pq_search", 16, "bf16", "kernel"),
    ("h2o", 16, "bf16", "auto", "sum"), ("h2o", 16, "bf16", "auto", "max"),
    ("infllm", 16, "bf16", "auto")]


def _case_id(c):
    if c[0] in ("h2o", "infllm"):
        return "-".join(c[:1] + c[4:])
    return "-".join(map(str, c[:3])) + ("-kernel" if c[3] == "kernel" else "")


def _state_from_jax(policy, jnp_state):
    if policy == "pq_search":
        return bridge.pq_state_from_numpy(jnp_state, device="cpu")
    if policy == "infllm":
        return bridge.infllm_state_from_numpy(jnp_state, device="cpu")
    return bridge.dense_state_from_numpy(jnp_state, device="cpu")


def _assert_score_state_equal(policy, state, jstate):
    """The h2o / infllm state fields against JAX's: masks and flags
    exactly, keys and accumulated scores to float32 summation order. Keys
    are compared on the valid span only: left-pad rows see no key, and the
    port writes 0 there where JAX's XLA twin writes the mean of V, so the
    pad rows of later layers differ (nothing reads them)."""
    tol = dict(rtol=1e-5, atol=1e-5)
    if policy == "infllm":
        valid = state.repr_valid.numpy()
        np.testing.assert_array_equal(valid, np.asarray(jstate.repr_valid))
        np.testing.assert_allclose(state.k_repr.numpy()[valid],
                                   np.asarray(jstate.k_repr)[valid], **tol)
        np.testing.assert_allclose(state.gen_scores.numpy(),
                                   np.asarray(jstate.gen_scores), **tol)
        state, jstate = state.dense, jstate.dense
    else:
        np.testing.assert_array_equal(state.mask.numpy(),
                                      np.asarray(jstate.mask))
        np.testing.assert_allclose(state.scores.numpy(),
                                   np.asarray(jstate.scores), **tol)
    assert (state.length, state.start, state.pos) == (
        int(jstate.length), int(jstate.start), int(jstate.pos))
    span = slice(state.start, state.length)
    np.testing.assert_allclose(state.k_cache[:, :, span].numpy(),
                               np.asarray(jstate.k_cache)[:, :, span], **tol)


@pytest.mark.parametrize("case", SLICE_CASES,
                         ids=[_case_id(c) for c in SLICE_CASES])
def test_slice_matches_jax(model, case):
    policy, select_block, kv_dtype, scorer = case[:4]
    score_func = case[4] if len(case) > 4 else "sum"
    jcfg, jparams, cfg, params, ids = model
    jecfg, ecfg = _ecfgs(jcfg, cfg, policy, select_block, kv_dtype, scorer,
                         score_func)
    true_len = len(ids)
    P = 1152                                  # the 64-bucket of the prompt
    pad = P - true_len
    tokens = np.zeros(P, np.int32)
    tokens[pad:] = ids

    jb = jcompute_budget(jecfg.budget, P, jecfg.runtime.max_new_tokens)
    jpol = jget_policy(jecfg, jb)
    jlogits, jstate = jax.jit(
        lambda p, s, t: jllama.prefill(jcfg, p, jpol, s, t, jnp.asarray(pad),
                                       jnp.asarray(true_len)))(
        jparams, jpol.init_state(jnp.float32), jnp.asarray(tokens))

    budget = compute_budget(ecfg.budget, P, ecfg.runtime.max_new_tokens)
    pol = get_policy(ecfg, budget, device="cpu")
    state0 = pol.init_state(torch.float32)
    logits = llama.prefill(cfg, params, pol, state0,
                           torch.from_numpy(tokens).long(), pad, true_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    if policy == "pq_search":
        # the histogram only where its scorer reads it
        assert (state0.jhist is None) == (select_block == 1
                                          or scorer == "kernel")
    jnp_state = jax.tree.map(np.asarray, jstate)
    if policy in ("h2o", "infllm"):
        # nothing random at prefill: the port's own state is JAX's
        _assert_score_state_equal(policy, state0, jnp_state)

    # decode from the JAX state, transplanted: JAX once, the port on both
    # of its routes
    jstep = jax.jit(lambda p, s, t, pos: jllama.decode_step(
        jcfg, p, jpol, s, t, pos))
    tok = int(jnp.argmax(jlogits))
    jlog, jtoks = [], []
    for i in range(N_STEPS):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(true_len + i, jnp.int32))
        jlog.append(np.asarray(jl))
        jtoks.append(tok)
        tok = int(jnp.argmax(jl))
    for kernels in ("xla", "auto"):
        pol = get_policy(_with_kernels(ecfg, kernels), budget, device="cpu")
        state = _state_from_jax(policy, jnp_state)
        for i in range(N_STEPS):
            tl = llama.decode_step(cfg, params, pol, state,
                                   torch.tensor(jtoks[i]), true_len + i)
            np.testing.assert_allclose(tl.numpy(), jlog[i], **LOGIT_TOL)
            assert int(torch.argmax(tl)) == int(np.argmax(jlog[i])), \
                f"{kernels} step {i}"
        # the states advanced identically
        if policy == "pq_search":
            assert state.n_cand == int(jstate.n_cand)
            np.testing.assert_array_equal(state.codes.numpy(),
                                          np.asarray(jstate.codes))
            if jstate.jhist is None:
                assert state.jhist is None
            else:
                np.testing.assert_array_equal(state.jhist.numpy(),
                                              np.asarray(jstate.jhist))
            assert state.pos == int(jstate.pos)
        elif policy in ("h2o", "infllm"):
            _assert_score_state_equal(policy, state,
                                      jax.tree.map(np.asarray, jstate))
        else:
            assert state.pos == int(jstate.pos)
    if policy == "infllm":
        # a block was formed from generated tokens during these steps
        assert not state0.repr_valid[:, :, -(-P // pol.block):].any()
        assert state.repr_valid[:, :, -(-P // pol.block):].any()


def test_engine_generate_end_to_end(model):
    jcfg, jparams, cfg, params, ids = model
    # the dense policy has no random seeding: tokens equal the JAX engine's
    jecfg, ecfg = _ecfgs(jcfg, cfg, "original", 16, "bf16")
    want = JEngine(jecfg, jparams, dtype=jnp.float32).generate(ids, 12)
    got = Engine(ecfg, params, dtype=torch.float32,
                 device="cpu").generate(ids, 12)
    assert got.tokens == want.tokens and got.policy_name == "original"

    # pq_search through the port's own prefill (its own codebooks)
    _, ecfg = _ecfgs(jcfg, cfg, "pq_search", 256, "int8")
    eng = Engine(ecfg, params, dtype=torch.float32, device="cpu")
    res = eng.generate(ids, 12)
    assert res.policy_name == "pq_search" and len(res.tokens) == 12
    assert all(0 <= t < cfg.vocab_size for t in res.tokens)
    # a short prompt falls back to the dense policy
    assert eng.generate(ids[:20], 4).policy_name == "original"
    # streaming yields the same tokens; EOS stops right after it is yielded
    assert list(eng.generate_stream(ids, 12, chunk=5)) == res.tokens
    eos = res.tokens[3]
    stop = eng.generate(ids, 12, eos_ids=(eos,)).tokens
    assert stop == res.tokens[:res.tokens.index(eos) + 1]
    with pytest.raises(ValueError):
        eng.generate(ids, 64)           # beyond the max_new_tokens reservation


@pytest.mark.parametrize("policy,score_func", [
    ("h2o", "sum"), ("h2o", "max"), ("infllm", "sum")])
def test_engine_generate_score_policies(model, policy, score_func):
    # h2o and infllm draw nothing at random: from the same prompt the
    # port's Engine gives the JAX Engine's tokens, on both of its routes
    jcfg, jparams, cfg, params, ids = model
    jecfg, ecfg = _ecfgs(jcfg, cfg, policy, 16, "bf16",
                         score_func=score_func)
    want = JEngine(jecfg, jparams, dtype=jnp.float32).generate(ids, 12)
    for kernels in ("auto", "xla"):
        got = Engine(_with_kernels(ecfg, kernels), params, dtype=torch.float32,
                     device="cpu").generate(ids, 12)
        assert got.policy_name == policy
        assert got.tokens == want.tokens, kernels


def test_infllm_clamped_windows_match_jax():
    # a state whose token dim is exactly max_len (256), decoded to its last
    # slot: the local window [length + 1 - local, length + 2) and the
    # gen_scores window run past the end and JAX's dynamic slices move
    # them back; 24-token blocks (not a divisor of 256) with a top-k that
    # selects all 11 blocks, so the last block's gather indices 256..263
    # are clamped; a left pad of 60 leaves block 0 without representatives
    from pqcache_tpu.core.budget import Budget as JBudget
    from pqcache_tpu_torch.core.budget import Budget
    cfg_kw = dict(num_layers=1)
    jcfg, cfg = (jconfig.tiny_model_config(**cfg_kw),
                 config.tiny_model_config(**cfg_kw))
    jecfg, ecfg = _ecfgs(jcfg, cfg, "infllm", 16, "bf16")
    jecfg, ecfg = (dataclasses.replace(e, cache=dataclasses.replace(
        e.cache, block_size=24)) for e in (jecfg, ecfg))
    P, pad, new = 224, 60, 32
    bkw = dict(prefill_len=P, sink=4, local=40, topk=264, max_new_tokens=new)
    jpol = jget_policy(jecfg, JBudget(**bkw))
    pol = get_policy(ecfg, Budget(**bkw), device="cpu")
    assert pol.n_sel == pol.n_blocks == 11
    H, H_kv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(9)
    rand = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, k, v = rand(H, P, D), rand(H_kv, P, D), rand(H_kv, P, D)
    jout, jstate = jpol.prefill_attn(
        jpol.init_state(jnp.float32), jnp.asarray(0), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad), jnp.asarray(P))
    state = pol.init_state(torch.float32)
    out = pol.prefill_attn(state, 0, *map(torch.from_numpy, (q, k, v)), pad,
                           P)
    np.testing.assert_allclose(out[:, pad:].numpy(),
                               np.asarray(jout)[:, pad:], **LOGIT_TOL)
    _assert_score_state_equal("infllm", state,
                              jax.tree.map(np.asarray, jstate))

    @jax.jit
    def jstep(s, q, k, v):
        out, s = jpol.decode_attn(s, jnp.asarray(0), q, k, v,
                                  jpol.shared_pre(s))
        return out, jpol.shared_post(s, None)
    for _ in range(new):
        q, k, v = rand(H, 1, D), rand(H_kv, 1, D), rand(H_kv, 1, D)
        jout, jstate = jstep(jstate, *map(jnp.asarray, (q, k, v)))
        out, _ = pol.decode_attn(state, 0, *map(torch.from_numpy, (q, k, v)),
                                 pol.shared_pre(state))
        pol.shared_post(state, None)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **LOGIT_TOL)
    assert state.dense.length == state.dense.k_cache.shape[2] == P + new
    _assert_score_state_equal("infllm", state,
                              jax.tree.map(np.asarray, jstate))


def test_engine_device_default_and_unported_options(model):
    jcfg, jparams, cfg, params, ids = model
    ecfg = config.EngineConfig(model=cfg)
    if torch.cuda.is_available():
        assert Engine(ecfg, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(ecfg, params)
    for rt in (dict(kernels="pallas-interpret"),):
        bad = dataclasses.replace(ecfg, runtime=dataclasses.replace(
            ecfg.runtime, **rt))
        with pytest.raises(ValueError):
            Engine(bad, params, device="cpu")
    # sampling is ported: the same seed gives the same tokens, and top_k 1
    # is greedy
    def sampled(**rt):
        e = dataclasses.replace(ecfg, runtime=dataclasses.replace(
            ecfg.runtime, max_new_tokens=16, **rt))
        return Engine(e, params, dtype=torch.float32,
                      device="cpu").generate(ids, 8).tokens
    hot = sampled(temperature=0.7, sample_seed=3)
    assert hot == sampled(temperature=0.7, sample_seed=3) and len(hot) == 8
    assert sampled(temperature=0.7, top_k=1) == sampled()
    # chunked prefill is ported: prefill_chunk=512 (the 1152-token bucket
    # planned as 3 chunks of 512) gives the JAX Engine's tokens
    jecfg, ecfg_c = (dataclasses.replace(e, runtime=dataclasses.replace(
        e.runtime, prefill_chunk=512))
        for e in _ecfgs(jcfg, cfg, "original", 16, "bf16"))
    want = JEngine(jecfg, jparams, dtype=jnp.float32).generate(ids, 8)
    assert Engine(ecfg_c, params, dtype=torch.float32,
                  device="cpu").generate(ids, 8).tokens == want.tokens
    budget = compute_budget(ecfg.budget, 1024, 16)
    # the non-default branches are ported: ip, the masked fetch and gqa=False
    # build their policies (tests/test_torch_pq_branches.py holds them to
    # JAX); gqa=False still refuses the block path, as JAX does
    for section, kw in (("pq", dict(metric="ip", select_block=16)),
                        ("pq", dict(fetch_mode="masked")),
                        ("runtime", dict(gqa=False))):
        ok = dataclasses.replace(ecfg, **{section: dataclasses.replace(
            getattr(ecfg, section), **kw)})
        pol = get_policy(ok, budget, device="cpu")
        assert pol.deferred_appends == (section == "pq" and "metric" in kw)
    bad = dataclasses.replace(
        ecfg, pq=dataclasses.replace(ecfg.pq, select_block=16),
        runtime=dataclasses.replace(ecfg.runtime, gqa=False))
    with pytest.raises(ValueError, match="gqa=False"):
        get_policy(bad, budget, device="cpu")
    for kw in (dict(select_block=1), dict(select_block=16, scorer="kernel"),
               dict(select_block=512, scorer="kernel")):
        ok = dataclasses.replace(ecfg, pq=dataclasses.replace(ecfg.pq, **kw))
        pol = get_policy(ok, budget, device="cpu")
        assert pol.init_state(torch.float32).jhist is None


def test_engine_default_pq_config_end_to_end(model, capsys):
    # the default PQConfig is the per-token path (select_block 1, adc_mode
    # v2, approximate top-k): prefill, decode and appends on the CPU, with
    # no joint histogram allocated
    jcfg, jparams, cfg, params, ids = model
    ecfg = config.EngineConfig(
        model=cfg, pq=config.PQConfig(kmeans_iters=4),
        runtime=config.RuntimeConfig(prefill_bucket=64, max_new_tokens=16,
                                     max_seq_len=2048))
    assert ecfg.pq.select_block == 1
    eng = Engine(ecfg, params, dtype=torch.float32, device="cpu")
    res = eng.generate(ids, 10)
    assert res.policy_name == "pq_search" and len(res.tokens) == 10
    assert all(0 <= t < cfg.vocab_size for t in res.tokens)
    pol = next(iter(eng._policies.values()))
    assert pol.select_block == 1 and not pol.use_jhist
    assert pol.init_state(torch.float32).jhist is None
    # the kernel wrappers' CPU branches give the plain route's tokens
    xla = _with_kernels(ecfg, "xla")
    assert Engine(xla, params, dtype=torch.float32,
                  device="cpu").generate(ids, 10).tokens == res.tokens
    # the recall oracle prints one line per layer and decode step, and
    # does not change the tokens
    capsys.readouterr()
    rec = dataclasses.replace(ecfg, pq=dataclasses.replace(
        ecfg.pq, check_recall=True))
    assert Engine(rec, params, dtype=torch.float32,
                  device="cpu").generate(ids, 3).tokens == res.tokens[:3]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("pq recall layer=")]
    assert len(lines) == 2 * cfg.num_layers
    assert all(0.0 <= float(ln.split(": ")[1]) <= 1.0 for ln in lines)


def test_entry_points_default_to_cuda(model):
    # every public entry point that places tensors runs on cuda unless the
    # caller names a device; without CUDA it raises instead of falling back
    _, _, cfg, params, _ = model
    ecfg = config.EngineConfig(model=cfg)
    budget = compute_budget(ecfg.budget, 1024, 16)
    from pqcache_tpu_torch.policies.base import policy_class
    from pqcache_tpu_torch.runtime import state as st
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    a = np.zeros((2, 3), np.float32)
    cpu_pol = get_policy(ecfg, budget, device="cpu")
    cpu_state = cpu_pol.init_batched_state(2, torch.float32)
    calls = [
        lambda: llama.init_params(cfg, torch.Generator()),
        lambda: llama.rope_inv_freq(cfg),
        lambda: get_policy(ecfg, budget),
        lambda: policy_class("pq_search")(ecfg, budget),
        lambda: policy_class("original")(ecfg, budget),
        lambda: policy_class("h2o")(ecfg, budget),
        lambda: policy_class("infllm")(ecfg, budget),
        lambda: st.make_pq_state(ecfg, budget),
        lambda: st.make_dense_state(ecfg, 256),
        lambda: st.make_dense_state(ecfg, 256, with_scores=True),
        lambda: st.make_pq_state(ecfg, budget, batch=2, ring_k=4,
                                 tail_pad=256),
        lambda: st.make_dense_state(ecfg, 256, batch=2),
        lambda: policy_class("pq_search")(ecfg, budget).init_batched_state(2),
        lambda: policy_class("original")(ecfg, budget).init_batched_state(2),
        lambda: BatchedDecoder(cfg, params, cpu_pol, cpu_state),
        lambda: BatchedDecoder(cfg, params, cpu_pol, cpu_state, graph=False),
        lambda: BatchEngine(ecfg, params, batch_size=2, prefill_len=256,
                            max_new_tokens=4),
        lambda: serving.run(serving.parse_args(["--tiny", "--ctx", "256"])),
        lambda: latency.run(latency.parse_args(["--tiny", "--ctx", "256"])),
        lambda: bridge.tensor_from_numpy(a),
        lambda: bridge.params_from_numpy({"embed": a, "layers": {"wq": a}}),
        lambda: bridge.pq_state_from_numpy(dict(
            k_sink=a, v_sink=a, kv_tail=a, codes=a, centroids=a, phi=a,
            n_cand=0, pos=0, jhist=None, k_scale=None, v_scale=None)),
        lambda: bridge.dense_state_from_numpy(dict(
            k_cache=a, v_cache=a, length=0, start=0, pos=0)),
        lambda: bridge.infllm_state_from_numpy(dict(
            dense=dict(k_cache=a, v_cache=a, length=0, start=0, pos=0),
            k_repr=a, repr_valid=a, gen_scores=a)),
    ]
    if torch.cuda.is_available():
        assert pqcache_tpu_torch.resolve_device().type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # with the device named, they run on the CPU
    assert llama.rope_inv_freq(cfg, "cpu").device.type == "cpu"
    assert st.make_dense_state(ecfg, 256, device="cpu").k_cache.device.type \
        == "cpu"
    assert bridge.tensor_from_numpy(a, "cpu").device.type == "cpu"
    assert cpu_state.n_cand.device.type == "cpu"
    assert BatchedDecoder(cfg, params, cpu_pol, cpu_state, graph=False,
                          device="cpu").tok.device.type == "cpu"
    # a CPU engine decodes eagerly, and takes no CUDA graph
    be = BatchEngine(ecfg, params, batch_size=2, prefill_len=256,
                     max_new_tokens=4, dtype=torch.float32, device="cpu")
    assert not be.decoder.use_graph and be.bstate.n_cand.device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA graph"):
        BatchEngine(ecfg, params, batch_size=2, prefill_len=256,
                    max_new_tokens=4, device="cpu", graph=True)


def test_port_imports_no_jax():
    # a fresh interpreter: importing every module of the port (and the chip
    # smoke script) must not pull in jax, flax or the JAX package
    code = (
        "import pkgutil, sys, importlib\n"
        "import pqcache_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'pqcache_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('pqcache_tpu_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
