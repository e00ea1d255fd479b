"""The port's weight-only int8 (W8) against the JAX package's, on the CPU.

``core/quant.quantize_weight_mat`` / ``quantize_weight_tree`` must give
JAX's codes and scales bit for bit (float32 arithmetic, rounding half to
even). The model's three weight helpers (``_mm``, ``embed_lookup``,
``lm_head_logits``) and the W8 kernel's plain version are held against
JAX's to float32 summation order (rtol = atol = 1e-5 on products of order
1). Decode with W8 weights starts from a JAX state transplanted through
``bridge`` (the port's k-means++ draws from torch), single-sequence and
batch-as-heads: greedy tokens identical, logits within rtol = atol = 1e-4.
The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here ``plan_group`` and ``units``, the launch geometry it is given and the
table of work it walks, are checked against the kernel's rules, and the
decode path's grouped products (one call for q/k/v, one for gate/up) are
held to JAX. ``torch.set_num_threads(1)``: the suite runs with several
workers.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pqcache_tpu import config as jconfig
from pqcache_tpu.core import quant as jquant
from pqcache_tpu.core.budget import compute_budget as jcompute_budget
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.policies.base import get_policy as jget_policy
from pqcache_tpu.runtime.generate import Engine as JEngine
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core import quant
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.ops import w8
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
from pqcache_tpu_torch.runtime.generate import Engine, params_to

torch.set_num_threads(1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MM_TOL = dict(rtol=1e-5, atol=1e-5)
N_STEPS = 12


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp_of(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_weight_mat_is_jax_bit_for_bit(dtype):
    # random layers [2, 96, 80], one all-zero column (the 1e-12 floor) and
    # one whose quotients land on .5 (rounding half to even: 0.5 -> 0,
    # 1.5 -> 2, 2.5 -> 2, -0.5 -> 0)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(2, 96, 80)).astype(np.float32) * 0.02
    w[:, :, 3] = 0.0
    w[:, :, 5] = 0.0
    w[:, :5, 5] = [127.0, 0.5, 1.5, 2.5, -0.5]
    t = torch.from_numpy(w).to(dtype)
    q, s = quant.quantize_weight_mat(t)
    jq, js = jquant.quantize_weight_mat(_jnp_of(t))
    assert q.dtype == torch.int8 and s.dtype == dtype
    assert q.shape == t.shape and s.shape == (2, 1, 80)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), np.asarray(js, np.float32))
    np.testing.assert_array_equal(q[:, 1:5, 5].numpy(),
                                  [[0, 2, 2, 0]] * 2)
    assert (q[:, :, 3] == 0).all()
    assert (s[:, 0, 3] == torch.tensor(1e-12, dtype=dtype)).all()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_weight_tree_is_jax_bit_for_bit(dtype):
    # every layer matrix, the LM head, and the embedding with its per-ROW
    # scales; the norms pass through
    cfg = jconfig.tiny_model_config(num_layers=2)
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(3), dtype=dtype)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    jq = jax.tree.map(lambda a: np.asarray(a, np.float32)
                      if a.dtype == jnp.bfloat16 else np.asarray(a),
                      jquant.quantize_weight_tree(jparams))
    q = quant.quantize_weight_tree(params)
    assert set(q) == set(jq) and set(q["layers"]) == set(jq["layers"])
    assert q["embed_s"].shape == (cfg.vocab_size, 1)
    for a, b in [(q[k], jq[k]) for k in q if k != "layers"] + [
            (q["layers"][k], jq["layers"][k]) for k in q["layers"]]:
        assert a.shape == b.shape
        np.testing.assert_array_equal(_np(a), b)
    for k in quant.W_KEYS + ("lm_head", "embed"):
        src = params if k in params else params["layers"]
        dst = q if k in q else q["layers"]
        assert dst[k].dtype == torch.int8 and dst[k + "_s"].dtype == \
            src[k].dtype
    assert quant.quantize_weight_tree(params, embed=False)["embed"] is \
        params["embed"]


@pytest.fixture(scope="module")
def w8_params():
    cfg = jconfig.tiny_model_config(num_layers=2)
    jparams = jquant.quantize_weight_tree(
        jllama.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32))
    return cfg, jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("rows", [1, 8, 100])
def test_weight_helpers_match_jax(w8_params, rows):
    # _mm on every layer matrix, embed_lookup and lm_head_logits, f32 and
    # bf16 activations; the plain W8 twin is JAX's lines in torch
    cfg, jparams, params = w8_params
    rng = np.random.default_rng(rows)
    lp = llama._layer_params(params, 1)
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"])
    for dt, jdt, tol in ((torch.float32, jnp.float32, MM_TOL),
                         (torch.bfloat16, jnp.bfloat16,
                          dict(rtol=1e-2, atol=1e-3))):
        for name in quant.W_KEYS:
            x = rng.normal(size=(rows, lp[name].shape[0])).astype(np.float32)
            got = llama._mm(torch.from_numpy(x).to(dt), _cast(lp, dt), name)
            want = jllama._mm(jnp.asarray(x, jdt), _jcast(jlp, jdt), name)
            assert got.dtype == dt
            np.testing.assert_allclose(_np(got),
                                       np.asarray(want, np.float32), **tol)
            twin = w8.w8_matmul_ref(torch.from_numpy(x).to(dt), lp[name],
                                    lp[name + "_s"])
            np.testing.assert_array_equal(_np(twin), _np(got))
        last = rng.normal(size=(rows, cfg.hidden_size)).astype(np.float32)
        got = llama.lm_head_logits(_cast(params, dt),
                                   torch.from_numpy(last).to(dt))
        want = jllama.lm_head_logits(_jcast(jparams, jdt),
                                     jnp.asarray(last, jdt))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    toks = rng.integers(0, cfg.vocab_size, rows)
    got = llama.embed_lookup(params, torch.from_numpy(toks))
    want = jllama.embed_lookup(jparams, jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cast(tree, dt):
    """Float tensors of a params dict (or a layer's) in dt, int8 kept."""
    return {k: (_cast(v, dt) if isinstance(v, dict) else
                v.to(dt) if v.is_floating_point() else v)
            for k, v in tree.items()}


def _jcast(tree, dt):
    return jax.tree.map(lambda a: a.astype(dt)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def test_params_to_keeps_int8_weights(w8_params):
    # the Engine's move to the device: int8 weights stay int8, their scales
    # follow the float dtype; float weights take it (params_to once cast
    # every tensor, int8 weights to bf16 integers, without a word)
    _, _, params = w8_params
    moved = params_to(params, "cpu", torch.bfloat16)
    assert moved["lm_head"].dtype == moved["layers"]["wq"].dtype == \
        moved["embed"].dtype == torch.int8
    assert moved["lm_head_s"].dtype == moved["layers"]["wq_s"].dtype == \
        moved["final_norm"].dtype == torch.bfloat16
    assert torch.equal(moved["layers"]["down"], params["layers"]["down"])
    # the final norm and LM head subset carries the int8 head's scales
    assert set(llama.lm_head_params(moved)) == {"final_norm", "lm_head",
                                                "lm_head_s"}


def test_w8_wrapper_counts_and_routes(w8_params):
    # on the CPU the wrapper computes its plain version and counts nothing;
    # _mm sends every CPU call there, whatever its rows
    _, _, params = w8_params
    lp = llama._layer_params(params, 0)
    n0, d0 = w8.w8_matmul.launches, w8.w8_dequant_matmul.launches
    for rows in (1, 64, 65, 300):
        x = torch.randn(rows, lp["wq"].shape[0])
        torch.testing.assert_close(llama._mm(x, lp, "wq"), w8.w8_matmul_ref(
            x, lp["wq"], lp["wq_s"]), rtol=0, atol=0)
    assert (w8.w8_matmul.launches, w8.w8_dequant_matmul.launches) == (n0, d0)


# (M, Ns, K): the groups of the decode path at Llama-3.1-8B width (E 4096,
# I 14336, V 128256: q/k/v, wo, gate/up, down, the LM head) at the Engine's,
# bench.py's and ragged rows, and ragged N
PLAN_GROUPS = [(4096, 1024, 1024), (4096,), (14336, 14336), (128256,),
               (1000,), (4100, 4, 1024)]
PLAN_CASES = [(m, ns, k) for m in (1, 3, 8, 13, 33, 64)
              for ns in PLAN_GROUPS for k in (4096, 14336)]


def _check_units(M, Ns, K, sms):
    """The unit table of plan_group covers every (product, column tile, k
    block) once; each CTA's units are one contiguous range, and the ranges
    differ by at most one unit, so the bytes per CTA differ by at most one
    unit's where the units are equal (N a multiple of the tile, K of the k
    block; a ragged tile or block is smaller); a tile cut between CTAs is
    held by consecutive CTAs in k order, and each of its segments names
    them in that order."""
    plan = w8.plan_group(M, tuple(Ns), K, sms)
    assert plan.mt in (1, 2, 4, 8) and 8 * plan.mt >= M
    assert plan.mt == 1 or 4 * plan.mt < M
    # at most one CTA per SM and one unit per CTA; fewer only for a grid
    # that cuts the units into equal tile-aligned ranges
    most = min(sms, plan.units)
    assert math.ceil(w8.ALIGNED_SHARE * most) <= plan.grid <= most
    if plan.grid < most:
        per, rem = divmod(plan.units, plan.grid)
        assert rem == 0 and (plan.ipt % per == 0 or per % plan.ipt == 0)
    assert plan.ipt == -(-K // w8.BLOCK_ROWS)
    assert plan.tiles == tuple(-(-n // w8.TILE_COLS) for n in Ns)
    table = w8.units(plan)
    assert len(table) == plan.grid
    seen = {}
    counts, nbytes = [], []
    for c, segs in enumerate(table):
        n_units, b = 0, 0
        for p, tile, kb0, kb1, ctas in segs:
            assert 0 <= kb0 < kb1 <= plan.ipt and c in ctas
            cols = min(w8.TILE_COLS, Ns[p] - tile * w8.TILE_COLS)
            for kb in range(kb0, kb1):
                key = (p, tile, kb)
                assert key not in seen, key
                seen[key] = (c, ctas)
                b += cols * min(w8.BLOCK_ROWS, K - w8.BLOCK_ROWS * kb)
            n_units += kb1 - kb0
        counts.append(n_units)
        nbytes.append(b)
    want = {(p, t, kb) for p, n in enumerate(Ns)
            for t in range(-(-n // w8.TILE_COLS)) for kb in range(plan.ipt)}
    assert set(seen) == want
    assert max(counts) - min(counts) <= 1
    if all(n % w8.TILE_COLS == 0 for n in Ns) and K % w8.BLOCK_ROWS == 0:
        assert max(nbytes) - min(nbytes) <= w8.TILE_COLS * w8.BLOCK_ROWS
    for p, n in enumerate(Ns):
        for t in range(-(-n // w8.TILE_COLS)):
            held = [seen[(p, t, k)] for k in range(plan.ipt)]
            holders = [c for c, _ in held]
            assert holders == sorted(holders)
            assert all(ctas == tuple(sorted(set(holders)))
                       for _, ctas in held)
            assert tuple(sorted(set(holders))) == tuple(
                range(holders[0], holders[-1] + 1))
    return plan


def test_w8_plan_fits_the_kernel():
    # the launch geometry for 132 SMs: mt covers M with the fewest 8-row
    # tiles; at most one CTA per SM and one unit per CTA; the unit table
    # covers every (product, column, K step) exactly once, balanced to one
    # unit per CTA, each cut tile held by consecutive CTAs
    for M, Ns, K in PLAN_CASES:
        _check_units(M, Ns, K, 132)
    qkv = w8.plan_group(8, (4096, 1024, 1024), 4096, 132)
    assert qkv == w8.GroupPlan(1, (16, 4, 4), 64, 1536, 132)
    # tile-aligned grids: wo and down 8 CTAs a tile, gate/up a tile a CTA
    assert w8.plan_group(8, (4096,), 4096, 132).grid == 128
    assert w8.plan_group(8, (4096,), 14336, 132).grid == 128
    assert w8.plan_group(8, (14336, 14336), 4096, 132).grid == 112
    assert w8.plan_group(8, (128256,), 4096, 132).grid == 132
    assert w8.plan_group(64, (4096,), 14336, 132).mt == 8
    # a tiny group has fewer units than SMs: one unit per CTA
    tiny = w8.plan_group(1, (256,), 128, 132)
    assert tiny.grid == tiny.units == 2
    with pytest.raises(ValueError, match="multiples of 4"):
        w8.plan_group(8, (1002,), 4096, 132)
    with pytest.raises(ValueError, match="rows"):
        w8.plan_group(65, (1024,), 4096, 132)
    with pytest.raises(ValueError, match="products"):
        w8.plan_group(8, (4,) * 4, 4096, 132)
    with pytest.raises(ValueError, match="column tiles"):
        w8.plan_group(8, (w8.TILE_COLS * w8.MAX_TILES + 4,), 64, 132)


@settings(max_examples=60, deadline=None)
@given(M=st.integers(1, 64),
       Ns=st.lists(st.integers(1, 700).map(lambda n: 4 * n), min_size=1,
                   max_size=3),
       K=st.integers(1, 80).map(lambda k: 16 * k),
       sms=st.integers(1, 140))
def test_w8_plan_units_cover_small_shapes(M, Ns, K, sms):
    # a sweep of small and ragged shapes and SM counts
    _check_units(M, Ns, K, sms)


def test_w8_group_ref_is_the_products(w8_params):
    # the group's plain version is each product's, bit for bit, and JAX's
    # _mm of q/k/v and gate/up at tiny GQA widths (N of q != N of k/v)
    cfg, jparams, params = w8_params
    assert cfg.num_heads != cfg.num_kv_heads
    lp = llama._layer_params(params, 0)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    rng = np.random.default_rng(11)
    for names in (("wq", "wk", "wv"), ("gate", "up")):
        x = rng.normal(size=(5, cfg.hidden_size)).astype(np.float32)
        xt = torch.from_numpy(x)
        got = w8.w8_matmul_group_ref(xt, [(lp[n], lp[n + "_s"])
                                          for n in names])
        via = w8.w8_matmul_group(xt, [(lp[n], lp[n + "_s"]) for n in names])
        grouped = llama._products(xt, lp, names)
        for n, a, b, c in zip(names, got, via, grouped):
            np.testing.assert_array_equal(
                a.numpy(), w8.w8_matmul_ref(xt, lp[n], lp[n + "_s"]).numpy())
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(a.numpy(), c.numpy())
            want = jllama._mm(jnp.asarray(x), jlp, n)
            np.testing.assert_allclose(a.numpy(), np.asarray(want), **MM_TOL)
        assert [t.shape[1] for t in got] == [lp[n].shape[1] for n in names]


def _decode_cfgs(policy):
    kw = dict(
        pq=dict(n_subvec_per_head=2, n_subbits=4, kmeans_iters=4,
                select_block=16, adc_mode="v1", approx_topk=False,
                jhist_defer="on"),
        budget=dict(compress_ratio=0.3, recent_ratio=0.5, sink_size=4),
        cache=dict(kv_dtype="int8" if policy == "pq_search" else "bf16"),
        runtime=dict(policy=policy, prefill_bucket=64, max_new_tokens=24,
                     max_seq_len=2048, kernels="xla"))

    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=2),
            pq=mod.PQConfig(**kw["pq"]),
            budget=mod.BudgetConfig(**kw["budget"]),
            cache=mod.CacheConfig(**kw["cache"]),
            runtime=mod.RuntimeConfig(**kw["runtime"]))
    jecfg, ecfg = build(jconfig), build(config)
    return jecfg, dataclasses.replace(ecfg, runtime=dataclasses.replace(
        ecfg.runtime, kernels="auto"))


def _port_state(policy, jstate):
    np_state = jax.tree.map(np.asarray, jstate)
    if policy == "pq_search":
        return bridge.pq_state_from_numpy(np_state, device="cpu")
    return bridge.dense_state_from_numpy(np_state, device="cpu")


@pytest.mark.parametrize("policy", ["pq_search", "original"])
def test_w8_decode_matches_jax(w8_params, policy):
    # W8 weights: the prefill logits, then decode from the transplanted JAX
    # state (pq_search with an int8 tail and the joint histogram)
    _, jparams, params = w8_params
    jecfg, ecfg = _decode_cfgs(policy)
    P, true_len = 576, 540
    ids = np.random.default_rng(5).integers(0, 256, true_len)
    tokens = np.zeros(P, np.int32)
    tokens[P - true_len:] = ids
    jpol = jget_policy(jecfg, jcompute_budget(jecfg.budget, P, 24))
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, 24), device="cpu")
    jlogits, jstate = jax.jit(lambda p, s, t: jllama.prefill(
        jecfg.model, p, jpol, s, t, jnp.asarray(P - true_len),
        jnp.asarray(true_len)))(jparams, jpol.init_state(jnp.float32),
                                jnp.asarray(tokens))
    logits = llama.prefill(ecfg.model, params, pol,
                           pol.init_state(torch.float32),
                           torch.from_numpy(tokens).long(), P - true_len,
                           true_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    state = _port_state(policy, jstate)
    jstep = jax.jit(lambda p, s, t, pos: jllama.decode_step(
        jecfg.model, p, jpol, s, t, pos))
    tok = int(jnp.argmax(jlogits))
    for i in range(N_STEPS):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(true_len + i, jnp.int32))
        tl = llama.decode_step(ecfg.model, params, pol, state,
                               torch.tensor(tok), true_len + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        assert int(torch.argmax(tl)) == int(jnp.argmax(jl)), f"step {i}"
        tok = int(jnp.argmax(jl))


def test_w8_engine_matches_jax_engine(w8_params):
    # `original` draws nothing at random: the Engine with W8 weights gives
    # the JAX Engine's tokens
    _, jparams, params = w8_params
    jecfg, ecfg = _decode_cfgs("original")
    ids = np.random.default_rng(6).integers(0, 256, 700)
    want = JEngine(jecfg, jparams, dtype=jnp.float32).generate(ids, 10)
    got = Engine(ecfg, params, dtype=torch.float32,
                 device="cpu").generate(ids, 10)
    assert got.tokens == want.tokens


def test_w8_decode_groups_products(w8_params, monkeypatch):
    # with int8 weights a decode step makes one group call for q/k/v and
    # one for gate/up per layer (2 L; wo, down and the LM head stay single
    # products), the Engine's W8 requests still give the JAX Engine's
    # tokens, and prefill rows (past MAX_ROWS) make no group call
    cfg, jparams, params = w8_params
    calls = []
    real = w8.w8_matmul_group

    def counted(x, prods, **kw):
        calls.append(len(prods))
        return real(x, prods, **kw)
    monkeypatch.setattr(w8, "w8_matmul_group", counted)
    jecfg, ecfg = _decode_cfgs("original")
    ids = np.random.default_rng(8).integers(0, 256, 700)
    want = JEngine(jecfg, jparams, dtype=jnp.float32).generate(ids, 6)
    got = Engine(ecfg, params, dtype=torch.float32,
                 device="cpu").generate(ids, 6)
    assert got.tokens == want.tokens
    L = cfg.num_layers
    assert calls == [3, 2] * L * (len(got.tokens) - 1)
    # one batched step of 3 slots
    calls.clear()
    pol = get_policy(ecfg, compute_budget(ecfg.budget, 256, 24),
                     device="cpu")
    state = pol.init_batched_state(3, torch.float32)
    llama.decode_step_batched(ecfg.model, params, pol, state,
                              torch.tensor([1, 2, 3]),
                              torch.tensor([0, 0, 0]))
    assert calls == [3, 2] * L


@pytest.mark.parametrize("policy", ["pq_search", "original"])
def test_w8_batched_decode_matches_jax(w8_params, policy):
    # three slots prefilled by JAX and inserted into its batched state,
    # transplanted; 2 chunks of 5 steps with the ring flushed after each
    # (BatchedDecoder's eager mode against JAX's decode_loop_batched)
    _, jparams, params = w8_params
    jecfg, ecfg = _decode_cfgs(policy)
    P, lengths, chunk = 256, (256, 243, 230), 5
    jpol = jget_policy(jecfg, jcompute_budget(jecfg.budget, P, 24))
    bstate = jpol.init_batched_state(len(lengths), jnp.float32)
    prefill = jax.jit(lambda p, s, t, pad, n: jllama.prefill(
        jecfg.model, p, jpol, s, t, pad, n))
    rng = np.random.default_rng(21)
    tok0, pos0 = [], []
    for slot, n in enumerate(lengths):
        ids = np.zeros(P, np.int32)
        ids[P - n:] = rng.integers(0, 256, n)
        lg, s = prefill(jparams, jpol.init_state(jnp.float32),
                        jnp.asarray(ids), jnp.asarray(P - n), jnp.asarray(n))
        bstate = jpol.insert_slot(bstate, s, jnp.asarray(slot, jnp.int32))
        tok0.append(int(jnp.argmax(lg)))
        pos0.append(n)
    tok0, pos0 = np.asarray(tok0, np.int32), np.asarray(pos0, np.int32)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, 24), device="cpu")
    state = _port_state(policy, bstate)
    jloop = jax.jit(lambda p, s, t, pos: jllama.decode_loop_batched(
        jecfg.model, p, jpol, s, t, pos, chunk))
    jstep = jax.jit(lambda p, s, t, pos: jllama.decode_step_batched(
        jecfg.model, p, jpol, s, t, pos))
    # one step's logits, on a copy of the state
    jl, _ = jstep(jparams, bstate, jnp.asarray(tok0), jnp.asarray(pos0))
    tl = llama.decode_step_batched(ecfg.model, params, pol,
                                   _port_state(policy, bstate),
                                   torch.from_numpy(tok0),
                                   torch.from_numpy(pos0))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    want, jt, jp = [], jnp.asarray(tok0), jnp.asarray(pos0)
    for _ in range(2):
        toks, bstate = jloop(jparams, bstate, jt, jp)
        want.append(np.asarray(toks))
        jt, jp = toks[-1], jp + chunk
    dec = BatchedDecoder(ecfg.model, params, pol, state, chunk=chunk,
                         graph=False, device="cpu")
    got = dec.generate(torch.from_numpy(tok0), torch.from_numpy(pos0),
                       2 * chunk)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want))
