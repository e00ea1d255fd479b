"""The port's batch-as-heads decode against the JAX package's, on the CPU.

B sequence slots are prefilled by the JAX package, inserted into its
batched state and transplanted into the port through ``bridge`` (the
port's k-means++ draws from torch, so its own codebooks would differ). Both
sides then decode the same steps in float32: the JAX package on its XLA
route, the port on its kernel route (``kernels="auto"``, whose wrappers take
their plain versions on a CPU tensor). Chunks of 5 steps flush the ring 4
times over 20 tokens. Greedy tokens must be identical, logits within
rtol = atol = 1e-4 (the same float32 arithmetic summed in another order:
the port's K1 attends the local window in the blocks' online-softmax pass,
JAX's XLA route as a separate segment), and the joint histograms bit for
bit after each flush (integer counts). ``torch.set_num_threads(1)``: the
suite runs with several workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu import config as jconfig
from pqcache_tpu.core.budget import compute_budget as jcompute_budget
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.policies.base import get_policy as jget_policy
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
from pqcache_tpu_torch.runtime.generate import Engine

torch.set_num_threads(1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
P = 256                     # the prompts' bucket: one budget for every slot
CHUNK, N_TOKENS = 5, 20
LENGTHS = (256, 243, 230)   # the slots' prompt lengths


def _ecfgs(policy="pq_search", select_block=16, kv_dtype="bf16",
           scorer="auto", defer="off", model_kw=None, **pq_kw):
    kw = dict(
        pq=dict(dict(n_subvec_per_head=2, n_subbits=4, kmeans_iters=4,
                     select_block=select_block, scorer=scorer, adc_mode="v1",
                     approx_topk=False, jhist_defer=defer), **pq_kw),
        budget=dict(compress_ratio=0.3, recent_ratio=0.5, sink_size=4),
        cache=dict(kv_dtype=kv_dtype),
        runtime=dict(policy=policy, prefill_bucket=64, max_new_tokens=24,
                     max_seq_len=512, kernels="xla"))
    model_kw = dict(num_layers=2, **(model_kw or {}))

    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(**model_kw),
            pq=mod.PQConfig(**kw["pq"]),
            budget=mod.BudgetConfig(**kw["budget"]),
            cache=mod.CacheConfig(**kw["cache"]),
            runtime=mod.RuntimeConfig(**kw["runtime"]))
    return build(jconfig), build(config)


def _with_kernels(ecfg, kernels):
    return dataclasses.replace(ecfg, runtime=dataclasses.replace(
        ecfg.runtime, kernels=kernels))


def _params(jecfg):
    jparams = jllama.init_params(jecfg.model, jax.random.PRNGKey(7),
                                 dtype=jnp.float32)
    return jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _jax_batched(jecfg, jparams, lengths=LENGTHS, seed=21):
    """The JAX policy and its batched state with one prefilled prompt per
    slot; the slots' first tokens and positions."""
    jb = jcompute_budget(jecfg.budget, P, jecfg.runtime.max_new_tokens)
    jpol = jget_policy(jecfg, jb)
    bstate = jpol.init_batched_state(len(lengths), jnp.float32)
    rng = np.random.default_rng(seed)
    prefill = jax.jit(lambda p, s, t, pad, n: jllama.prefill(
        jecfg.model, p, jpol, s, t, pad, n))
    toks, pos = [], []
    for slot, n in enumerate(lengths):
        ids = np.zeros(P, np.int32)
        ids[P - n:] = rng.integers(0, jecfg.model.vocab_size, size=n)
        logits, s = prefill(jparams, jpol.init_state(jnp.float32),
                            jnp.asarray(ids), jnp.asarray(P - n, jnp.int32),
                            jnp.asarray(n, jnp.int32))
        bstate = jpol.insert_slot(bstate, s, jnp.asarray(slot, jnp.int32))
        toks.append(int(jnp.argmax(logits)))
        pos.append(n)
    return jpol, bstate, np.asarray(toks, np.int32), np.asarray(pos, np.int32)


def _port_state(jpol_name, jstate):
    np_state = jax.tree.map(np.asarray, jstate)
    if jpol_name == "pq_search":
        return bridge.pq_state_from_numpy(np_state, device="cpu")
    return bridge.dense_state_from_numpy(np_state, device="cpu")


def _assert_same_state(policy, state, jstate):
    """Counters equal; a PQ state's codes, tail and histogram too."""
    if policy == "pq_search":
        np.testing.assert_array_equal(state.n_cand.numpy(),
                                      np.asarray(jstate.n_cand))
        assert (state.ring_r is None) == (jstate.ring_r is None)
        if state.ring_r is not None:
            assert int(state.ring_r) == int(jstate.ring_r)
        np.testing.assert_array_equal(state.codes.numpy(),
                                      np.asarray(jstate.codes))
        np.testing.assert_allclose(state.kv_tail.float().numpy(),
                                   np.asarray(jstate.kv_tail, np.float32),
                                   rtol=1e-6, atol=1e-6)
        if jstate.jhist is not None:
            np.testing.assert_array_equal(state.jhist.numpy(),
                                          np.asarray(jstate.jhist))
    else:
        np.testing.assert_array_equal(state.length.numpy(),
                                      np.asarray(jstate.length))
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))


# (policy, select_block, kv tail, scorer, jhist_defer): the joint-histogram
# scorer with the per-step join and deferred; the fused block scorer K3
# (scorer "kernel": K3 on the port's kernel route, JAX's XLA route ranks the
# same block mass from the gather-sum scores); the per-token path (K5 with
# adc_mode "v1", the plain row gather); the dense `original` arm
BATCHED_CASES = [
    ("pq_search", 16, "bf16", "auto", "off"),
    ("pq_search", 16, "bf16", "auto", "on"),
    ("pq_search", 16, "int8", "auto", "on"),
    ("pq_search", 16, "int8", "auto", "off"),
    ("pq_search", 16, "bf16", "kernel", "off"),
    ("pq_search", 1, "bf16", "auto", "off"),
    ("pq_search", 1, "int8", "auto", "off"),
    ("original", 16, "bf16", "auto", "off"),
]


def _case_id(c):
    if c[0] == "original":
        return "original"
    scorer = {1: "token", 16: "jhist" if c[3] == "auto" else "k3"}[c[1]]
    return f"{scorer}-{c[2]}" + (f"-defer-{c[4]}" if scorer == "jhist"
                                 else "")


@pytest.mark.parametrize("case", BATCHED_CASES,
                         ids=[_case_id(c) for c in BATCHED_CASES])
def test_batched_decode_matches_jax(case):
    policy, select_block, kv_dtype, scorer, defer = case
    jecfg, ecfg = _ecfgs(policy, select_block, kv_dtype, scorer, defer)
    jparams, params = _params(jecfg)
    jpol, jstate, tok0, pos0 = _jax_batched(jecfg, jparams)
    pol = get_policy(_with_kernels(ecfg, "auto"),
                     compute_budget(ecfg.budget, P,
                                    ecfg.runtime.max_new_tokens),
                     device="cpu")
    if policy == "pq_search":
        assert pol.ring_k == jpol.ring_k > CHUNK
        assert pol._jhist_defer(_port_state(policy, jstate)) == (
            select_block > 1 and scorer == "auto" and defer == "on")
    state = _port_state(policy, jstate)
    jstep = jax.jit(lambda p, s, t, pos: jllama.decode_step_batched(
        jecfg.model, p, jpol, s, t, pos))
    jflush = (jax.jit(jpol.flush_ring_batched) if policy == "pq_search"
              else (lambda s: s))
    jtok, jpos = jnp.asarray(tok0), jnp.asarray(pos0)
    tok, pos = torch.from_numpy(tok0), torch.from_numpy(pos0)
    for c in range(N_TOKENS // CHUNK):
        for i in range(CHUNK):
            jl, jstate = jstep(jparams, jstate, jtok, jpos)
            tl = llama.decode_step_batched(ecfg.model, params, pol, state,
                                           tok, pos)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       err_msg=f"chunk {c} step {i}",
                                       **LOGIT_TOL)
            jtok = jnp.argmax(jl, -1).astype(jnp.int32)
            tok = torch.argmax(tl, -1).to(torch.int32)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            jpos, pos = jpos + 1, pos + 1
        jstate = jflush(jstate)
        if policy == "pq_search":
            pol.flush_ring_batched(state)
        # after each flush: tails, codes, counters and histograms as JAX's
        _assert_same_state(policy, state, jstate)


def test_decode_loop_batched_and_graph_runner_match_jax():
    # the port's chunked loop (decode_loop_batched) and the graph runner's
    # eager mode give JAX's decode_loop_batched tokens over several flushes
    jecfg, ecfg = _ecfgs("pq_search", 16, "int8", defer="on")
    jparams, params = _params(jecfg)
    jpol, jstate, tok0, pos0 = _jax_batched(jecfg, jparams)
    pol = get_policy(_with_kernels(ecfg, "auto"),
                     compute_budget(ecfg.budget, P,
                                    ecfg.runtime.max_new_tokens),
                     device="cpu")
    state, state2 = (_port_state("pq_search", jstate) for _ in range(2))
    jloop = jax.jit(lambda p, s, t, pos: jllama.decode_loop_batched(
        jecfg.model, p, jpol, s, t, pos, CHUNK))
    jt, jp = jnp.asarray(tok0), jnp.asarray(pos0)
    tok, pos = torch.from_numpy(tok0), torch.from_numpy(pos0)
    want, got = [], []
    for _ in range(N_TOKENS // CHUNK):
        toks, jstate = jloop(jparams, jstate, jt, jp)
        want.append(np.asarray(toks))
        jt, jp = toks[-1], jp + CHUNK
        out = llama.decode_loop_batched(ecfg.model, params, pol, state, tok,
                                        pos, CHUNK)
        got.append(out.numpy())
        tok, pos = out[-1], pos + CHUNK
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    _assert_same_state("pq_search", state, jstate)
    runner = BatchedDecoder(ecfg.model, params, pol, state2, chunk=CHUNK,
                            graph=False, device="cpu")
    out = runner.generate(torch.from_numpy(tok0), torch.from_numpy(pos0),
                          N_TOKENS)
    np.testing.assert_array_equal(out.numpy(), np.concatenate(want))
    _assert_same_state("pq_search", state2, jstate)
    with pytest.raises(ValueError):
        llama.decode_loop_batched(ecfg.model, params, pol, state, tok, pos,
                                  pol.ring_k + 1)
    with pytest.raises(ValueError, match="CUDA graph"):
        BatchedDecoder(ecfg.model, params, pol, state, device="cpu")


def test_mid_ring_logits_match_jax():
    # mirrors tests/test_jhist.py::test_ring_batched_decode_pallas_matches_
    # xla_logits: head_dim 128, deferred joins, 3 steps without a flush
    # (ring_r = 3: the window in the tail is [n_cand, n_cand + local - 3)),
    # then one step's logits from the port's kernel route (the window
    # through K1's plain version) against JAX's XLA route
    jecfg, ecfg = _ecfgs("pq_search", 16, "bf16", defer="on", n_subbits=5,
                         model_kw=dict(num_heads=4, num_kv_heads=2,
                                       head_dim=128, hidden_size=128))
    jparams, params = _params(jecfg)
    jpol, jstate, _, _ = _jax_batched(jecfg, jparams, lengths=(256, 243),
                                      seed=11)
    jstep = jax.jit(lambda p, s, t, pos: jllama.decode_step_batched(
        jecfg.model, p, jpol, s, t, pos))
    tok = jnp.asarray([7, 9], jnp.int32)
    pos = jnp.asarray([256, 243], jnp.int32)
    for _ in range(3):
        logits, jstate = jstep(jparams, jstate, tok, pos)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        pos = pos + 1
    assert int(jstate.ring_r) == 3
    jl, _ = jstep(jparams, jstate, tok, pos)
    pol = get_policy(_with_kernels(ecfg, "auto"),
                     compute_budget(ecfg.budget, P, 24), device="cpu")
    state = _port_state("pq_search", jstate)
    tl = llama.decode_step_batched(ecfg.model, params, pol, state,
                                   torch.from_numpy(np.array(tok)),
                                   torch.from_numpy(np.array(pos)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert int(state.ring_r) == 4


def test_batched_equals_single_sequence_engine():
    # mirrors tests/test_batch_engine.py::test_batch_as_heads_matches_
    # single_exact: prompts as long as the bucket, so every slot has the
    # single engine's budget; the port's own prefill (its own codebooks)
    # inserted into 3 slots decodes the single-sequence Engine's tokens
    _, ecfg = _ecfgs("pq_search", 16, "bf16")
    ecfg = _with_kernels(ecfg, "auto")
    params = llama.init_params(ecfg.model, torch.Generator().manual_seed(3),
                               dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, ecfg.model.vocab_size, size=P) for _ in range(2))
    eng = Engine(ecfg, params, dtype=torch.float32, device="cpu")
    n_new = 8
    ref = {k: eng.generate(ids, n_new).tokens for k, ids in (("a", a),
                                                              ("b", b))}
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P,
                                          ecfg.runtime.max_new_tokens),
                     device="cpu")
    bstate = pol.init_batched_state(3, torch.float32)
    first = []
    for slot, ids in enumerate((a, b, a)):
        st = pol.init_state(torch.float32)
        logits = llama.prefill(ecfg.model, params, pol, st,
                               torch.from_numpy(ids), 0, P)
        pol.insert_slot(bstate, st, slot)
        first.append(int(torch.argmax(logits)))
    out = llama.decode_loop_batched(
        ecfg.model, params, pol, bstate, torch.tensor(first),
        torch.full((3,), P), n_new - 1)
    got = [[first[s]] + out[:, s].tolist() for s in range(3)]
    assert got == [ref["a"], ref["b"], ref["a"]]


def test_ring_pad_keeps_valid_rows():
    # a local window above 300 with ring_cap 300: ring_k = 300 exceeds the
    # reference's fixed pad of 256. The port pads by ring_k rounded up to
    # 256 (512), so a flush after one step of the last chunk, whose rows
    # run 299 past the valid tail, stays inside the buffer and leaves every
    # valid row as it was
    _, ecfg = _ecfgs("pq_search", 16, "bf16", ring_cap=300)
    Pl = 2048
    budget = compute_budget(ecfg.budget, Pl, 16)
    assert budget.local > 300
    pol = get_policy(_with_kernels(ecfg, "auto"), budget, device="cpu")
    assert pol.ring_k == 300 and pol._batched_alloc()["tail_pad"] == 512
    st = pol.init_batched_state(1, torch.float32)
    L, Hf, N, D2 = st.kv_tail.shape
    assert N == budget.n_tail_max + 512
    gen = torch.Generator().manual_seed(0)
    st.kv_tail.copy_(torch.randn(st.kv_tail.shape, generator=gen))
    st.centroids.copy_(torch.randn(st.centroids.shape, generator=gen))
    # the tail holds n_cand + local - ring_r valid rows; after this step
    # n_cand + local reaches n_tail_max, the most the budget reserves
    n_cand = budget.n_tail_max - budget.local - 1
    st.n_cand.fill_(n_cand)
    valid = n_cand + budget.local
    before = st.kv_tail.clone()
    codes_before = st.codes.clone()
    k_new = torch.randn((L, Hf, D2 // 2), generator=gen)
    shared = pol.shared_pre_batched(st)
    pol.commit_appends_batched(st, (k_new, 2 * k_new), shared)
    pol.shared_post_batched(st, shared)
    pol.flush_ring_batched(st)
    # the flush wrote from the valid end: its ring_k rows reach 299 rows
    # past the valid tail, beyond a 256-row pad
    assert valid + pol.ring_k > budget.n_tail_max + 256
    assert torch.equal(st.kv_tail[:, :, :valid], before[:, :, :valid])
    assert torch.equal(st.codes[..., :valid], codes_before[..., :valid])
    assert torch.equal(st.kv_tail[:, :, valid],
                       torch.cat([k_new, 2 * k_new], -1))
    assert int(st.ring_r) == 0 and int(st.n_cand[0]) == n_cand + 1


def test_fetch_pair_decodes_like_no_pair():
    # PQConfig.fetch_pair is accepted (select_block <= 128) and gives the
    # same tokens: K1 computes the same function with the pair fetch
    _, ecfg = _ecfgs("pq_search", 16, "int8")
    params = llama.init_params(ecfg.model, torch.Generator().manual_seed(5),
                               dtype=torch.float32, device="cpu")
    ids = np.random.default_rng(4).integers(0, ecfg.model.vocab_size, 300)
    toks = {}
    for pair in (False, True):
        e = _with_kernels(dataclasses.replace(ecfg, pq=dataclasses.replace(
            ecfg.pq, fetch_pair=pair)), "auto")
        res = Engine(e, params, dtype=torch.float32, device="cpu").generate(
            ids, 8)
        assert res.policy_name == "pq_search"
        toks[pair] = res.tokens
    assert toks[True] == toks[False]
    bad = dataclasses.replace(ecfg, pq=dataclasses.replace(
        ecfg.pq, fetch_pair=True, select_block=256))
    with pytest.raises(ValueError, match="fetch_pair"):
        get_policy(bad, compute_budget(bad.budget, 1024, 16), device="cpu")


def test_decoder_refuses_steps_past_the_reservation():
    # the state holds the budget's max_new_tokens past each prompt; a chunk
    # or a step beyond is refused before it runs and changes nothing (on the
    # card its writes would be clamped onto the last rows)
    _, ecfg = _ecfgs("original")
    params = llama.init_params(ecfg.model, torch.Generator().manual_seed(1),
                               dtype=torch.float32, device="cpu")
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, 3), device="cpu")
    state = pol.init_batched_state(2, torch.float32)
    state.length.fill_(P)
    state.pos.fill_(P)
    dec = BatchedDecoder(ecfg.model, params, pol, state, chunk=2,
                         graph=False, device="cpu")
    tok = torch.zeros(2, dtype=torch.int32)
    pos = torch.full((2,), P, dtype=torch.int32)
    out = dec.decode(tok, pos, 2)
    with pytest.raises(ValueError, match="room"):
        dec.decode(out[-1], pos + 2, 2)
    assert state.length.tolist() == [P + 2] * 2
    dec.decode(out[-1], pos + 2, 1)
    with pytest.raises(ValueError, match="room"):
        dec.step()
    assert state.length.tolist() == [P + 3] * 2 and dec.steps_left == 0


def test_commit_without_ring_matches_jax():
    # a budget with no local window has no ring (ring_k = min(ring_cap,
    # local) = 0): each step encodes and writes every slot's token at
    # n_cand + local and joins the token at n_cand into the histogram
    from pqcache_tpu.core.budget import Budget as JBudget
    from pqcache_tpu_torch.core.budget import Budget
    jecfg, ecfg = _ecfgs("pq_search", 16, "int8")
    bkw = dict(prefill_len=P, sink=4, local=0, topk=37, max_new_tokens=24)
    jpol = jget_policy(jecfg, JBudget(**bkw))
    pol = get_policy(ecfg, Budget(**bkw), device="cpu")
    assert jpol.ring_k == pol.ring_k == 0
    B, L, Hk = 2, ecfg.model.num_layers, ecfg.model.num_kv_heads
    D = ecfg.model.head_dim
    rng = np.random.default_rng(12)
    jst = jpol.init_batched_state(B, jnp.float32)
    jst = jst.replace(
        codes=jnp.asarray(rng.integers(0, pol.C, size=jst.codes.shape),
                          jnp.uint8),
        centroids=jnp.asarray(rng.normal(size=jst.centroids.shape),
                              jnp.float32),
        k_scale=jnp.asarray(rng.uniform(0.01, 0.05, size=jst.k_scale.shape),
                            jnp.float32),
        v_scale=jnp.asarray(rng.uniform(0.01, 0.05, size=jst.v_scale.shape),
                            jnp.float32),
        n_cand=jnp.asarray([100, 57], jnp.int32))
    assert jst.ring_kv is None
    state = _port_state("pq_search", jst)
    jcommit = jax.jit(lambda s, k, v: jpol.shared_post_batched(
        jpol.commit_appends_batched(s, (k, v), {"n_cand": s.n_cand}), None))
    for _ in range(3):
        k, v = (rng.normal(size=(L, B * Hk, D)).astype(np.float32)
                for _ in range(2))
        jst = jcommit(jst, jnp.asarray(k), jnp.asarray(v))
        shared = pol.shared_pre_batched(state)
        pol.commit_appends_batched(state, (torch.from_numpy(k),
                                           torch.from_numpy(v)), shared)
        pol.shared_post_batched(state, shared)
    np.testing.assert_array_equal(state.kv_tail.numpy(),
                                  np.asarray(jst.kv_tail))
    _assert_same_state("pq_search", state, jst)
