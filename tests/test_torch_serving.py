"""The port's serving path against the JAX package's, on the CPU.

The same float32 parameters (JAX ``init_params`` moved through ``bridge``;
for W8 JAX's ``quantize_weight_tree`` of them) and the same prompts go
through the JAX package's ``BatchEngine`` on its XLA route and the port's
on its kernel route (``kernels="auto"``: the wrappers take their plain
versions on a CPU tensor; decode eager, ``graph=False``). Greedy tokens
must be identical for every request: a pool of 2 slots serving 3 or 4
requests (so that slots retire and admit), chunked admission through a
pool length the chunk plan pads, interleaved admission (the port's
monolithic one must agree too), a pool-wide shared prefix, and W8 weights
through interleaved admission. ``pq_search`` trains codebooks from k-means++
seeds that torch cannot replay from ``jax.random``, so the port's k-means
starts from JAX's seeds (as ``tests/test_torch_prefill.py`` does); with
equal-length prompts at the pool length the batch also gives the port's
single-sequence ``Engine`` tokens. A finished slot that decodes on past its
reservation must leave a live slot's tokens and rows unchanged, and write
nothing outside its buffers (out-of-range indexing raises on the CPU). The
serving metrics ``summarize`` gives must be JAX's on the same timing dict,
and both harnesses run at toy widths; the latency harness holds one weight
tree at a time. ``torch.set_num_threads(1)``: the suite runs with several
workers.
"""

import copy
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu import config as jconfig
from pqcache_tpu.core import pq as jpq
from pqcache_tpu.core import quant as jquant
from pqcache_tpu.harness import serving as jserving
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from pqcache_tpu.runtime.generate import Engine as JEngine
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.harness import latency, serving
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
from pqcache_tpu_torch.runtime.generate import Engine

torch.set_num_threads(1)
P, NEW, CHUNK = 256, 8, 3


def _ecfgs(policy="pq_search", **rt):
    kw = dict(
        pq=dict(n_subvec_per_head=2, n_subbits=4, kmeans_iters=4,
                select_block=16, adc_mode="v1", approx_topk=False),
        budget=dict(compress_ratio=0.3, recent_ratio=0.5, sink_size=4),
        runtime=dict(dict(policy=policy, prefill_bucket=64,
                          max_new_tokens=16, max_seq_len=512,
                          kernels="xla"), **rt))

    def build(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(num_layers=2),
            pq=mod.PQConfig(**kw["pq"]),
            budget=mod.BudgetConfig(**kw["budget"]),
            runtime=mod.RuntimeConfig(**kw["runtime"]))
    jecfg, ecfg = build(jconfig), build(config)
    return jecfg, dataclasses.replace(ecfg, runtime=dataclasses.replace(
        ecfg.runtime, kernels="auto"))


@pytest.fixture(scope="module")
def model():
    jecfg, _ = _ecfgs()
    jparams = jllama.init_params(jecfg.model, jax.random.PRNGKey(7),
                                 dtype=jnp.float32)
    to_port = lambda t: bridge.params_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, t), device="cpu")
    jp8 = jquant.quantize_weight_tree(jparams)
    return {"f32": (jparams, to_port(jparams)), "w8": (jp8, to_port(jp8))}


# JAX's k-means++ seeds, one compiled program per point shape (the valid
# length traced, as JAX's prefill traces it)
_jax_seeds = jax.jit(lambda x, n, C: jpq.kmeans(
    x, C, iters=0, seed=4321, valid_len=n).centroids, static_argnums=2)


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    """The port's k-means starts from JAX's k-means++ centroids of the
    same points and seed."""
    orig = pq.kmeans

    def kmeans(x, C, iters, *, valid_len=None, generator=None, **kw):
        c0 = _jax_seeds(jnp.asarray(x.numpy()),
                        jnp.asarray(valid_len, jnp.int32), C)
        return orig(x, C, iters, valid_len=valid_len,
                    init_centroids=torch.from_numpy(np.array(c0)), **kw)
    monkeypatch.setattr(pq, "kmeans", kmeans)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


# case: (policy, weights, runtime overrides, prompt lengths, prefix length,
# pool length); every case serves more requests than its 2 slots
CASES = {
    "pq_search": ("pq_search", "f32", {}, (256, 230, 256), 0, P),
    "original": ("original", "f32", {}, (256, 200, 256), 0, P),
    # the chunk plan pads the pool's 200 to 256: 4 slabs of 64, interleaved
    "chunked-interleaved": ("pq_search", "f32", dict(prefill_chunk=64),
                            (200, 187, 174, 161), 0, 200),
    "prefix": ("pq_search", "f32", {}, (64, 50, 64), 192, P),
    "w8-interleaved": ("pq_search", "w8", dict(prefill_chunk=64),
                       (256, 245, 234), 0, P),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_engine_gives_jax_tokens(model, jax_kmeans_init, case):
    policy, weights, rt, lengths, n_pre, pool_len = CASES[case]
    jparams, params = model[weights]
    jecfg, ecfg = _ecfgs(policy, **rt)
    prompts = _prompts(13, lengths)
    reqs = list(enumerate(prompts))
    jpre = pre = None
    if n_pre:
        pre_ids = _prompts(14, (n_pre,))[0]
        jpre = JEngine(jecfg, jparams, dtype=jnp.float32).prefill_prefix(
            pre_ids)
        pre = Engine(ecfg, params, dtype=torch.float32,
                     device="cpu").prefill_prefix(pre_ids)
    want = JBatchEngine(jecfg, jparams, batch_size=2, prefill_len=pool_len,
                        max_new_tokens=NEW, dtype=jnp.float32,
                        prefix=jpre).run(reqs, chunk=CHUNK)
    be = BatchEngine(ecfg, params, batch_size=2, prefill_len=pool_len,
                     max_new_tokens=NEW, dtype=torch.float32, prefix=pre,
                     device="cpu")
    assert be.interleave == ("interleaved" in case)
    got = be.run(reqs, chunk=CHUNK)
    assert set(got) == set(want) == set(range(len(prompts)))
    for sid in got:
        assert got[sid] == want[sid], (sid, got[sid], want[sid])
    if be.interleave:
        # the monolithic (layer-major) admission gives the same streams
        mono = BatchEngine(ecfg, params, batch_size=2, prefill_len=pool_len,
                           max_new_tokens=NEW, dtype=torch.float32,
                           interleave="off", device="cpu")
        assert mono.P == be.P == P and be.P % be._pf_chunk == 0
        assert mono.run(reqs, chunk=CHUNK) == got
    if case in ("pq_search", "original"):
        # request 2 took slot 0 after 0 and 1 finished; slot 1 decoded on,
        # with an empty queue, past its reservation, and request 2 still
        # gives the single-sequence Engine's tokens (as do 0, at P)
        past = int(be.bstate.pos[1]) - lengths[1]
        assert past > be.budget.max_new_tokens, past
        eng = Engine(ecfg, params, dtype=torch.float32, device="cpu")
        for sid in (0, 2):
            assert eng.generate(prompts[sid], NEW).tokens == got[sid]


# finished-slot cases: (policy, PQConfig overrides, BudgetConfig overrides);
# no local window, no ring: the appends commit per step
PAST_CASES = {
    "jhist-deferred": ("pq_search", dict(jhist_defer="on"), {}),
    "jhist": ("pq_search", dict(jhist_defer="off"), {}),
    "no-ring": ("pq_search", {}, dict(recent_ratio=0.0)),
    "per-token": ("pq_search", dict(select_block=1), {}),
    "original": ("original", {}, {}),
}


@pytest.mark.parametrize("case", list(PAST_CASES))
def test_finished_slot_past_its_buffers_leaves_live_slot(model, case):
    # slot 0's counters pushed past the end of its buffers (a finished slot
    # that a long-lived pool kept decoding): two chunks write nothing out
    # of range, and slot 1's tokens and rows are those of a twin whose
    # slot 0 sits at its prompt end
    policy, pq_kw, budget_kw = PAST_CASES[case]
    _, params = model["f32"]
    _, ecfg = _ecfgs(policy)
    ecfg = dataclasses.replace(
        ecfg, pq=dataclasses.replace(ecfg.pq, **pq_kw),
        budget=dataclasses.replace(ecfg.budget, **budget_kw))
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, NEW), device="cpu")
    bstate = pol.init_batched_state(2, torch.float32)
    first, pos = [], []
    for slot, ids in enumerate(_prompts(21, (256, 240))):
        st = pol.init_state(torch.float32)
        tokens = np.zeros(P, np.int64)
        tokens[P - len(ids):] = ids
        lg = llama.prefill(ecfg.model, params, pol, st,
                           torch.from_numpy(tokens), P - len(ids), len(ids))
        pol.insert_slot(bstate, st, slot)
        first.append(int(torch.argmax(lg)))
        pos.append(len(ids))
    twin = copy.deepcopy(bstate)
    if policy == "pq_search":
        bstate.n_cand[0] = bstate.kv_tail.shape[2] + 37
    else:
        bstate.length[0] = bstate.k_cache.shape[2] + 37
    bstate.pos[0] += 5000
    chunk = getattr(pol, "ring_k", 0) or 4
    toks = torch.tensor(first, dtype=torch.int32)
    p = torch.tensor(pos, dtype=torch.int32)
    outs = [BatchedDecoder(ecfg.model, params, pol, s, chunk=chunk,
                           graph=False, device="cpu", check_room=False)
            .generate(toks, p, 2 * chunk) for s in (bstate, twin)]
    assert torch.equal(outs[0][:, 1], outs[1][:, 1])
    Hk = ecfg.model.num_kv_heads
    for f in dataclasses.fields(bstate):
        a, b = getattr(bstate, f.name), getattr(twin, f.name)
        if isinstance(a, torch.Tensor) and a.dim() >= 2 and f.name != "phi":
            assert torch.equal(a[:, Hk:], b[:, Hk:]), f.name


def test_decoder_room_check_is_the_callers():
    # a standalone decoder refuses steps past the reservation; an engine's
    # decoder (check_room=False) leaves the check to the engine
    _, ecfg = _ecfgs("original")
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, 4), device="cpu")
    st = pol.init_batched_state(1, torch.float32)
    params = llama.init_params(ecfg.model, torch.Generator(), torch.float32,
                               "cpu")
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="room"):
        BatchedDecoder(ecfg.model, params, pol, st, chunk=8, graph=False,
                       device="cpu").decode(z, z, 8)
    out = BatchedDecoder(ecfg.model, params, pol, st, chunk=8, graph=False,
                         device="cpu", check_room=False).generate(z, z, 16)
    assert out.shape == (16, 1)


@pytest.mark.parametrize("policy", ["h2o", "infllm"])
def test_batch_engine_refuses_policies_without_batched_decode(model, policy):
    # as the JAX engine does: only pq_search and original decode batch-as-
    # heads; the refusal comes before the params reach the device
    _, params = model["f32"]
    _, ecfg = _ecfgs(policy, prefill_chunk=64)
    with pytest.raises(ValueError, match="batch-as-heads"):
        BatchEngine(ecfg, params, batch_size=2, prefill_len=P,
                    max_new_tokens=NEW, dtype=torch.float32, device="cpu")


def test_timing_arrivals_spf_and_summarize(model):
    _, params = model["f32"]
    _, ecfg = _ecfgs("original")
    prompts = _prompts(9, (256, 256, 256))

    def engine(B=2, new=6):
        return BatchEngine(ecfg, params, batch_size=B, prefill_len=P,
                           max_new_tokens=new, dtype=torch.float32,
                           device="cpu")
    be = engine()
    base = be.run(list(enumerate(prompts)), chunk=3)
    timing = {}
    out = be.run(list(enumerate(prompts)), chunk=3,
                 arrivals={0: 0.0, 1: 0.0, 2: 0.15}, timing=timing)
    assert out == base                       # instrumentation is inert
    assert set(timing) == {0, 1, 2}
    for sid, ev in timing.items():
        assert ev["arrive"] <= ev["admit"] <= ev["first"] <= ev["done"]
        assert len(ev["token_times"]) == len(out[sid])
        assert ev["token_times"] == sorted(ev["token_times"])
    assert timing[2]["admit"] >= 0.15        # not admitted before arrival
    m = serving.summarize(timing, wall_s=1.0)
    assert m == jserving.summarize(timing, wall_s=1.0)
    assert m["agg_tok_s"] == 18.0            # 3 x 6 tokens / 1 s
    assert m["ttft_p95_s"] >= m["wait_p95_s"] >= 0.0 and "tbt_p50_ms" in m

    # spf: behind a full pool of 1, the short prompt admits before the long
    long_p, short_p = prompts[0], prompts[1][:64]
    one = engine(B=1)
    timing = {}
    one.run([(0, long_p), (1, long_p), (2, short_p)], chunk=3, timing=timing,
            admission="spf")
    assert timing[2]["admit"] < timing[1]["admit"]
    # fifo with a late head: the arrived requests admit first
    timing = {}
    one.run([(0, long_p), (1, short_p), (2, short_p)], chunk=3,
            arrivals={0: 0.4, 1: 0.0, 2: 0.0}, timing=timing)
    assert timing[1]["admit"] < timing[0]["admit"] > timing[2]["admit"]
    with pytest.raises(ValueError, match="fifo/spf"):
        one.run([], admission="lifo")


def test_serving_harness_tiny_smoke():
    base = ["--tiny", "--device", "cpu", "--ctx", "384", "--pool", "2",
            "--requests", "3", "--gen", "6", "--chunk", "3"]
    rows = serving.run(serving.parse_args(
        base + ["--prefill-chunk", "128", "--policies", "pq_search",
                "original"]))
    assert [r["policy"] for r in rows] == ["pq_search", "original"]
    assert all(r["interleave"] for r in rows)
    for extra in (["--prefix-len", "256"],
                  ["--weight-int8", "--kv-dtype", "int8", "--mixed-prompts",
                   "--admission", "spf", "--interleave", "off"]):
        rows += serving.run(serving.parse_args(
            base + extra + ["--policies", "pq_search"]))
    for r in rows:
        assert r["ttft_p95_s"] >= r["wait_p95_s"] >= 0.0
        assert r["ttft_p50_s"] > 0 and r["agg_tok_s"] > 0
        assert r["tbt_p50_ms"] > 0 and np.isfinite(r["e2e_p95_s"])
    assert rows[2]["prefix_len"] == 256 and rows[3]["weight_int8"]


def test_latency_harness_holds_one_weight_tree(monkeypatch):
    built = []
    real = serving.build_params

    def build(model_cfg, weight_int8, device):
        # every earlier arm's tree is gone before the next one is built
        assert all(ref() is None for ref in built)
        params = real(model_cfg, weight_int8, device)
        built.append(weakref.ref(params["embed"]))
        return params
    monkeypatch.setattr(latency, "build_params", build)
    rows = latency.run(latency.parse_args(
        ["--tiny", "--device", "cpu", "--ctx", "256", "320",
         "--weight-int8", "--kv-dtype", "int8"]))
    assert len(built) == 2
    assert [(r["policy"], r["ctx"], r["weight_int8"]) for r in rows] == [
        ("pq_search", 256, True), ("pq_search", 320, True),
        ("original", 256, False), ("original", 320, False)]
    for r in rows:
        assert r["ttft_s"] > 0 and r["per_token_ms"] > 0 and r["tt2t_s"] > 0
