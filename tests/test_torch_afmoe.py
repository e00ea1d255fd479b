"""Arcee's AFMoE decoder (Trinity) on the port: ``models/afmoe.py`` through
the ``original`` and ``pq_search`` policies and ``BatchedDecoder``, held
to the plain float32 reference ``models/afmoe_ref.py``.

The CPU tests run everything in float32 at a tiny size in the published
layer pattern (2 dense layers then 6 MoE ones, full attention at layers 3
and 7, the rest sliding): GQA group 8 over 2 kv heads of 16, window 8, 8
experts top 2 with a shared one. Tolerances: the port and the reference
compute the same float32 functions in another order (blocked online
softmax against one softmax, the expert combine summed in another order),
so logits agree to 1e-4 absolute on logits of magnitude ~3; a routing
that differs would move them by far more. The ``cuda`` tests run the
kernels on the card in bf16 (skipped without one): K2's window against a
band-masked SDPA at bf16 resolution (2e-2, K2's tolerance in
``test_torch_cuda.py``), a replayed step bit-equal to the eager one.
"""

import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pqcache_tpu_torch import config
from pqcache_tpu_torch.config import (AfmoeConfig, BudgetConfig,
                                      EngineConfig, PQConfig, RuntimeConfig)
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import afmoe, afmoe_ref, decoder, llama
from pqcache_tpu_torch.ops.attention_ref import (chunked_attention,
                                                 decode_window_attention)
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime import stages
from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
LAYER_TYPES = ("sliding_attention",) * 3 + ("full_attention",)


def tiny(**kw) -> AfmoeConfig:
    base = dict(name="tiny-afmoe", vocab_size=128, hidden_size=64,
                intermediate_size=96, num_layers=8, num_heads=16,
                num_kv_heads=2, head_dim=16, max_position_embeddings=512,
                layer_types=LAYER_TYPES * 2, sliding_window=8,
                num_dense_layers=2, num_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=32, num_shared_experts=1,
                route_norm=True, route_scale=2.826)
    base.update(kw)
    return AfmoeConfig(**base)


@pytest.fixture(scope="module")
def model():
    cfg = tiny()
    return cfg, afmoe.init_params(cfg, torch.Generator().manual_seed(0),
                                  torch.float32, "cpu", std=0.1)


def engine(cfg, policy="original", ratio=0.2, recent=0.5, T=24, **pq):
    pqc = dict(n_subvec_per_head=2, n_subbits=4, kmeans_iters=3,
               select_block=4, ring_cap=8)
    pqc.update(pq)
    return EngineConfig(model=cfg, pq=PQConfig(**pqc),
                        budget=BudgetConfig(sink_size=4,
                                            compress_ratio=ratio,
                                            recent_ratio=recent),
                        runtime=RuntimeConfig(policy=policy,
                                              max_new_tokens=T,
                                              kernels="xla"))


def serve(cfg, params, ecfg, prompt, inputs, *, chunk=None, dtype=None,
          device="cpu", routes=None):
    """Prefill ``prompt`` [P], insert it into B slots, decode the inputs
    [B, T] teacher-forced (the ring flushed every ring_k steps). Returns
    (prefill logits [V], decode logits [T, B, V], policy, single state)."""
    dtype = dtype or torch.float32
    P, (B, T) = prompt.shape[0], inputs.shape
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, T), device)
    st = pol.init_state(dtype)
    lg = afmoe.prefill_chunked(cfg, params, pol, st, prompt, 0, P,
                               chunk=chunk or P)
    bs = pol.init_batched_state(B, dtype)
    for s in range(B):
        pol.insert_slot(bs, st, s)
    ring = (pol.ring_k if getattr(bs, "ring_kv", None) is not None
            else 0)
    out = []
    for j in range(T):
        out.append(afmoe.decode_step_batched(
            cfg, params, pol, bs, inputs[:, j].int(),
            torch.full((B,), P + j, dtype=torch.int32, device=device),
            routes=routes))
        if ring and (j + 1) % ring == 0:
            pol.flush_ring_batched(bs)
    return lg, torch.stack(out), pol, st


def draws(P, B, T, seed=1, V=128):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, V, (P,), generator=g),
            torch.randint(0, V, (B, T), generator=g))


def reference_logits(cfg, params, prompt, inputs):
    """afmoe_ref's logits [T, B, V] of each decode step."""
    P = prompt.shape[0]
    return torch.stack([
        afmoe_ref.forward(cfg, params, torch.cat([prompt, row]))[P:]
        for row in inputs], 1)


# -- configuration -----------------------------------------------------------

def test_config_parses_published_afmoe_keys():
    d = json.loads((REPO / "benchmark/configs/trinity-mini.json")
                   .read_text())
    cfg = config.ModelConfig.from_hf_config(d, "trinity-mini")
    assert isinstance(cfg, AfmoeConfig)
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim) == (8, 2048, 32, 4, 128)
    assert (cfg.num_experts, cfg.num_experts_per_tok,
            cfg.moe_intermediate_size, cfg.num_shared_experts,
            cfg.num_dense_layers) == (128, 8, 1024, 1, 2)
    assert cfg.route_scale == 2.826 and cfg.route_norm and cfg.mup_enabled
    assert cfg.full_layers == (3, 7)
    assert cfg.window_layers == (0, 1, 2, 4, 5, 6)
    assert [cfg.window_of(i) for i in range(8)] == [2048] * 3 + [0] + \
        [2048] * 3 + [0]
    assert cfg.embed_scale == pytest.approx(2048 ** 0.5)
    assert cfg.vocab_size == 200192 and not cfg.tie_word_embeddings
    with pytest.raises(ValueError):
        config.ModelConfig.from_hf_config(dict(d, score_func="softmax"))
    with pytest.raises(ValueError):
        config.ModelConfig.from_hf_config(dict(d, num_hidden_layers=9))
    # the engine config round-trips through its JSON
    ecfg = EngineConfig(model=cfg)
    assert EngineConfig.from_json(ecfg.to_json()) == ecfg


@pytest.mark.parametrize("name", ("mistral-7b-v0.2", "mistral-nemo-12b"))
def test_mistral_configs_parse_as_before(name):
    d = json.loads((REPO / f"benchmark/configs/{name}.json").read_text())
    cfg = config.ModelConfig.from_hf_config(d, name)
    assert type(cfg) is config.ModelConfig
    want = config.ModelConfig(
        name=name, vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=d["num_attention_heads"],
        num_kv_heads=d["num_key_value_heads"],
        head_dim=d.get("head_dim") or 128, rms_norm_eps=d["rms_norm_eps"],
        rope_theta=d["rope_theta"],
        max_position_embeddings=d["max_position_embeddings"])
    assert cfg == want
    assert [f.name for f in dataclasses.fields(cfg)] == [
        "name", "vocab_size", "hidden_size", "intermediate_size",
        "num_layers", "num_heads", "num_kv_heads", "head_dim",
        "rms_norm_eps", "rope_theta", "rope_scaling_factor",
        "rope_low_freq_factor", "rope_high_freq_factor",
        "rope_original_max_position", "tie_word_embeddings",
        "max_position_embeddings", "dtype", "mlp_chunk"]
    assert cfg.full_layers == tuple(range(cfg.num_layers))
    assert cfg.window_layers == () and cfg.window_of(0) == 0
    assert decoder(cfg) is llama


# -- the router and the experts ---------------------------------------------

@pytest.mark.parametrize("norm", (True, False))
def test_router_bias_selects_and_does_not_weigh(norm):
    cfg = tiny(route_norm=norm)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(6, 64, generator=g)
    lp = {"router": torch.randn(64, 8, generator=g),
          "expert_bias": torch.zeros(8)}
    w0, sel0 = afmoe.route(cfg, lp, x)
    s = torch.sigmoid(x @ lp["router"])
    assert torch.equal(sel0, torch.topk(s, 2).indices)
    # a bias that lifts the expert of the lowest mean score into every
    # row's selection; its weight stays its own score's share
    low = int(s.mean(0).argmin())
    lp["expert_bias"] = torch.zeros(8).index_fill_(0, torch.tensor([low]),
                                                   10.0)
    w, sel = afmoe.route(cfg, lp, x)
    assert (sel == low).any(-1).all() and not torch.equal(sel, sel0)
    picked = s.gather(1, sel)
    want = (picked / (picked.sum(-1, keepdim=True) + 1e-20) if norm
            else picked) * 2.826
    assert torch.allclose(w, want, atol=1e-6)
    if norm:
        assert torch.allclose(w.sum(-1), torch.full((6,), 2.826), atol=1e-5)
    # the reference's router is the same function
    w_r, sel_r = afmoe_ref.route(cfg, lp, x)
    assert torch.equal(sel_r, sel) and torch.allclose(w_r, w, atol=1e-6)


def test_decode_and_prefill_expert_products_agree(model):
    cfg, params = model
    lp = afmoe.layer_params(cfg, params, 5)
    x = torch.randn(12, 64, generator=torch.Generator().manual_seed(4))
    w, sel = afmoe.route(cfg, lp, x)
    # the 12 rows at once (a prefill slab) and each row alone (a decode
    # step of one slot) through the one grouped path
    a, counts = afmoe.experts(lp, x, w, sel)
    b = torch.cat([afmoe.experts(lp, x[t:t + 1], w[t:t + 1],
                                 sel[t:t + 1])[0] for t in range(12)])
    assert torch.equal(counts, torch.bincount(sel.reshape(-1),
                                              minlength=8).int())
    assert torch.allclose(a, b, atol=1e-6)
    # each expert over its own rows, weighed and added
    loop = torch.zeros_like(a)
    for e in range(8):
        r, j = (sel == e).nonzero(as_tuple=True)
        h = (F.silu(x[r] @ lp["experts_gate"][e])
             * (x[r] @ lp["experts_up"][e]))
        loop.index_add_(0, r, (h @ lp["experts_down"][e]) * w[r, j, None])
    assert torch.allclose(a, loop, atol=1e-6)
    ref = afmoe_ref.moe(cfg, afmoe_ref.layer(cfg, params, 5), x)
    shared = afmoe.swiglu(x, lp, ("shared_gate", "shared_up", "shared_down"))
    assert torch.allclose(shared + a, ref, atol=1e-5)


# -- the window bound of K2's plain version ---------------------------------

@pytest.mark.parametrize("W,q_offset,Tq", [(8, 0, 40), (37, 64, 100),
                                            (512, 700, 300), (1, 5, 9)])
def test_window_attention_plain_is_a_band(W, q_offset, Tq):
    g = torch.Generator().manual_seed(W)
    Tk = q_offset + Tq
    q = torch.randn(4, Tq, 16, generator=g)
    k, v = torch.randn(2, 2, Tk, 16, generator=g)
    got = chunked_attention(q, k, v, causal=True, q_offset=q_offset,
                            window=W, block=64)
    qp = q_offset + torch.arange(Tq)[:, None]
    d = qp - torch.arange(Tk)[None]
    band = (d >= 0) & (d < W)
    want = torch.nn.functional.scaled_dot_product_attention(
        q, k.repeat_interleave(2, 0), v.repeat_interleave(2, 0),
        attn_mask=band)
    assert torch.allclose(got, want, atol=1e-5)


# -- the model through both policies -----------------------------------------

@pytest.mark.parametrize("P", (5, 21))
def test_original_decode_is_the_reference(model, P):
    # three windows of decode steps: the rings wrap around twice, and each
    # step's oldest key sits at p - j = window - 1
    cfg, params = model
    prompt, inputs = draws(P, 2, 24)
    lg, out, _, _ = serve(cfg, params, engine(cfg), prompt, inputs)
    ref = reference_logits(cfg, params, prompt, inputs)
    full = afmoe_ref.forward(cfg, params, prompt)
    assert (lg - full[-1]).abs().max() < TOL
    assert (out - ref).abs().max() < TOL


def test_pq_search_with_a_covering_budget_is_dense(model):
    # top-k blocks that cover every candidate of every step: the same
    # attention as the dense cache
    cfg, params = model
    prompt, inputs = draws(96, 2, 24, seed=2)
    ecfg = engine(cfg, "pq_search", ratio=1.5, recent=0.1)
    _, out, pol, _ = serve(cfg, params, ecfg, prompt, inputs, chunk=32)
    assert pol.budget.topk >= pol.budget.n_cand_init + 24
    assert (out - reference_logits(cfg, params, prompt, inputs)
            ).abs().max() < TOL


def test_pq_search_selects_as_the_reference(model):
    # budget 0.2: the benchmark's reference, selecting by the program's
    # codebooks and codes on the full layers, gives the same logits and
    # the same experts at every step (the reference's decoded tokens stay
    # in the local window: T <= local)
    from benchmark.reference.afmoe import AfmoeReference, route_mismatch
    cfg, params = model
    P, B, T = 300, 2, 24
    prompt, inputs = draws(P, B, T, seed=5)
    ecfg = engine(cfg, "pq_search")
    routes = []
    _, out, pol, st = serve(cfg, params, ecfg, prompt, inputs, chunk=100,
                            routes=routes)
    assert pol.budget.topk < pol.budget.n_cand_init
    assert T <= pol.budget.local
    m = json.loads((REPO / "benchmark/configs/trinity-mini.json")
                   .read_text())
    m.update(hidden_size=64, intermediate_size=96, num_attention_heads=16,
             num_key_value_heads=2, head_dim=16, vocab_size=128,
             moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2,
             sliding_window=8)
    m["pq"] = dict(m["pq"], n_subbits=4, kmeans_iters=3, select_block=4)
    m["budget"] = dict(m["budget"], sink=4)
    wl = dict(model=m, prompt_tokens=P, chunk=pol.ring_k)
    ref = AfmoeReference(wl, params, "cpu", "f32")
    ref.prefill(prompt.numpy(), st.centroids, st.codes)
    keep, mine = [], []
    ref.decode(inputs.numpy(), [], keep=keep, routes=mine)
    steps = [routes[6 * j:6 * j + 6] for j in range(T)]
    assert route_mismatch(steps, mine) == 0.0
    assert max(float((a - b).abs().max()) for a, b in zip(keep, out)) < TOL


# -- the window layers' rings on K1 -------------------------------------------

# each of three slots' position of the new token, window 8
WINDOW_FILLS = {
    "filling": [0, 3, 5],       # pos < W - 1: the rows past pos are masked
    "full": [7, 7, 7],          # pos = W - 1: the ring's last row written
    "wrapped": [8, 13, 30],     # pos >= W: the oldest row overwritten
    "mixed": [2, 7, 19],        # slots at different fills in one batch
}


@pytest.mark.parametrize("policy", ("pq_search", "original"))
@pytest.mark.parametrize("fill", sorted(WINDOW_FILLS))
def test_window_decode_is_the_masked_formula(model, policy, fill):
    # a window layer's batched decode on the interleaved ring (K1's plain
    # twin) is the formula it replaced: decode_window_attention over the
    # ring's K and V with the rows <= pos, in float32, after the new
    # token's write at row pos % W; no other ring changes
    cfg, _ = model
    B, H, Hk, D, W = 3, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 8
    ecfg = engine(cfg, policy, T=8)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, 96, 8), "cpu")
    bs = pol.init_batched_state(B, torch.float32)
    g = torch.Generator().manual_seed(11)
    bs.win_kv.copy_(torch.randn(bs.win_kv.shape, generator=g))
    bs.pos.copy_(torch.tensor(WINDOW_FILLS[fill], dtype=torch.int32))
    q = torch.randn(B, H, D, generator=g)
    k_new, v_new = torch.randn(2, B, Hk, D, generator=g)
    idx = cfg.window_layers[2]
    w = pol.kinds.ring[idx]
    before = bs.win_kv.clone()
    out, payload = pol.decode_attn_batched(bs, idx, q, k_new, v_new,
                                           pol.shared_pre_batched(bs))
    assert payload is None
    pos_h = torch.tensor(WINDOW_FILLS[fill]).repeat_interleave(Hk)
    ring = before[w].clone()
    ring[torch.arange(B * Hk), pos_h % W] = torch.cat(
        [k_new, v_new], -1).reshape(B * Hk, 2 * D)
    assert torch.equal(bs.win_kv[w], ring)
    rest = [i for i in range(len(cfg.window_layers)) if i != w]
    assert torch.equal(bs.win_kv[rest], before[rest])
    want = decode_window_attention(
        q.reshape(B * H, 1, D), ring[..., :D], ring[..., D:],
        torch.arange(W)[None, :] <= pos_h[:, None])
    assert (out - want.reshape(B, H, D)).abs().max() < 1e-5


@pytest.mark.parametrize("policy", ("pq_search", "original"))
@pytest.mark.parametrize("true_len,pad", [(5, 0), (8, 3), (21, 4)])
def test_prefill_and_insert_put_each_token_in_its_ring_row(model, policy,
                                                           true_len, pad):
    # prefill_tail -> insert_slot: the last min(true_len, W) real tokens'
    # K and V in the two halves of row p % W of the slot's heads, every
    # other row and slot zero
    cfg, _ = model
    Hk, D, W = cfg.num_kv_heads, cfg.head_dim, 8
    ecfg = engine(cfg, policy, T=4)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, 32, 4), "cpu")
    st = pol.init_state(torch.float32)
    g = torch.Generator().manual_seed(true_len)
    k, v = torch.randn(2, Hk, pad + true_len, D, generator=g)
    for idx in cfg.window_layers:
        pol.prefill_tail(st, idx, k + idx, v - idx, pad, true_len)
    bs = pol.init_batched_state(3, torch.float32)
    pol.insert_slot(bs, st, 1)
    want = torch.zeros_like(bs.win_kv)
    for idx, w in pol.kinds.ring.items():
        for p in range(max(true_len - W, 0), true_len):
            want[w, Hk:2 * Hk, p % W, :D] = k[:, pad + p] + idx
            want[w, Hk:2 * Hk, p % W, D:] = v[:, pad + p] - idx
    assert torch.equal(bs.win_kv, want)


def test_prefill_across_slabs_is_one_pass(model):
    cfg, params = model
    prompt, inputs = draws(96, 2, 4, seed=6)
    ecfg = engine(cfg, "pq_search", T=4)
    one = serve(cfg, params, ecfg, prompt, inputs)
    slabs = serve(cfg, params, ecfg, prompt, inputs, chunk=32)
    assert (one[0] - slabs[0]).abs().max() < 1e-5
    assert (one[1] - slabs[1]).abs().max() < 1e-5
    assert torch.equal(one[3].codes, slabs[3].codes)
    for f in ("kv_tail", "win_kv"):
        assert (getattr(one[3], f) - getattr(slabs[3], f)).abs().max() \
            < 1e-5, f


def test_batched_decoder_steps_the_configured_model(model):
    cfg, params = model
    prompt, _ = draws(21, 2, 1, seed=7)
    ecfg = engine(cfg, "pq_search", T=16)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, 21, 16), "cpu")
    st = pol.init_state(torch.float32)
    afmoe.prefill(cfg, params, pol, st, prompt, 0, 21)
    bs = [pol.init_batched_state(2, torch.float32) for _ in range(2)]
    for b in bs:
        for s in range(2):
            pol.insert_slot(b, st, s)
    tok = torch.tensor([3, 9], dtype=torch.int32)
    pos = torch.full((2,), 21, dtype=torch.int32)
    dec = BatchedDecoder(cfg, params, pol, bs[0], graph=False, device="cpu")
    assert dec.step_fn is afmoe.decode_step_batched
    got = dec.generate(tok, pos, 2 * dec.chunk)
    want, t = [], tok
    for j in range(2 * dec.chunk):
        t = afmoe.decode_step_batched(cfg, params, pol, bs[1], t,
                                      pos + j).argmax(-1).int()
        want.append(t)
        if (j + 1) % dec.chunk == 0:
            pol.flush_ring_batched(bs[1])
    assert torch.equal(got, torch.stack(want))


def _llama_engine(name, ecfg, params):
    """Construct the llama-family engine ``name`` on ``ecfg`` (its checks
    come before it reads a mesh, so the TP engines take none)."""
    from pqcache_tpu_torch.parallel.batch_tp import BatchTPEngine
    from pqcache_tpu_torch.parallel.tp_decode import TPEngine
    from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
    from pqcache_tpu_torch.runtime.generate import Engine
    from pqcache_tpu_torch.runtime.offload_batch import BatchOffloadEngine
    from pqcache_tpu_torch.runtime.offload_engine import OffloadEngine
    dev = dict(dtype=torch.float32, device="cpu")
    off = dataclasses.replace(ecfg, cache=config.CacheConfig(offload=True))
    return {
        "Engine": lambda: Engine(ecfg, params, **dev),
        "BatchEngine": lambda: BatchEngine(ecfg, params, batch_size=2,
                                           prefill_len=64,
                                           max_new_tokens=8, **dev),
        "OffloadEngine": lambda: OffloadEngine(off, params, **dev),
        "BatchOffloadEngine": lambda: BatchOffloadEngine(
            off, params, batch_size=2, **dev),
        "TPEngine": lambda: TPEngine(ecfg, params, None, 64, 8,
                                     dtype=torch.float32),
        "BatchTPEngine": lambda: BatchTPEngine(ecfg, params, None, 64, 8,
                                               dtype=torch.float32),
    }[name]()


@pytest.mark.parametrize("name", ["Engine", "BatchEngine", "OffloadEngine",
                                  "BatchOffloadEngine", "TPEngine",
                                  "BatchTPEngine"])
def test_llama_engines_refuse_the_afmoe_family(model, name):
    cfg, params = model
    with pytest.raises(ValueError, match=rf"^{name} runs the llama family; "
                       r"'tiny-afmoe' is of the afmoe family, which "
                       r"runtime/decode_graph\.BatchedDecoder serves$"):
        _llama_engine(name, engine(cfg, "pq_search"), params)


def test_prefill_spans_and_expert_load_counter(model):
    cfg, params = model
    prompt, _ = draws(64, 1, 1, seed=8)
    ecfg = engine(cfg, "original", T=1)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, 64, 1), "cpu")
    stages.clear()
    afmoe.prefill_chunked(cfg, params, pol, pol.init_state(torch.float32),
                          prompt, 0, 64, chunk=32)
    snap = stages.snapshot()
    by_id = {r["id"]: r for r in snap["records"]}
    root = [r for r in snap["records"] if r["name"] == "prefill"]
    assert len(root) == 1
    for name, layers in (("prefill_window", cfg.window_layers),
                         ("prefill_moe", tuple(range(2, 8)))):
        recs = [r for r in snap["records"] if r["name"] == name]
        # one span per layer and slab, each under the prefill
        assert sorted(r["ids"]["layer"] for r in recs) == sorted(
            list(layers) * 2)
        assert all(by_id[r["parent"]]["name"] == "prefill" for r in recs)
    loads = {k: v for k, v in snap["counters"].items()
             if k.startswith("moe.expert_load_max.")}
    assert sorted(loads) == [f"moe.expert_load_max.layer{i}"
                             for i in range(2, 8)]
    assert all(1.0 <= v <= cfg.num_experts for v in loads.values())
    stages.clear()


def test_decode_scopes_mark_the_moe_and_window_work(model):
    cfg, params = model
    prompt, inputs = draws(21, 2, 1, seed=9)
    ecfg = engine(cfg, "original", T=1)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, 21, 1), "cpu")
    st = pol.init_state(torch.float32)
    afmoe.prefill(cfg, params, pol, st, prompt, 0, 21)
    bs = pol.init_batched_state(2, torch.float32)
    for s in range(2):
        pol.insert_slot(bs, st, s)
    from torch.profiler import ProfilerActivity, profile
    with stages.recording(), profile(activities=[ProfilerActivity.CPU]) as p:
        afmoe.decode_step_batched(cfg, params, pol, bs, inputs[:, 0].int(),
                                  torch.full((2,), 21, dtype=torch.int32))
    names = [e.name for e in p.events()]
    assert names.count("scope:moe_route") == 6
    assert names.count("scope:moe_experts") == 6
    assert names.count("scope:window_attn") == len(cfg.window_layers)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 and the graph have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W,q_offset,T", [(2048, 0, 4096), (100, 0, 1000),
                                           (128, 256, 700), (129, 0, 513),
                                           (2048, 32768, 4096),
                                           (1, 0, 300)])
def test_k2_window_is_a_band_mask(dev, W, q_offset, T):
    from pqcache_tpu_torch.ops.flash_attention import flash_attention
    g = torch.Generator(device=dev).manual_seed(W + T)
    Tk = q_offset + T
    q = torch.randn(8, T, 128, generator=g, device=dev).bfloat16()
    k, v = torch.randn(2, 2, Tk, 128, generator=g, device=dev).bfloat16()
    got = flash_attention(q, k, v, causal=True, q_offset=q_offset, window=W)
    d = (q_offset + torch.arange(T, device=dev))[:, None] - torch.arange(
        Tk, device=dev)[None]
    want = torch.nn.functional.scaled_dot_product_attention(
        q.float(), k.float().repeat_interleave(4, 0),
        v.float().repeat_interleave(4, 0), attn_mask=(d >= 0) & (d < W))
    assert (got.float() - want).abs().max() < 2e-2
    # a window no row reaches past is today's K2, bit for bit
    if W >= Tk:
        assert torch.equal(got, flash_attention(q, k, v, causal=True,
                                                q_offset=q_offset))


def card_model(dev):
    cfg = tiny(hidden_size=512, intermediate_size=1024, num_heads=16,
               num_kv_heads=2, head_dim=128, vocab_size=4096,
               sliding_window=256, num_experts=16, num_experts_per_tok=4,
               moe_intermediate_size=256, max_position_embeddings=8192)
    params = afmoe.init_params(cfg, torch.Generator(device=dev).manual_seed(
        0), torch.bfloat16, dev)
    return cfg, params


@pytest.mark.cuda
def test_replayed_step_is_the_eager_step(dev):
    cfg, params = card_model(dev)
    ecfg = dataclasses.replace(engine(cfg, "pq_search", T=32,
                                      select_block=64, n_subbits=6,
                                      ring_cap=16),
                               runtime=RuntimeConfig(policy="pq_search",
                                                     max_new_tokens=32))
    P = 2048
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, 32), dev)
    st = pol.init_state()
    prompt = torch.randint(0, cfg.vocab_size, (P,), device=dev)
    afmoe.prefill_chunked(cfg, params, pol, st, prompt, 0, P, chunk=1024)
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
    assert torch.equal(outs[0], outs[1])
    for f in ("kv_tail", "codes", "jhist", "win_kv", "n_cand", "pos"):
        assert torch.equal(getattr(states[0], f), getattr(states[1], f)), f


@pytest.mark.cuda
def test_batched_step_at_b8_against_the_reference(dev):
    # the kernels' path in bf16 (K2 with its window at prefill, K1 and the
    # joint-histogram scorer at a budget that covers every candidate)
    # against the float32 reference on the same bf16 weights: each row
    # routed as the reference routes it has its logits within 5% of their
    # norm (bf16 rounding through 8 layers, ~1.4% on the card); a row
    # whose experts part from the reference's at a near tie of the scores
    # moves by more, and at least half of the rows are routed alike
    cfg, params = card_model(dev)
    P, B, T = 1024, 8, 4
    ecfg = dataclasses.replace(
        engine(cfg, "pq_search", ratio=1.5, recent=0.1, T=T,
               select_block=64, n_subbits=6, ring_cap=4),
        runtime=RuntimeConfig(policy="pq_search", max_new_tokens=T))
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (P,), device=dev, generator=g)
    inputs = torch.randint(0, cfg.vocab_size, (B, T), device=dev,
                           generator=g)
    routes = []
    _, out, _, _ = serve(cfg, params, ecfg, prompt, inputs, chunk=512,
                         dtype=torch.bfloat16, device=dev, routes=routes)
    refs, alike = [], torch.ones((T, B), dtype=torch.bool, device=dev)
    for b, row in enumerate(inputs):
        r = []
        refs.append(afmoe_ref.forward(cfg, params, torch.cat([prompt, row]),
                                      routes=r)[P:])
        for j in range(T):
            for layer, sel in enumerate(routes[6 * j:6 * j + 6]):
                alike[j, b] &= torch.equal(
                    sel[b].sort().values, r[layer][P + j].sort().values)
    ref = torch.stack(refs, 1)
    rel = (out - ref).norm(dim=-1) / ref.norm(dim=-1)
    assert alike.float().mean() >= 0.5, alike
    assert rel[alike].max() < 5e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("slots", (10, 80))
def test_window_attention_matches_plain_at_trinity_shape(dev, slots):
    # K1 over window rings at Trinity's widths (g 8, D 128, W 2048, blocks
    # of 256; 10 slots x 4 kv heads folded, several CTAs a head, and the
    # cell's 80 slots, one CTA a head) at fills from 1 row to full,
    # against its plain twin at K1's tolerance; the rows past a head's fill
    # that a box may fetch hold NaN and must not reach the output; a graph
    # replay reads the fills the card holds
    from pqcache_tpu_torch.ops.block_attn import (block_attention,
                                                  block_attention_ref)
    from pqcache_tpu_torch.policies.window import window_attention
    Hf, g, D, W, bs = 4 * slots, 8, 128, 2048, 256
    gen = torch.Generator(device=dev).manual_seed(24)
    win_kv = torch.randn(2, Hf, W, 2 * D, generator=gen, device=dev).bfloat16()
    q = torch.randn(Hf * g, 1, D, generator=gen, device=dev).bfloat16()
    fills = [1, 7, 8, 9, 255, 256, 257, 1000, 2047, 2048]
    n = torch.tensor(fills * (Hf // 10), dtype=torch.int32, device=dev)
    blk = torch.arange(W // bs, dtype=torch.int32, device=dev).repeat(Hf, 1)
    saved = win_kv[1].clone()
    for h, f in enumerate(n.tolist()):
        win_kv[1, h, f:f + 8] = float("nan")
    n0 = window_attention.launches
    got = window_attention(q, win_kv, 1, blk, n, bs)
    parts = block_attention(q, win_kv, 1, blk, n, block=bs)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = window_attention(q, win_kv, 1, blk, n, bs)
    n_now = torch.clamp(n + 5, max=W)
    n.copy_(n_now)
    win_kv[1].copy_(saved)
    graph.replay()
    torch.cuda.synchronize()
    assert window_attention.launches == n0 + 2
    n_was = torch.tensor(fills * (Hf // 10), dtype=torch.int32, device=dev)
    ref = block_attention_ref(q, win_kv, 1, blk, n_was, block=bs)
    for a, b in zip(parts, ref):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * max(1.0, b.abs().max().item()))
    for out, cnt in ((got, n_was), (cap, n_now)):
        _, l, acc = block_attention_ref(q, win_kv, 1, blk, cnt, block=bs)
        want = (acc / l[..., None]).reshape(Hf * g, D)
        assert out.dtype == torch.bfloat16
        torch.testing.assert_close(out.float(), want, rtol=1e-2, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ("pq_search", "original"))
def test_window_layers_launch_k1_once_a_layer(dev, policy, monkeypatch):
    # one eager batched step: each window layer one K1 launch, counted
    # apart from retrieval's, and the segment merge only on full layers
    from pqcache_tpu_torch.ops import attention_ref
    from pqcache_tpu_torch.ops.block_attn import block_topk_attention
    from pqcache_tpu_torch.policies import original, pq_search, window
    cfg, params = card_model(dev)
    P, B = 1024, 4
    ecfg = dataclasses.replace(
        engine(cfg, policy, T=4, select_block=64, n_subbits=6, ring_cap=4),
        runtime=RuntimeConfig(policy=policy, max_new_tokens=4))
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, 4), dev)
    st = pol.init_state()
    gen = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (P,), device=dev, generator=gen)
    afmoe.prefill_chunked(cfg, params, pol, st, prompt, 0, P, chunk=512)
    bs = pol.init_batched_state(B)
    for s in range(B):
        pol.insert_slot(bs, st, s)
    merges = []
    real = attention_ref.decode_window_attention_segments

    def counted(*args, **kw):
        merges.append(1)
        return real(*args, **kw)

    for mod in (attention_ref, original, pq_search):
        monkeypatch.setattr(mod, "decode_window_attention_segments", counted)
    n_win = window.window_attention.launches
    n_k1 = block_topk_attention.launches
    afmoe.decode_step_batched(
        cfg, params, pol, bs, torch.arange(B, dtype=torch.int32, device=dev),
        torch.full((B,), P, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert (window.window_attention.launches - n_win
            == len(cfg.window_layers))
    assert len(merges) == len(cfg.full_layers)
    assert block_topk_attention.launches - n_k1 == (
        len(cfg.full_layers) if policy == "pq_search" else 0)
