"""DeepSeek-V2 (multi-head latent attention and experts) on the port:
``models/deepseek_v2.py`` through the ``pq_search`` policy's latent state
and ``BatchedDecoder``, held to the plain float32 reference
``models/deepseek_v2_ref.py``, which is held to transformers'
``DeepseekV2ForCausalLM``.

The CPU tests run everything in float32 at a tiny size (a dense layer,
then MoE layers; 4 heads over a latent of 32 + 8 rope columns; 8 experts
top 2 and 2 shared ones; YaRN factor 40). Tolerances: the port and the
reference compute the same float32 functions in another order (the
absorbed decode against the expanded form, blocked online softmax against
one softmax, the expert combine in another order), so logits agree to 1e-4
absolute on logits of magnitude ~2; a latent cache kept in bf16 where the
configuration states f32, or a routing that differs, moves them by far
more (``test_tolerance_sees_a_bf16_latent_cache``). The plain twins of the
new kernels are held to dense float32 computations written out here
(1e-5). transformers' model, run with ``rope_scaling`` null so that
YaRN's mscale^2 (which its in-tree deepseek_v2 leaves out) is out of the
comparison, agrees with the reference to 1e-4.
"""

import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from pqcache_tpu_torch import config
from pqcache_tpu_torch.config import (BudgetConfig, DeepseekV2Config,
                                      EngineConfig, PQConfig, RuntimeConfig)
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import decoder, deepseek_v2, deepseek_v2_ref
from pqcache_tpu_torch.ops.attention_ref import chunked_attention
from pqcache_tpu_torch.ops.block_attn import block_topk_latent_attention_ref
from pqcache_tpu_torch.ops.jhist import jhist_block_mass_ref
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime import stages
from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4


def tiny(**kw) -> DeepseekV2Config:
    base = dict(name="tiny-dsv2", vocab_size=128, hidden_size=64,
                intermediate_size=96, num_layers=3, num_heads=4,
                num_kv_heads=1, head_dim=40, rms_norm_eps=1e-6,
                max_position_embeddings=512, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                first_k_dense_replace=1, num_experts=8,
                num_experts_per_tok=2, moe_intermediate_size=32,
                num_shared_experts=2, yarn_factor=40.0,
                yarn_original_max_position=64, yarn_mscale=0.707,
                yarn_mscale_all_dim=0.707)
    base.update(kw)
    return DeepseekV2Config(**base)


@pytest.fixture(scope="module")
def model():
    cfg = tiny()
    return cfg, deepseek_v2.init_params(
        cfg, torch.Generator().manual_seed(0), torch.float32, "cpu",
        std=0.1)


def engine(cfg, ratio=1.5, recent=0.1, T=24, **pq):
    pqc = dict(n_subvec_per_head=2, n_subbits=4, kmeans_iters=3,
               select_block=4, ring_cap=8)
    pqc.update(pq)
    return EngineConfig(model=cfg, pq=PQConfig(**pqc),
                        budget=BudgetConfig(sink_size=4,
                                            compress_ratio=ratio,
                                            recent_ratio=recent),
                        runtime=RuntimeConfig(policy="pq_search",
                                              max_new_tokens=T,
                                              kernels="xla"))


def serve(cfg, params, ecfg, prompt, inputs, *, chunk=None, dtype=None,
          routes=None):
    """Prefill ``prompt`` [P], insert it into B slots, decode the inputs
    [B, T] teacher-forced (the ring flushed every ring_k steps). Returns
    (prefill logits [V], decode logits [T, B, V], policy, single state,
    batched state)."""
    dtype = dtype or torch.float32
    P, (B, T) = prompt.shape[0], inputs.shape
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, T), "cpu")
    st = pol.init_state(dtype)
    lg = deepseek_v2.prefill_chunked(cfg, params, pol, st, prompt, 0, P,
                                     chunk=chunk or P)
    bs = pol.init_batched_state(B, dtype)
    for s in range(B):
        pol.insert_slot(bs, st, s)
    out = []
    for j in range(T):
        out.append(deepseek_v2.decode_step_batched(
            cfg, params, pol, bs, inputs[:, j].int(),
            torch.full((B,), P + j, dtype=torch.int32), routes=routes))
        if (j + 1) % pol.ring_k == 0:
            pol.flush_ring_batched(bs)
    return lg, torch.stack(out), pol, st, bs


def draws(P, B, T, seed=1, V=128):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, V, (P,), generator=g),
            torch.randint(0, V, (B, T), generator=g))


def reference_logits(cfg, params, prompt, inputs):
    """deepseek_v2_ref's logits [T, B, V] of each decode step."""
    P = prompt.shape[0]
    return torch.stack([
        deepseek_v2_ref.forward(cfg, params, torch.cat([prompt, row]))[P:]
        for row in inputs], 1)


# -- configuration -------------------------------------------------------------

def test_config_parses_published_deepseek_keys():
    d = json.loads((REPO / "benchmark/configs/deepseek-v2-lite.json")
                   .read_text())
    cfg = config.ModelConfig.from_hf_config(d, "deepseek-v2-lite")
    assert isinstance(cfg, DeepseekV2Config) and decoder(cfg) is deepseek_v2
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads) == (8, 2048, 16)
    # one latent kv head of 512 + 64 columns, its values the first 512
    assert (cfg.num_kv_heads, cfg.head_dim, cfg.value_dim) == (1, 576, 512)
    assert cfg.latent_kv and not config.ModelConfig().latent_kv
    assert (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
            cfg.qk_head_dim) == (128, 64, 128, 192)
    assert (cfg.num_experts, cfg.num_experts_per_tok,
            cfg.moe_intermediate_size, cfg.num_shared_experts,
            cfg.first_k_dense_replace) == (64, 6, 1408, 2, 1)
    assert not cfg.norm_topk_prob and cfg.routed_scaling_factor == 1.0
    assert (cfg.yarn_factor, cfg.yarn_original_max_position,
            cfg.yarn_mscale, cfg.yarn_mscale_all_dim) == (40.0, 4096,
                                                          0.707, 0.707)
    # DeepSeek's scale: 192^-0.5 times mscale(40, 0.707)^2
    m = 0.1 * 0.707 * math.log(40) + 1
    assert cfg.softmax_scale == pytest.approx(192 ** -0.5 * m * m)
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    assert cfg.vocab_size == 102400 and not cfg.tie_word_embeddings
    for bad in (dict(q_lora_rank=1536), dict(topk_method="noaux_tc"),
                dict(n_group=8, topk_group=3),
                dict(rope_scaling={"type": "linear", "factor": 2.0})):
        with pytest.raises(ValueError):
            config.ModelConfig.from_hf_config(dict(d, **bad))
    ecfg = EngineConfig(model=cfg)
    assert EngineConfig.from_json(ecfg.to_json()) == ecfg


def test_yarn_inverse_frequencies_are_transformers():
    from types import SimpleNamespace

    from transformers.modeling_rope_utils import _compute_yarn_parameters
    cfg = config.ModelConfig.from_hf_config(json.loads(
        (REPO / "benchmark/configs/deepseek-v2-lite.json").read_text()))
    hf = SimpleNamespace(
        rope_theta=10000.0, head_dim=64, hidden_size=2048,
        num_attention_heads=16, max_position_embeddings=163840,
        rope_scaling=dict(type="yarn", factor=40, beta_fast=32,
                          beta_slow=1, mscale=0.707, mscale_all_dim=0.707,
                          original_max_position_embeddings=4096))
    inv, att = _compute_yarn_parameters(hf, "cpu")
    assert torch.allclose(deepseek_v2.rope_inv_freq(cfg, "cpu"), inv,
                          rtol=1e-6, atol=0)
    assert torch.allclose(deepseek_v2_ref.inv_freq(cfg), inv, rtol=1e-6,
                          atol=0)
    # cos and sin scaled by mscale / mscale_all_dim: 1 here, as HF's
    # attention factor
    assert att == pytest.approx(1.0)
    c, s = deepseek_v2.rope_cos_sin(cfg, torch.tensor([0, 5, 70000]))
    assert torch.allclose(c * c + s * s, torch.ones_like(c), atol=1e-6)


def test_reference_is_transformers_deepseek_v2():
    # transformers' model at the tiny widths, no rope scaling (so its
    # scale, without YaRN's factor, is DeepSeek's), the port's parameters
    # moved into its layout
    from transformers import DeepseekV2Config as HFConfig
    from transformers import DeepseekV2ForCausalLM
    cfg = tiny(yarn_factor=None, yarn_mscale_all_dim=0.0)
    params = deepseek_v2.init_params(cfg, torch.Generator().manual_seed(3),
                                     torch.float32, "cpu", std=0.1)
    hc = HFConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                  moe_intermediate_size=32, num_hidden_layers=3,
                  num_attention_heads=4, num_key_value_heads=4,
                  n_shared_experts=2, n_routed_experts=8,
                  num_experts_per_tok=2, first_k_dense_replace=1,
                  norm_topk_prob=False, routed_scaling_factor=1.0,
                  kv_lora_rank=32, q_lora_rank=None, qk_rope_head_dim=8,
                  qk_nope_head_dim=16, v_head_dim=16, rms_norm_eps=1e-6,
                  rope_theta=10000.0, rope_scaling=None,
                  max_position_embeddings=512, topk_method="greedy",
                  tie_word_embeddings=False, attention_bias=False)
    hc._attn_implementation = "eager"
    hf = DeepseekV2ForCausalLM(hc).eval()
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"].T}
    for i in range(3):
        lp = deepseek_v2.layer_params(cfg, params, i)
        p = f"model.layers.{i}."
        uk = lp["w_uk"]                          # [H, 16, 32]
        uv = lp["w_uv"].transpose(1, 2)          # [H, 16, 32]
        sd.update({
            p + "input_layernorm.weight": lp["ln_in"],
            p + "post_attention_layernorm.weight": lp["ln_post"],
            p + "self_attn.q_proj.weight": lp["wq"].T,
            p + "self_attn.kv_a_proj_with_mqa.weight": lp["w_kv_a"].T,
            p + "self_attn.kv_a_layernorm.weight": lp["kv_norm"],
            p + "self_attn.kv_b_proj.weight": torch.cat(
                [uk, uv], 1).reshape(-1, 32),
            p + "self_attn.o_proj.weight": lp["wo"].T})
        if i == 0:
            for k in ("gate", "up", "down"):
                sd[p + f"mlp.{k}_proj.weight"] = lp[k].T
            continue
        sd[p + "mlp.gate.weight"] = lp["router"].T
        for k in ("gate", "up", "down"):
            sd[p + f"mlp.shared_experts.{k}_proj.weight"] = \
                lp[f"shared_{k}"].T
            for e in range(8):
                sd[p + f"mlp.experts.{e}.{k}_proj.weight"] = \
                    lp[f"experts_{k}"][e].T
    missing, unexpected = hf.load_state_dict(
        {k: v.contiguous() for k, v in sd.items()}, strict=False)
    assert not unexpected and not [k for k in missing
                                   if "rotary" not in k], missing
    ids = torch.randint(0, 128, (40,), generator=torch.Generator()
                        .manual_seed(4))
    with torch.no_grad():
        want = hf(ids[None]).logits[0]
    got = deepseek_v2_ref.forward(cfg, params, ids)
    assert (got - want).abs().max() < TOL


# -- the router, the plain twins ------------------------------------------------

@pytest.mark.parametrize("norm", (False, True))
def test_router_is_softmax_greedy(norm):
    cfg = tiny(norm_topk_prob=norm, routed_scaling_factor=2.5)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(6, 64, generator=g)
    lp = {"router": torch.randn(64, 8, generator=g)}
    w, sel = deepseek_v2.route(cfg, lp, x)
    s = torch.softmax(x @ lp["router"], -1)
    assert torch.equal(sel, torch.topk(s, 2).indices)
    picked = s.gather(1, sel)
    want = (picked / (picked.sum(-1, keepdim=True) + 1e-20) if norm
            else picked) * 2.5
    assert torch.allclose(w, want, atol=1e-6)
    w_r, sel_r = deepseek_v2_ref.route(cfg, lp, x)
    assert torch.equal(sel_r, sel) and torch.allclose(w_r, w, atol=1e-6)


@pytest.mark.parametrize("win", (0, 9))
def test_latent_k1_plain_twin_is_dense(win):
    # every head of a slot over the selected blocks' rows below n_cand and
    # the window's rows, each latent row its key and its first 24 columns
    # its value, written out row by row
    g = torch.Generator().manual_seed(win)
    Hf, gq, N, D, Dv, bs = 3, 4, 64, 40, 24, 8
    kv = torch.randn(2, Hf, N, D, generator=g)
    q = torch.randn(Hf * gq, 1, D, generator=g)
    blk = torch.tensor([[0, 3], [5, 1], [2, 2]])
    n_cand = torch.tensor([30, 44, 0])
    m, l, acc = block_topk_latent_attention_ref(
        q, kv, 1, blk, n_cand, block=bs, v_dim=Dv, win_len=win,
        win_max=12 if win else 0)
    for h in range(Hf):
        rows = sorted({b * bs + r for b in blk[h].tolist()
                       for r in range(bs) if b * bs + r < n_cand[h]})
        rows += list(range(int(n_cand[h]), int(n_cand[h]) + win))
        for j in range(gq):
            qh = q[h * gq + j, 0]
            if not rows:
                assert l[h, j] == 0 and (acc[h, j] == 0).all()
                continue
            k = kv[1, h, rows]
            s = k @ qh / math.sqrt(D)
            p = torch.exp(s - s.max())
            assert m[h, j] == pytest.approx(float(s.max()), abs=1e-5)
            assert l[h, j] == pytest.approx(float(p.sum()), rel=1e-5)
            assert torch.allclose(acc[h, j], p @ k[:, :Dv], atol=1e-5)


def test_scorer_plain_twin_at_16_heads():
    g = torch.Generator().manual_seed(16)
    Hf, gq, C, NB = 2, 16, 4, 5
    e = torch.rand(Hf * gq, 2, C, generator=g)
    J = torch.randint(0, 256, (Hf, NB, C * C), generator=g,
                      dtype=torch.uint8)
    got = jhist_block_mass_ref(e, J)
    for h in range(Hf * gq):
        for n in range(NB):
            want = sum(float(e[h, 0, a] * e[h, 1, b])
                       * int(J[h // gq, n, a * C + b])
                       for a in range(C) for b in range(C))
            assert float(got[h, n]) == pytest.approx(want, rel=1e-5)


def test_k2_plain_twin_with_narrower_values_is_dense():
    g = torch.Generator().manual_seed(5)
    H, Tq, Tk, off, sc = 3, 20, 50, 30, 0.37
    q = torch.randn(H, Tq, 24, generator=g)
    k = torch.randn(H, Tk, 24, generator=g)
    v = torch.randn(H, Tk, 16, generator=g)
    got = chunked_attention(q, k, v, valid_lo=3, causal=True, q_offset=off,
                            scale=sc, block=8)
    s = torch.einsum("hqd,hkd->hqk", q, k) * sc
    kp = torch.arange(Tk)
    ok = (kp[None] <= off + torch.arange(Tq)[:, None]) & (kp[None] >= 3)
    want = torch.softmax(torch.where(ok, s, -torch.inf), -1) @ v
    assert got.shape == (H, Tq, 16)
    assert torch.allclose(got, want, atol=1e-5)


# -- the model through the latent state ------------------------------------------

@pytest.mark.parametrize("chunk", (None, 32))
def test_prefill_logits_are_the_reference(model, chunk):
    cfg, params = model
    prompt, inputs = draws(96, 1, 1, seed=2)
    lg, *_ = serve(cfg, params, engine(cfg, T=1), prompt, inputs,
                   chunk=chunk)
    assert (lg - deepseek_v2_ref.forward(cfg, params, prompt)[-1]
            ).abs().max() < TOL


def test_pq_search_with_a_covering_budget_is_the_reference(model):
    # 24 steps (three ring flushes) through the latent PQ state, top-k
    # blocks that cover every candidate of every step: the logits of the
    # reference's full forward pass
    cfg, params = model
    prompt, inputs = draws(96, 2, 24, seed=2)
    _, out, pol, _, _ = serve(cfg, params, engine(cfg), prompt, inputs,
                              chunk=32)
    assert pol.budget.topk >= pol.budget.n_cand_init + 24
    assert (out - reference_logits(cfg, params, prompt, inputs)
            ).abs().max() < TOL


def test_tolerance_sees_a_bf16_latent_cache(model):
    # the same run with the latent state kept in bf16 (the configuration
    # states f32 here) misses TOL by far: the tolerance can tell
    cfg, params = model
    prompt, inputs = draws(96, 2, 16, seed=2)
    _, out, *_ = serve(cfg, params, engine(cfg, T=16), prompt, inputs,
                       dtype=torch.bfloat16)
    assert (out - reference_logits(cfg, params, prompt, inputs)
            ).abs().max() > 20 * TOL


def test_latent_state_layout(model):
    cfg, params = model
    ecfg = engine(cfg, ratio=0.5, recent=0.5, T=8)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, 64, 8), "cpu")
    st = pol.init_batched_state(3, torch.float32)
    # one latent row a token (never K and V twice), the sink's values a
    # view of its keys
    assert st.kv_tail.shape[1:] == (3, st.kv_tail.shape[2], 40)
    assert st.ring_kv.shape[-1] == 40 and st.k_sink.shape[-1] == 40
    assert st.v_sink.shape[-1] == 32
    assert st.v_sink.data_ptr() == st.k_sink.data_ptr()
    assert st.codes.shape[:3] == (3, 3, 2) and st.jhist is not None
    with pytest.raises(ValueError, match="latent"):
        get_policy(dataclasses.replace(
            ecfg, cache=config.CacheConfig(kv_dtype="int8")),
            pol.budget, "cpu").init_state()
    with pytest.raises(ValueError, match="latent"):
        get_policy(dataclasses.replace(
            ecfg, runtime=RuntimeConfig(policy="original")),
            pol.budget, "cpu").init_state()


def test_latent_slots_are_the_single_slot_path(model):
    # two slots decoding different tokens in one batched state against each
    # slot alone: the same logits, tails, rings, codes and histograms after
    # two of the ring's flushes and four steps past them (insert_slot and
    # flush_ring_batched on latent rows)
    cfg, params = model
    prompt, inputs = draws(96, 2, 20, seed=7)
    ecfg = engine(cfg, ratio=0.4, recent=0.5, T=20)
    _, both, _, _, bs = serve(cfg, params, ecfg, prompt, inputs, chunk=32)
    for s in range(2):
        _, one, _, _, b1 = serve(cfg, params, ecfg, prompt, inputs[s:s + 1],
                                 chunk=32)
        assert (one[:, 0] - both[:, s]).abs().max() < 1e-5
        # (a batch of one multiplies in another f32 order: rows to 1e-5)
        for f in ("kv_tail", "k_sink", "ring_kv"):
            assert torch.allclose(getattr(b1, f)[:, 0], getattr(bs, f)[:, s],
                                  atol=1e-5), f
        for f in ("codes", "jhist"):
            assert torch.equal(getattr(b1, f)[:, 0], getattr(bs, f)[:, s]), f
        assert int(b1.n_cand[0]) == int(bs.n_cand[s])


def test_pq_search_selects_as_the_benchmark_reference(model):
    # budget 0.2: the benchmark's reference, selecting by the program's
    # codebooks and codes, gives the same logits and the same experts at
    # every step
    from benchmark.reference.afmoe import route_mismatch
    from benchmark.reference.deepseek_v2 import MlaReference
    cfg, params = model
    P, B, T = 300, 2, 16
    prompt, inputs = draws(P, B, T, seed=5)
    ecfg = engine(cfg, ratio=0.2, recent=0.5, T=T)
    routes = []
    _, out, pol, st, _ = serve(cfg, params, ecfg, prompt, inputs, chunk=100,
                               routes=routes)
    assert pol.budget.topk < pol.budget.n_cand_init
    assert T <= pol.budget.local
    m = json.loads((REPO / "benchmark/configs/deepseek-v2-lite.json")
                   .read_text())
    m.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, vocab_size=128, moe_intermediate_size=32,
             n_routed_experts=8, num_experts_per_tok=2, num_hidden_layers=3)
    m["rope_scaling"] = dict(m["rope_scaling"],
                             original_max_position_embeddings=64)
    m["pq"] = dict(m["pq"], n_subbits=4, kmeans_iters=3, select_block=4)
    m["budget"] = dict(m["budget"], sink=4)
    wl = dict(model=m, prompt_tokens=P, chunk=pol.ring_k)
    ref = MlaReference(wl, params, "cpu", "f32")
    ref.prefill(prompt.numpy(), st.centroids, st.codes)
    keep, mine = [], []
    ref.decode(inputs.numpy(), [], keep=keep, routes=mine)
    steps = [routes[2 * j:2 * j + 2] for j in range(T)]
    assert route_mismatch(steps, mine) == 0.0
    assert max(float((a - b).abs().max()) for a, b in zip(keep, out)) < TOL


def test_batched_decoder_steps_the_configured_model(model):
    cfg, params = model
    prompt, _ = draws(40, 2, 1, seed=8)
    ecfg = engine(cfg, ratio=0.5, recent=0.5, T=16)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, 40, 16), "cpu")
    st = pol.init_state(torch.float32)
    deepseek_v2.prefill(cfg, params, pol, st, prompt, 0, 40)
    bs = [pol.init_batched_state(2, torch.float32) for _ in range(2)]
    for b in bs:
        for s in range(2):
            pol.insert_slot(b, st, s)
    tok = torch.tensor([3, 9], dtype=torch.int32)
    pos = torch.full((2,), 40, dtype=torch.int32)
    dec = BatchedDecoder(cfg, params, pol, bs[0], graph=False, device="cpu")
    assert dec.step_fn is deepseek_v2.decode_step_batched
    got = dec.generate(tok, pos, 2 * dec.chunk)
    want, t = [], tok
    for j in range(2 * dec.chunk):
        t = deepseek_v2.decode_step_batched(cfg, params, pol, bs[1], t,
                                            pos + j).argmax(-1).int()
        want.append(t)
        if (j + 1) % dec.chunk == 0:
            pol.flush_ring_batched(bs[1])
    assert torch.equal(got, torch.stack(want))


@pytest.mark.parametrize("name", ["Engine", "BatchEngine"])
def test_llama_engines_refuse_the_deepseek_family(model, name):
    from pqcache_tpu_torch.runtime.batch_engine import BatchEngine
    from pqcache_tpu_torch.runtime.generate import Engine
    cfg, params = model
    make = {"Engine": lambda e: Engine(e, params, torch.float32, "cpu"),
            "BatchEngine": lambda e: BatchEngine(
                e, params, batch_size=2, prefill_len=64, max_new_tokens=8,
                dtype=torch.float32, device="cpu")}[name]
    with pytest.raises(ValueError, match=rf"^{name} runs the llama family; "
                       r"'tiny-dsv2' is of the deepseek_v2 family"):
        make(engine(cfg))


def test_prefill_spans_and_expert_load_counter(model):
    cfg, params = model
    prompt, _ = draws(64, 1, 1, seed=8)
    ecfg = engine(cfg, ratio=0.5, recent=0.5, T=1)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, 64, 1), "cpu")
    stages.clear()
    deepseek_v2.prefill_chunked(cfg, params, pol,
                                pol.init_state(torch.float32), prompt, 0,
                                64, chunk=32)
    snap = stages.snapshot()
    by_id = {r["id"]: r for r in snap["records"]}
    assert len([r for r in snap["records"] if r["name"] == "prefill"]) == 1
    for name, layers in (("prefill_mla", (0, 1, 2)), ("prefill_moe", (1, 2))):
        recs = [r for r in snap["records"] if r["name"] == name]
        # one span per layer and slab, each under the prefill
        assert sorted(r["ids"]["layer"] for r in recs) == sorted(
            list(layers) * 2)
        assert all(by_id[r["parent"]]["name"] == "prefill" for r in recs)
    loads = {k: v for k, v in snap["counters"].items()
             if k.startswith("moe.expert_load_max.")}
    assert sorted(loads) == ["moe.expert_load_max.layer1",
                             "moe.expert_load_max.layer2"]
    assert all(1.0 <= v <= cfg.num_experts for v in loads.values())
    stages.clear()


def test_decode_scopes_mark_the_absorption_and_the_moe(model):
    cfg, params = model
    prompt, inputs = draws(40, 2, 1, seed=9)
    ecfg = engine(cfg, ratio=0.5, recent=0.5, T=1)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, 40, 1), "cpu")
    st = pol.init_state(torch.float32)
    deepseek_v2.prefill(cfg, params, pol, st, prompt, 0, 40)
    bs = pol.init_batched_state(2, torch.float32)
    for s in range(2):
        pol.insert_slot(bs, st, s)
    from torch.profiler import ProfilerActivity, profile
    with stages.recording(), profile(activities=[ProfilerActivity.CPU]) as p:
        deepseek_v2.decode_step_batched(
            cfg, params, pol, bs, inputs[:, 0].int(),
            torch.full((2,), 40, dtype=torch.int32))
    names = [e.name for e in p.events()]
    assert names.count("scope:mla_absorb") == 2 * 3
    assert names.count("scope:moe_route") == 2
    assert names.count("scope:moe_experts") == 2
    assert names.count("scope:pq_fetch") >= 3


def test_expert_products_are_afmoe_s(model):
    # the routed products are afmoe.experts over the softmax router's
    # selection, plus the shared experts as one SwiGLU
    cfg, params = model
    lp = deepseek_v2.layer_params(cfg, params, 2)
    x = torch.randn(12, 64, generator=torch.Generator().manual_seed(4))
    out, counts = deepseek_v2.moe(cfg, lp, x)
    ref = deepseek_v2_ref.moe(cfg, deepseek_v2_ref.layer(cfg, params, 2), x)
    assert torch.allclose(out, ref, atol=1e-5)
    _, sel = deepseek_v2.route(cfg, lp, x)
    assert torch.equal(counts, torch.bincount(sel.reshape(-1),
                                              minlength=8).int())
