"""The DeepSeek-V2 cell's pieces at toy widths on the CPU: the benchmark's
copy of the reference against the port's, the byte and FLOP counts of
``k1_mla_roofline`` and ``mfu.decode.mla`` worked by hand, the readers,
the cell's files, and whole runs of the driver with a fault it must
catch."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import mla_roofline, weights_deepseek_v2
from benchmark.common import workload
from benchmark.layer_metrics import decode_mla_ms, k1_mla_roofline
from benchmark.layer_metrics import mfu_decode_mla
from benchmark.reference.afmoe import route_mismatch
from benchmark.reference.deepseek_v2 import MlaReference

ROOT = Path(__file__).resolve().parent.parent
CELL = "dsv2lite-decode-128k"


def tiny_model() -> dict:
    m = json.loads((ROOT / "configs" / "deepseek-v2-lite.json").read_text())
    m.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, vocab_size=256, moe_intermediate_size=32,
             n_routed_experts=8, num_experts_per_tok=2, num_hidden_layers=3,
             init_std=0.1, max_position_embeddings=4096)
    m["rope_scaling"] = dict(m["rope_scaling"],
                             original_max_position_embeddings=64)
    m["pq"] = dict(m["pq"], n_subbits=4, kmeans_iters=3, select_block=16)
    return m


def tiny_cell(**limits) -> dict:
    lim = dict(logit_gap=0.5, code_mismatch=0.05, codebook_excess=0.02,
               route_mismatch=0.25)
    lim.update(limits)
    return dict(driver="decode_turns_mla", prompt_tokens=640,
                prefill_chunk=320, batch=2, turn_tokens=32, chunk=16,
                sample_turns=2, trace_steps=4, limits=lim,
                name="tiny-mla", config="tiny", model=tiny_model())


def test_reference_copy_is_the_ports_reference():
    # a budget that covers every candidate of every step, f32: the
    # benchmark's reference (absorbed at decode) decodes the logits of the
    # port's plain expanded forward pass, and routes the same experts
    from pqcache_tpu_torch.config import ModelConfig
    from pqcache_tpu_torch.models import deepseek_v2_ref
    m = tiny_model()
    m["budget"] = dict(m["budget"], compress_ratio=1.5, recent_ratio=0.1,
                       sink=4)
    m["pq"] = dict(m["pq"], select_block=4)
    P, T = 300, 8
    wl = dict(model=m, prompt_tokens=P, chunk=4)
    w = weights_deepseek_v2.draw(m, 11, "cpu")
    ids = np.random.default_rng(11).integers(0, 256, P)
    inputs = np.random.default_rng(12).integers(0, 256, (2, T))
    ref = MlaReference(wl, w, "cpu", "f32")
    ref.prefill(ids)
    keep, routes = [], []
    ref.decode(inputs, [], keep=keep, routes=routes)
    cfg = ModelConfig.from_hf_config(m)
    for b in range(2):
        r = []
        full = deepseek_v2_ref.forward(cfg, w, torch.as_tensor(
            np.concatenate([ids, inputs[b]])), routes=r)
        assert max(float((keep[j][b] - full[P + j]).abs().max())
                   for j in range(T)) < 1e-4
        mine = [[x[b:b + 1] for x in step] for step in routes]
        theirs = [[x[P + j:P + j + 1] for x in r] for j in range(T)]
        assert route_mismatch(mine, theirs) == 0.0


def test_latent_bytes_and_step_flops_by_hand():
    m = tiny_model()
    P, B, ring = 640, 3, 5
    # budget at 640: n 608, local 60, topk 60 -> 4 blocks of 16
    rows = 4 * 16 + 60 - ring
    want = (B * rows * 40 * 2 + B * 4 * 40 * 2 + B * 4 * 8
            + B * 4 * (32 + 2) * 4)
    assert mla_roofline.k1_latent_bytes(m, B, P, ring) == want
    att_rows = 32 + 4 * 16 + 60 + 1
    assert mla_roofline.attended_rows(m, P) == att_rows
    attn = (64 * 4 * 24 + 64 * 40 + 4 * 16 * 64 + 4 * 16 * 32
            + 4 * 32 * 16)
    dense = attn + 3 * 64 * 96
    moe = attn + 64 * 8 + (2 + 2) * 3 * 64 * 32
    weights = dense + 2 * moe + 64 * 256
    flops = 2.0 * weights * B + B * 2.0 * 4 * (40 + 32) * att_rows * 3
    assert mla_roofline.step_flops(m, B, P) == flops


def _record(m):
    return dict(events=[("void latent_attn_kernel<576, 512>", "fetch", 300.0),
                        ("latent_merge_kernel", "fetch", 20.0),
                        ("gemm", "model", 100.0), ("bmm_a", "model", 8.0)],
                scopes=["pq_fetch", "pq_fetch", "", "mla_absorb"],
                steps=2, ring=[1, 2], batch=3, prompt_tokens=640,
                model=m, window_s=0.004)


def test_readers_by_hand():
    m = tiny_model()
    rec = _record(m)
    need = sum(mla_roofline.k1_latent_bytes(m, 3, 640, r)
               for r in (1, 2)) * 3
    assert k1_mla_roofline.read(rec) == pytest.approx(
        100.0 * need / 3.35e12 / 320e-6)
    assert decode_mla_ms.read(rec) == pytest.approx(0.004)
    assert mfu_decode_mla.read(rec) == pytest.approx(
        100.0 * 2 * mla_roofline.step_flops(m, 3, 640) / (0.004 * 989e12))
    # a parent without the latent kernels or the scope reads nothing
    old = dict(rec, events=[("gemm", "model", 1.0)], scopes=[""])
    assert k1_mla_roofline.read(old) is None
    assert decode_mla_ms.read(old) is None
    assert mfu_decode_mla.read(dict(rec, model={})) is None
    assert all(r.read(None) is None for r in (k1_mla_roofline,
                                              decode_mla_ms, mfu_decode_mla))


def test_cell_files_load():
    wl = workload(CELL)
    assert wl["driver"] == "decode_turns_mla"
    assert (wl["prompt_tokens"], wl["prefill_chunk"], wl["batch"],
            wl["turn_tokens"], wl["chunk"]) == (131072, 32768, 40, 512, 128)
    assert set(wl["limits"]) == {"logit_gap", "code_mismatch",
                                 "codebook_excess", "route_mismatch"}
    m = wl["model"]
    cat = {k: m[k] for k in ("kv_lora_rank", "qk_nope_head_dim",
                             "qk_rope_head_dim", "v_head_dim",
                             "n_routed_experts", "num_experts_per_tok",
                             "n_shared_experts", "moe_intermediate_size",
                             "hidden_size", "vocab_size")}
    assert cat == dict(kv_lora_rank=512, qk_nope_head_dim=128,
                       qk_rope_head_dim=64, v_head_dim=128,
                       n_routed_experts=64, num_experts_per_tok=6,
                       n_shared_experts=2, moe_intermediate_size=1408,
                       hidden_size=2048, vocab_size=102400)
    assert m["num_hidden_layers"] == 8 and m["reduced"] == [
        "num_hidden_layers"]
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[CELL]["config"] == "deepseek-v2-lite"
    from pqcache_tpu_torch.config import DeepseekV2Config, ModelConfig
    assert isinstance(ModelConfig.from_hf_config(m), DeepseekV2Config)


def _run(seed: int, wl=None) -> dict:
    from benchmark.drivers import decode_turns_mla
    return decode_turns_mla.run(dict(
        workload=wl or tiny_cell(), seed=seed, seconds=1.0, trace=False,
        device=torch.device("cpu"), t0=time.perf_counter()))


def test_sound_run_is_correct():
    res = _run(5)
    assert all(c["ok"] for c in res["checks"]), res["checks"]
    names = [c["name"] for c in res["checks"]]
    assert names == ["code_mismatch", "codebook_excess", "logit_gap",
                     "route_mismatch"]
    assert res["judged"] > 0 and res["metrics"]["tok_s"] > 0


def test_unscaled_program_is_not_correct(monkeypatch):
    # the program's absorbed query without YaRN's mscale^2 (transformers'
    # in-tree scale): logit_gap catches it (about 1.7 at seed 5, against
    # 0.13 for the sound program)
    from pqcache_tpu_torch.config import DeepseekV2Config
    monkeypatch.setattr(DeepseekV2Config, "softmax_scale",
                        property(lambda self: self.qk_head_dim ** -0.5))
    res = _run(5)
    bad = {c["name"] for c in res["checks"] if not c["ok"]}
    assert "logit_gap" in bad, res["checks"]
