"""The AFMoE cell's pieces at toy widths on the CPU: the benchmark's copy
of the reference against the port's, the byte and FLOP counts of
``moe_roofline`` and ``mfu.decode.moe`` worked by hand, the cell's files,
and a whole run of the driver with a fault it must catch."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import afmoe_roofline, weights_afmoe
from benchmark.common import workload
from benchmark.reference.afmoe import AfmoeReference, route_mismatch

ROOT = Path(__file__).resolve().parent.parent
CELL = "trinity-mini-decode-128k"


def tiny_model() -> dict:
    m = json.loads((ROOT / "configs" / "trinity-mini.json").read_text())
    m.update(hidden_size=64, intermediate_size=96, num_attention_heads=16,
             num_key_value_heads=2, head_dim=16, vocab_size=256,
             moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2,
             sliding_window=8, init_std=0.1, max_position_embeddings=4096)
    m["pq"] = dict(m["pq"], n_subbits=4, kmeans_iters=3, select_block=16)
    return m


def tiny_cell(**limits) -> dict:
    lim = dict(logit_gap=1.0, code_mismatch=0.1, codebook_excess=0.05,
               route_mismatch=0.25)
    lim.update(limits)
    return dict(driver="decode_turns_afmoe", prompt_tokens=640,
                prefill_chunk=320, batch=2, turn_tokens=32, chunk=16,
                sample_turns=2, trace_steps=4, limits=lim,
                name="tiny-afmoe", config="tiny", model=tiny_model())


def test_reference_copy_is_the_ports_reference():
    # a budget that covers every candidate of every step, f32: the
    # benchmark's reference decodes the logits of the port's plain
    # forward pass, and routes the same experts
    from pqcache_tpu_torch.config import ModelConfig
    from pqcache_tpu_torch.models import afmoe_ref
    m = tiny_model()
    m["budget"] = dict(m["budget"], compress_ratio=1.5, recent_ratio=0.1,
                       sink=4)
    m["pq"] = dict(m["pq"], select_block=4)
    P, T = 300, 8
    wl = dict(model=m, prompt_tokens=P, chunk=4)
    w = weights_afmoe.draw(m, 11, "cpu")
    ids = np.random.default_rng(11).integers(0, 256, P)
    inputs = np.random.default_rng(12).integers(0, 256, (2, T))
    ref = AfmoeReference(wl, w, "cpu", "f32")
    ref.prefill(ids)
    keep, routes = [], []
    ref.decode(inputs, [], keep=keep, routes=routes)
    cfg = ModelConfig.from_hf_config(m)
    for b in range(2):
        r = []
        full = afmoe_ref.forward(cfg, w, torch.as_tensor(
            np.concatenate([ids, inputs[b]])), routes=r)
        assert max(float((keep[j][b] - full[P + j]).abs().max())
                   for j in range(T)) < 1e-4
        mine = [[x[b:b + 1] for x in step] for step in routes]
        theirs = [[x[P + j:P + j + 1] for x in r] for j in range(T)]
        assert route_mismatch(mine, theirs) == 0.0


def test_route_mismatch_counts_differing_sets():
    a = [[torch.tensor([[0, 1], [2, 3]])], [torch.tensor([[4, 5], [6, 7]])]]
    b = [[torch.tensor([[1, 0], [2, 4]])], [torch.tensor([[4, 5], [7, 6]])]]
    assert route_mismatch(a, b) == 0.25


def test_moe_bytes_by_hand():
    m = tiny_model()
    # per MoE layer: hit experts x 3 matrices of 64 x 32 bf16, the shared
    # expert's three, and 5 rows x 2 experts x 64 in and out, bf16
    hit = [8, 7, 6, 8, 5, 1]
    layer = [h * 3 * 64 * 32 * 2 + 3 * 64 * 32 * 2 + 2 * 5 * 2 * 64 * 2
             for h in hit]
    assert afmoe_roofline.moe_step_bytes(m, 5, hit) == sum(layer)
    with pytest.raises(ValueError):
        afmoe_roofline.moe_step_bytes(m, 5, hit[:5])


def test_step_flops_by_hand():
    m = tiny_model()
    P, B = 640, 3
    # budget at 640: n 608, local 60, topk 60 -> 4 blocks of 16
    rows_full = 32 + 4 * 16 + 60 + 1
    assert afmoe_roofline.attended_rows(m, P) == [8, 8, 8, rows_full] * 2
    attn = 64 * 256 + 64 * 32 + 64 * 32 + 64 * 256 + 256 * 64
    dense = attn + 3 * 64 * 96
    moe = attn + 64 * 8 + 3 * 3 * 64 * 32
    weights = 2 * dense + 6 * moe + 64 * 256
    want = 2.0 * weights * B + B * 4.0 * 16 * 16 * (6 * 8 + 2 * rows_full)
    assert afmoe_roofline.step_flops(m, B, P) == want


def test_cell_files_load():
    wl = workload(CELL)
    assert wl["driver"] == "decode_turns_afmoe"
    assert (wl["prompt_tokens"], wl["prefill_chunk"], wl["batch"],
            wl["turn_tokens"], wl["chunk"]) == (131072, 32768, 80, 512, 128)
    assert set(wl["limits"]) == {"logit_gap", "code_mismatch",
                                 "codebook_excess", "route_mismatch"}
    m = wl["model"]
    assert m["num_hidden_layers"] == len(m["layer_types"]) == 8
    assert m["layer_types"].count("full_attention") == 2
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[CELL]["config"] == "trinity-mini"
    from pqcache_tpu_torch.config import AfmoeConfig, ModelConfig
    assert isinstance(ModelConfig.from_hf_config(m), AfmoeConfig)


def _run(seed: int, wl=None) -> dict:
    from benchmark.drivers import decode_turns_afmoe
    return decode_turns_afmoe.run(dict(
        workload=wl or tiny_cell(), seed=seed, seconds=1.0, trace=False,
        device=torch.device("cpu"), t0=time.perf_counter()))


def test_sound_run_is_correct():
    res = _run(5)
    assert all(c["ok"] for c in res["checks"]), res["checks"]
    names = [c["name"] for c in res["checks"]]
    assert names == ["code_mismatch", "codebook_excess", "logit_gap",
                     "route_mismatch"]


def test_misrouted_program_is_not_correct(monkeypatch):
    # the program selects each row's experts by score alone, ignoring the
    # bias: route_mismatch catches it
    from pqcache_tpu_torch.models import afmoe
    orig = afmoe.route

    def unbiased(cfg, lp, x):
        return orig(cfg, dict(lp, expert_bias=lp["expert_bias"] * 0), x)
    monkeypatch.setattr(afmoe, "route", unbiased)
    res = _run(5)
    bad = {c["name"] for c in res["checks"] if not c["ok"]}
    assert "route_mismatch" in bad, res["checks"]


def test_routes_pass_must_serve_the_served_tokens(monkeypatch, capsys):
    # served tokens that the eager pass does not reproduce (here each one
    # moved to the next id) make the run not correct, route_mismatch left
    # unread: it would otherwise judge a pass that is not the computation
    # that was served
    from benchmark.drivers import decode_turns_afmoe
    orig = decode_turns_afmoe.Program.turn

    def shifted(self, *a, **kw):
        first, toks = orig(self, *a, **kw)
        return first, (toks + 1) % self.model.vocab_size
    monkeypatch.setattr(decode_turns_afmoe.Program, "turn", shifted)
    res = _run(5)
    rm = {c["name"]: c for c in res["checks"]}["route_mismatch"]
    assert rm["value"] is None and not rm["ok"], res["checks"]
    assert "greedy tokens differ" in capsys.readouterr().err
