"""harness/trace.py of the port: the pq / fetch / transfer / model split of
a decode step from a torch.profiler trace, against the JAX package's.

The counterparts of ``tests/test_trace.py``: (a) a function inside a scope
mark is mapped to that scope, (b) the bucket classifier, (c) the per-step
aggregation on synthetic events (the JAX test's numbers) and (d) the whole
pipeline on the JAX test's tiny pq_search decode loop on the CPU, where the
``aten::`` ops stand in for kernels. Then parity: the port's profile
carries the same set of pq_* scopes as the JAX package's compiled HLO of
the same decode loop (compiled only), per token and at a block size; and
the order join of a replayed step's kernels to an eager step's scopes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu import config as jconfig
from pqcache_tpu.core.budget import compute_budget as jcompute_budget
from pqcache_tpu.harness import trace as jtrace
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.policies.base import get_policy as jget_policy
from pqcache_tpu_torch import config
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.harness import profile_decode as pdec
from pqcache_tpu_torch.harness import trace as tr
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime import stages

torch.set_num_threads(1)
CTX, STEPS = 512, 4
# the JAX test's tiny model, and one at head_dim 128 where the JAX package
# takes its Pallas routes (in interpret mode on the CPU): its block path
# then fetches through the scoped block-attention kernel, as the port's
# block path always does; at head_dim 32 the JAX package fetches by an
# unscoped advanced index instead
MODELS = {
    "tiny": dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                 num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                 rope_theta=10000.0, max_position_embeddings=4096),
    "tiny-d128": dict(vocab_size=256, hidden_size=256,
                      intermediate_size=256, num_layers=2, num_heads=2,
                      num_kv_heads=1, head_dim=128, rope_theta=10000.0,
                      max_position_embeddings=4096),
}


def _cfgs(name, select_block=1, n_subbits=4, kernels="auto"):
    kw = dict(
        pq=dict(n_subvec_per_head=2, n_subbits=n_subbits, kmeans_iters=2,
                select_block=select_block),
        budget=dict(compress_ratio=0.2, recent_ratio=0.5, sink_size=8),
        runtime=dict(policy="pq_search", prefill_bucket=128,
                     max_new_tokens=16, max_seq_len=CTX * 2))

    def build(mod, runtime_kw):
        return mod.EngineConfig(
            model=mod.ModelConfig(name="t", **MODELS[name]),
            pq=mod.PQConfig(**kw["pq"]),
            budget=mod.BudgetConfig(**kw["budget"]),
            runtime=mod.RuntimeConfig(**kw["runtime"], **runtime_kw))
    return build(jconfig, dict(kernels=kernels)), build(config, {})


def _port_decode(cfg, seed=0):
    """The port's tiny pq_search decode loop from the JAX test's randomized
    state: (callable running STEPS steps, the policy)."""
    model = cfg.model
    budget = compute_budget(cfg.budget, CTX, 16)
    pol = get_policy(cfg, budget, device="cpu")
    params = llama.init_params(model, torch.Generator().manual_seed(seed),
                               device="cpu")
    st = pol.init_state()
    pdec.randomize_state(st, budget, CTX, "pq_search", cfg.pq.n_centroids)
    return lambda: llama.decode_loop(model, params, pol, st,
                                     torch.tensor(3), CTX, STEPS), pol


def test_scope_map_maps_a_scoped_function():
    @stages.scoped("pq_score")
    def g(x):
        return x * 2 + 1

    x = torch.ones((32, 32))
    prof = tr.profiled(lambda: g(x).sum())
    smap = tr.scope_map(prof.events())
    assert smap, "no op mapped"
    assert any("pq_score" in s.split("/") for s in smap.values()), smap
    # off the recording the mark is no range at all, and it never counts
    # as a stage
    evs = tr.profiled(lambda: g(x).sum(), record=False).events()
    assert not any(tr.is_mark(e.name) for e in evs)
    assert not any(e.name.startswith(stages.PREFIX)
                   for e in prof.events())


def test_classify_buckets():
    assert tr.classify("k", "pq_score/aten::mul") == "pq"
    assert tr.classify("k", "stage:x/pq_select/aten::sort") == "pq"
    assert tr.classify("k", "pq_append/aten::argmin") == "pq"
    assert tr.classify("k", "pq_kmeans/aten::bmm") == "pq"
    assert tr.classify("block_attn_kernel<128>", "pq_fetch/cudaLaunchKernel"
                       ) == "fetch"
    assert tr.classify("k", "pq_select/pq_fetch/aten::index") == "fetch"
    assert tr.classify("Memcpy HtoD (Pageable -> Device)",
                       "pq_score/aten::copy_") == "transfer"
    assert tr.classify("Memset (Device)", "pq_fetch/aten::zero_") == \
        "transfer"
    assert tr.classify("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(...)",
                       "") == "transfer"
    assert tr.classify("c10d::allreduce_", "aten::mm") == "transfer"
    assert tr.classify("gemm_kernel", "aten::mm") == "model"
    assert tr.classify("k", "") == "model"


def test_decompose_events_per_step():
    smap = {0: "pq_score/aten::bmm", 1: "aten::mm"}
    ops = [(0, "a", 4000.0), (1, "b", 8000.0), (2, "Memcpy DtoD", 2000.0)]
    r = tr.decompose_events(ops, smap, steps=2)
    assert r["pq_ms"] == pytest.approx(2.0)
    assert r["model_ms"] == pytest.approx(4.0)
    assert r["transfer_ms"] == pytest.approx(1.0)
    assert r["fetch_ms"] == 0.0
    assert r["total_ms"] == pytest.approx(7.0)
    assert r["non_pq_ms"] == r["model_ms"]
    assert r["unmapped_ms"] == pytest.approx(1.0)  # key 2 has no launch


def test_decompose_tiny_decode(tmp_path):
    _, cfg = _cfgs("tiny")
    fn, _ = _port_decode(cfg)
    res = tr.decompose(fn, steps=STEPS, trace_dir=str(tmp_path))
    assert res["total_ms"] > 0
    # the ADC / top-k retrieval chain must be attributed to pq, not model
    assert res["pq_ms"] > 0, res
    assert res["model_ms"] > 0, res
    assert res["unmapped_ms"] == 0.0, res
    assert res["total_ms"] == pytest.approx(
        sum(res[f"{b}_ms"] for b in tr.BUCKETS))
    assert res["trace_dir"] == str(tmp_path)
    with open(tmp_path / "decode.json") as f:
        assert json.load(f)["traceEvents"]


def _pq_names(paths):
    return {p for s in paths for p in s.split("/") if p.startswith("pq_")}


@pytest.mark.parametrize("name,block,jkernels", [
    ("tiny", 1, "auto"), ("tiny-d128", 1, "pallas-interpret"),
    ("tiny-d128", 32, "pallas-interpret")])
def test_scopes_match_the_jax_hlo(name, block, jkernels):
    # the scopes around the port's launches = the scopes in the JAX
    # package's compiled decode loop (its HLO op_name metadata)
    n_subbits = 6 if name == "tiny-d128" else 4
    jcfg, cfg = _cfgs(name, block, n_subbits, jkernels)
    jbudget = jcompute_budget(jcfg.budget, CTX, 16)
    jpol = jget_policy(jcfg, jbudget)
    jparams = jllama.init_params(jcfg.model, jax.random.PRNGKey(0))
    jst = jpol.init_state(jnp.bfloat16)
    compiled = jax.jit(lambda p, s, t, pos: jllama.decode_loop(
        jcfg.model, p, jpol, s, t, pos, STEPS)).lower(
        jparams, jst, jnp.asarray(3, jnp.int32),
        jnp.asarray(CTX, jnp.int32)).compile()
    want = _pq_names(jtrace.hlo_scope_map(compiled.as_text()).values())

    fn, pol = _port_decode(cfg)
    prof = tr.profiled(fn)
    got = _pq_names(tr.scope_map(prof.events()).values())
    assert want, "the JAX HLO carries no pq_* scope"
    assert got == want, (got, want)
    assert ("pq_fetch" in got) == (block > 1)


def test_join_replayed_by_order():
    eager = [("adc", "pq_score/cudaLaunchKernel"), ("gemm", "aten::mm"),
             ("Memcpy DtoD (Device -> Device)", "aten::copy_"),
             ("k1", "pq_fetch/cudaLaunchKernel"), ("orphan", None)]
    durs = [10.0, 40.0, 1.0, 20.0, 5.0]
    # a graph runs its copy node as a kernel of its own
    step = [("memcpy32_post" if n.startswith("Memcpy") else n, d)
            for (n, _), d in zip(eager, durs)]
    joined = tr.join_replayed(eager, [step] * 3)
    assert [(n, s) for n, s, _ in joined] == eager * 3
    r = tr.decompose_events(
        ((i, n, d) for i, (n, _, d) in enumerate(joined)),
        {i: s for i, (_, s, _) in enumerate(joined) if s is not None},
        steps=3)
    assert r["pq_ms"] == pytest.approx(0.010)
    assert r["model_ms"] == pytest.approx(0.045)
    assert r["transfer_ms"] == pytest.approx(0.001)
    assert r["fetch_ms"] == pytest.approx(0.020)
    assert r["unmapped_ms"] == pytest.approx(0.005)
    assert r["total_ms"] == pytest.approx(0.076)
    assert tr.classify("memcpy32_post", "") == "transfer"
    # a replayed kernel the eager step did not launch at that index
    bad = list(step)
    bad[2] = ("other", 1.0)
    with pytest.raises(ValueError, match=r"step 1, device event 2: 'other'"):
        tr.join_replayed(eager, [step, bad, step])
    # one kernel too many, one too few
    with pytest.raises(ValueError, match=r"step 2, device event 5: 'adc'.*"
                       r"nothing there \(5 events\).*extra launches "
                       r"\{'adc': 1\}"):
        tr.join_replayed(eager, [step, step, step + [("adc", 1.0)]])
    with pytest.raises(ValueError, match=r"step 0 ends at device event 4"):
        tr.join_replayed(eager, [step[:-1]])


def test_trace_cli_on_the_cpu(capsys, monkeypatch, tmp_path):
    # the command line at a toy size: the JAX CLI's keys plus the device
    monkeypatch.setattr(pdec, "model_config", lambda layers, name="prof": (
        config.ModelConfig(name=f"{name}{layers}L", **dict(
            MODELS["tiny"], num_layers=layers))))
    env = dict(CTX="512", LAYERS="2", STEPS="2", BLOCK="32",
               TRACE_DIR=str(tmp_path))
    lines = tr.main(["pq_search", "original", "--device", "cpu"], env=env)
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["policy"] for x in out] == ["pq_search", "original"]
    # the lines print milliseconds to 3 places; main returns them whole
    assert all(x["total_ms"] == round(y["total_ms"], 3)
               for x, y in zip(out, lines))
    keys = {"pq_ms", "fetch_ms", "transfer_ms", "model_ms", "total_ms",
            "non_pq_ms", "unmapped_ms", "trace_dir", "policy", "ctx",
            "layers", "steps", "block", "wall_s", "device",
            "gpu_name_power"}
    assert all(set(x) == keys for x in out)
    pq, orig = out
    assert pq["pq_ms"] > 0 and pq["fetch_ms"] > 0 and pq["device"] == "cpu"
    assert orig["pq_ms"] == orig["fetch_ms"] == 0.0
    assert pq["gpu_name_power"] is None and pq["block"] == 32
    assert os.path.exists(os.path.join(str(tmp_path), "pq_search-block32",
                                       "decode.json"))
