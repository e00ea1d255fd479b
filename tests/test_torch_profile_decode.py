"""harness/profile_decode.py of the port, and the replayed-step split of
harness/trace.py.

``run`` at a toy size on the CPU prints the JAX CLI's lines, and its decode
from the randomized state (the same numpy draws) gives the JAX package's
``decode_loop`` tokens, in float32 with the JAX weights moved through
``bridge`` and ``adc_mode="v1"`` on both sides (JAX's XLA route sums the
f32 LUT). ``trace.decompose_replayed`` joins a decoder's steps to one eager
step by order: here on the CPU with an eager decoder (the ``aten::`` ops
stand in); ``tests/test_torch_cuda.py`` (no JAX there) holds it on the card
with a replayed one.
"""

import re

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
from pqcache_tpu_torch.harness import profile_decode as pdec
from pqcache_tpu_torch.harness import trace as tr
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy

torch.set_num_threads(1)
CTX, STEPS, REPS = 512, 4, 2
TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            rope_theta=10000.0, max_position_embeddings=4096)


@pytest.fixture(scope="module")
def weights():
    jmodel = jconfig.ModelConfig(name="t", **TINY)
    jparams = jllama.init_params(jmodel, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jmodel, jparams, config.ModelConfig(name="t", **TINY), params


def _jax_tokens(jmodel, jparams, policy, block):
    """The JAX CLI's run (profile_decode.py:47-107) in float32: the state
    randomized from the same draws, a first decode loop and REPS more."""
    cfg = jconfig.EngineConfig(
        model=jmodel,
        pq=jconfig.PQConfig(n_subvec_per_head=2, n_subbits=6, kmeans_iters=6,
                            select_block=block, adc_mode="v1"),
        budget=jconfig.BudgetConfig(compress_ratio=0.2, recent_ratio=0.5,
                                    sink_size=32),
        runtime=jconfig.RuntimeConfig(policy=policy, prefill_bucket=1024,
                                      max_new_tokens=64,
                                      max_seq_len=CTX * 2))
    budget = jcompute_budget(cfg.budget, CTX, 64)
    pol = jget_policy(cfg, budget)
    st = pol.init_state(jnp.float32)
    rng = np.random.default_rng(0)
    if policy == "pq_search":
        st = st.replace(
            n_cand=jnp.asarray(budget.n_cand_init, jnp.int32),
            pos=jnp.asarray(CTX, jnp.int32),
            codes=jnp.asarray(rng.integers(0, 64, size=st.codes.shape),
                              st.codes.dtype),
            centroids=jnp.asarray(rng.normal(size=st.centroids.shape),
                                  jnp.float32),
            kv_tail=jnp.asarray(rng.normal(size=st.kv_tail.shape) * 0.1,
                                jnp.float32))
    else:
        st = st.replace(length=jnp.asarray(CTX, jnp.int32),
                        pos=jnp.asarray(CTX, jnp.int32))
    f = jax.jit(lambda p, s, t, pos: jllama.decode_loop(
        jmodel, p, pol, s, t, pos, STEPS))
    out = []
    for rep in range(REPS + 1):
        toks, st = f(jparams, st, jnp.asarray(3, jnp.int32),
                     jnp.asarray(CTX + STEPS * rep, jnp.int32))
        out.append(np.asarray(toks))
    return out


@pytest.mark.parametrize("policy,block", [("pq_search", 1),
                                          ("pq_search", 32),
                                          ("original", 1)])
def test_run_decodes_the_jax_tokens(weights, policy, block):
    jmodel, jparams, model, params = weights
    lines = []
    got = pdec.run(policy, model=model, params=params, ctx=CTX, steps=STEPS,
                   block=block, adc_mode="v1", device="cpu",
                   dtype=torch.float32, reps=REPS, log=lines.append)
    want = _jax_tokens(jmodel, jparams, policy, block)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert re.fullmatch(rf"{policy}: first \d+\.\ds", lines[0])
    assert len(lines) == 1 + REPS and all(
        re.fullmatch(rf"{policy}: \d+\.\d\d ms/step", x) for x in lines[1:])


def test_main_prints_its_lines(capsys, monkeypatch, weights):
    # the command line with PREFILL=1 and the default policies, at a toy
    # model: a prefill line, a first line and three ms/step lines each
    monkeypatch.setattr(pdec, "model_config", lambda layers, name="prof": (
        config.ModelConfig(name=f"{name}{layers}L", **dict(
            TINY, num_layers=layers))))
    env = dict(CTX="512", LAYERS="2", STEPS="2", PREFILL="1", BLOCK="32")
    out = pdec.main(["--device", "cpu"], env=env)
    assert list(out) == ["original", "pq_search"]
    assert all(len(v) == 4 and v[0].shape == (2,) for v in out.values())
    lines = capsys.readouterr().out.splitlines()
    pat = [r"prefill \d+\.\ds", r"first \d+\.\ds"] + [r"\d+\.\d\d ms/step"] * 3
    want = [rf"{p}: {x}" for p in ("original", "pq_search") for x in pat]
    assert len(lines) == len(want), lines
    assert all(re.fullmatch(w, x) for w, x in zip(want, lines)), lines


def test_settings_read_nothing_at_import():
    s = pdec.settings({})
    assert s == dict(ctx=4096, layers=2, steps=8, block=1, prefill=False,
                     adc_mode="v2", fetch_mode="gather", gather_mode="xla")
    m = pdec.model_config(2)
    assert (m.vocab_size, m.hidden_size, m.num_heads, m.num_kv_heads,
            m.head_dim, m.rope_theta, m.rope_scaling_factor) == (
        128256, 4096, 32, 8, 128, 500000.0, 8.0)


def _batched(dev, B=2):
    """A 2-layer model at the kernels' smallest head dim (pq_search,
    select_block 64, int8 tail), B slots of one prefilled prompt in a
    batched state."""
    model = config.tiny_model_config(hidden_size=256, num_heads=4,
                                     num_kv_heads=2, head_dim=64,
                                     intermediate_size=512, num_layers=2)
    cfg = config.EngineConfig(
        model=model, pq=config.PQConfig(n_subbits=4, kmeans_iters=2,
                                        select_block=64),
        budget=config.BudgetConfig(compress_ratio=0.3, sink_size=4),
        cache=config.CacheConfig(kv_dtype="int8"),
        runtime=config.RuntimeConfig(policy="pq_search", max_new_tokens=24))
    params = llama.init_params(model, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    P = 512
    pol = get_policy(cfg, compute_budget(cfg.budget, P, 24), device=dev)
    bstate = pol.init_batched_state(B)
    st = pol.init_state()
    ids = np.random.default_rng(0).integers(0, model.vocab_size, size=P)
    first = int(torch.argmax(llama.prefill(
        model, params, pol, st, torch.from_numpy(ids).to(dev), 0, P)))
    for slot in range(B):
        pol.insert_slot(bstate, st, slot)
    return model, params, pol, bstate, torch.full(
        (B,), first, dtype=torch.int32, device=dev), torch.full(
        (B,), P, dtype=torch.int32, device=dev)


def _check_split(res, steps):
    assert res["joined"] == res["kernels"] * steps and res["launched"] == 0
    assert res["unmapped_ms"] == 0.0, res
    assert res["pq_ms"] > 0 and res["fetch_ms"] > 0 and res["model_ms"] > 0
    assert res["total_ms"] == pytest.approx(
        sum(res[f"{b}_ms"] for b in tr.BUCKETS))


def test_decompose_replayed_eager_decoder_on_the_cpu(tmp_path):
    # graph=False: the "replays" are eager steps, each the eager step's
    # aten ops in the same order
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    dev = torch.device("cpu")
    model, params, pol, bstate, tok, pos = _batched(dev)
    dec = BatchedDecoder(model, params, pol, bstate, chunk=8, graph=False,
                         device=dev)
    res = tr.decompose_replayed(dec, tok, pos, steps=3,
                                trace_dir=str(tmp_path))
    _check_split(res, 3)
    assert (tmp_path / "eager_steps.json").exists()
    assert (tmp_path / "replayed.json").exists()
    with pytest.raises(ValueError, match="do not fit a chunk"):
        tr.decompose_replayed(dec, tok, pos, steps=7)

