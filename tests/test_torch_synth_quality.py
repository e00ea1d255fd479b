"""The port's synth_quality harness against the JAX package's, on the CPU.

The trainer: from JAX's initial parameters (``init_params`` with the
harness's seed, moved through ``bridge``) and the same numpy batches, the
port's autograd forward and its hand-written AdamW must give JAX's losses
before each of 3 steps and JAX's parameters after each: the float32
gradients are summed in another order, and Adam divides by |g| + 1e-8, so
where a gradient entry is itself near 1e-8 the update moves by up to lr.
So the norm weights (near 1, gradients far from 0) hold to rtol 1e-5 /
atol 1e-6, and every other tensor's mean |difference| to 1e-7 (3.9e-8
measured after 3 steps), no entry further apart than one update (lr). A
weight decay of 1e-2 (torch's AdamW default) in place of optax's 1e-4
moves the norm weights by 6e-5 and the others by 1e-6 on average in 3
steps.

The quality gate is tests/test_synth_quality.py's, trained by the port
(copy task, N 96, 200 steps, batch 16) and evaluated through the port's
Engine: full attention free-runs the copy (>= 0.95), pq_search at 1/5
budget keeps it (>= 0.90), h2o under the same budget loses at least 0.10
to pq_search. ``torch.set_num_threads(1)``: the suite runs with several
workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pqcache_tpu.harness import synth_quality as jsq
from pqcache_tpu.models import llama as jllama
from pqcache_tpu_torch import bridge
from pqcache_tpu_torch.harness import synth_quality as sq

torch.set_num_threads(1)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
N = 96          # copy half-length; prompt = N+4 tokens
STEPS = 200


def _jax_loss(cfg, params, toks, mask):
    logits = jsq.lm_forward(cfg, params, jnp.asarray(toks))[:, :-1]
    ce = optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(toks)[:, 1:])
    mask = jnp.asarray(mask)
    return float((ce * mask).sum() / jnp.maximum(mask.sum(), 1.0))


def _flat(params):
    return [(k, v) for k, v in params.items() if k != "layers"] + [
        (f"layers/{k}", v) for k, v in params["layers"].items()]


def test_trainer_matches_optax_adamw(monkeypatch):
    n, batch = 16, 4
    cfg = sq.model_config(n)
    jp0 = jax.tree.map(np.asarray, jllama.init_params(
        cfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    monkeypatch.setattr(sq.llama, "init_params", lambda *a, **kw:
                        bridge.params_from_numpy(jp0, device="cpu"))
    rng = np.random.default_rng(0)
    batches = [jsq.gen_copy(rng, n, batch) for _ in range(3)]
    mask = np.broadcast_to((np.arange(1, 2 * n) >= n).astype(np.float32),
                           (batch, 2 * n - 1)).copy()
    jprev, tprev = jp0, bridge.params_from_numpy(jp0, device="cpu")
    for k in range(1, 4):
        # the loss of step k, on its batch, before its update
        want = _jax_loss(cfg, jprev, batches[k - 1], mask)
        got = sq.loss_fn(cfg, tprev, torch.from_numpy(batches[k - 1]),
                         torch.from_numpy(mask)).item()
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
        jprev = jax.tree.map(np.asarray, jsq.train(cfg, n, k, batch=batch))
        tprev = sq.train(cfg, n, k, batch=batch, device="cpu")
        for (name, t), (_, j) in zip(_flat(tprev), _flat(jprev)):
            t = t.numpy()
            if "norm" in name or "ln" in name:
                np.testing.assert_allclose(t, j, err_msg=f"{k} {name}",
                                           **PARAM_TOL)
                continue
            d = np.abs(t - j)
            assert d.mean() <= 1e-7 and d.max() <= 2e-3, (k, name, d.mean(),
                                                         d.max())
    # the data generators are the JAX harness's own
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(sq.gen_copy(r1, 8, 2),
                                  jsq.gen_copy(r2, 8, 2))
    for a, b in zip(sq.gen_copy_varlen(r1, 8, 3),
                    jsq.gen_copy_varlen(r2, 8, 3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sq.gen_kv(r1, 20, 2, depth=0.5),
                    jsq.gen_kv(r2, 20, 2, depth=0.5)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def trained():
    cfg = sq.model_config(N)
    return cfg, sq.train(cfg, N, STEPS, batch=16, device="cpu")


def test_pq_search_matches_full_attention_h2o_degrades(trained):
    cfg, params = trained
    acc = sq.evaluate(cfg, params, ["original", "pq_search", "h2o"], N,
                      eval_n=6, gen=12, device="cpu")
    assert acc["original"] >= 0.95, acc
    assert acc["pq_search"] >= 0.90, acc
    assert acc["h2o"] <= acc["pq_search"] - 0.10, acc


def test_cli_runs_the_recall_task_on_the_cpu(capsys):
    # the command line end to end at toy size: train, then associative
    # recall through the Engine for each policy
    sq.main(["--task", "recall", "--pairs", "8", "--n", "16", "--steps",
             "2", "--batch", "2", "--eval-n", "2", "--device", "cpu",
             "--policies", "original", "sparq_f"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json
    out = json.loads(line)
    assert set(out["accuracy"]) == {"original", "sparq_f"}
    for v in out["accuracy"].values():
        assert 0.0 <= v["a1_prefill"] <= 1.0
