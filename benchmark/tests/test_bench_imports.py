"""What a run loads: never JAX or the JAX package, compared by whole
top-level names; and a run outside a checkout of the repo fails."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

PROBE = """
import sys
sys.path.insert(0, {repo!r})
import benchmark.run, benchmark.calibrate, benchmark.tracing
from benchmark.tests import tiny
import importlib, pkgutil, benchmark.layer_metrics as lm
for m in pkgutil.iter_modules(lm.__path__):
    importlib.import_module("benchmark.layer_metrics." + m.name)
tiny.run(1, 0.2)
print(benchmark.run.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=str(REPO))],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "pqcache_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pqcache_tpu.core", sys)
    assert run.forbidden_modules() == ["pqcache_tpu"]


def test_run_outside_a_checkout_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mistral7b-decode-32k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_dev):
    import json
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mistral7b-decode-32k", "--seed", "2147483648", "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, cwd=str(REPO),
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"tok_s", "setup_s"}
