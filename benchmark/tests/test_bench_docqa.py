"""The document-QA workload at toy widths on the CPU: its files, the
Poisson arrivals, chunk pacing, and whole runs of the driver through the
serving engine's prefix cache, with a fault it must catch."""

import json
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.common import workload
from benchmark.drivers import docqa_prefix as dq
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parent.parent
CELL = "nemo12b-docqa-prefix"


def tiny_cell(**limits) -> dict:
    wl = tiny.cell(int8=True)
    wl.update(driver="docqa_prefix", prefix_tokens=512, question_min=16,
              question_max=64, answer_tokens=8, pool=2, chunk=4, rate=6.0,
              judged=2, judge_from=4, trace_steps=1)
    wl["limits"] = dict(logit_gap=0.3, code_mismatch=0.05,
                        codebook_excess=0.01, **limits)
    return wl


def test_cell_files_load():
    wl = workload(CELL)
    assert wl["driver"] == "docqa_prefix"
    assert (wl["prefix_tokens"], wl["question_min"], wl["question_max"],
            wl["answer_tokens"], wl["pool"]) == (98304, 512, 2048, 128, 16)
    assert wl["rate"] > 0 and wl["model"]["name"] == "mistral-nemo-12b"
    assert set(wl["limits"]) == {"logit_gap", "code_mismatch",
                                 "codebook_excess"}
    # not a cell of BENCHMARK.json: its time-between-tokens tail spreads
    # far wider than half its bound over seeds (PERF.md)
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    assert CELL not in {w["name"] for w in bench["workloads"]}


def test_arrivals_are_poisson_from_the_seed():
    wl = dict(tiny_cell(), rate=50.0)
    reqs, at = dq.requests(wl, 7, 200.0)
    again, at2 = dq.requests(wl, 7, 200.0)
    assert at == at2 and all(np.array_equal(a[1], b[1])
                             for a, b in zip(reqs, again))
    gaps = np.diff([0.0] + [at[s] for s, _ in reqs])
    assert abs(len(reqs) / 200.0 - 50.0) < 2.0
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05   # exponential
    lens = [len(q) for _, q in reqs]
    assert min(lens) == 16 and max(lens) == 64


def test_chunk_pacing():
    timing = {0: {"token_times": [1.0, 2.0, 2.0, 2.0, 2.5]},
              1: {"token_times": [3.0]}}
    assert dq.tbt_gaps(timing) == [1 / 3] * 3 + [0.5]


def _run(seed: int, wl=None) -> dict:
    return dq.run(dict(workload=wl or tiny_cell(), seed=seed, seconds=1.0,
                       trace=False, device=torch.device("cpu"),
                       t0=time.perf_counter()))


def test_sound_run_is_correct():
    res = _run(3)
    assert all(c["ok"] for c in res["checks"]), res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert res["judged"] == 2 * 7
    assert res["metrics"]["tbt_p99_ms"] > 0


def test_a_faulty_prefix_is_not_correct(monkeypatch):
    # the prefix cache's document K/V from another document: the program's
    # answers and codes no longer belong to the judged prompts
    from pqcache_tpu_torch.runtime.generate import Engine
    orig = Engine.prefill_prefix

    def other(self, ids):
        return orig(self, (np.asarray(ids) + 1) % 256)
    monkeypatch.setattr(Engine, "prefill_prefix", other)
    res = _run(3)
    assert not all(c["ok"] for c in res["checks"]), res["checks"]
