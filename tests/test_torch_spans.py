"""The always-on spans and counters of ``runtime/stages.py``.

The CPU tests hold the records (ids, parents, the ring and its totals,
host-only records where CUDA is not in use, the profiler range under
``recording()``, ``clear``) and the spans the port opens at its layer
boundaries: every prefill entry point, the k-means tail, the slot insert,
a decode chunk with its replays and flush. The tests marked ``cuda`` skip
without a card; on one (``python -m pytest tests/test_torch_spans.py
--noconftest``) they hold the device times, a captured chunk under
``set_sync_debug_mode("error")``, a span inside a capture, the clock
mapping, and that no span waits for the card.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from pqcache_tpu_torch import config
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime import stages
from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder

P = 256
# the clock mapping's stated error on the card (the anchors' half-waits
# are 10-17 us on an H100)
CLOCK_TOL_NS = 100_000


@pytest.fixture(autouse=True)
def _empty_registry():
    stages.clear()
    yield
    stages.clear()


@pytest.fixture
def no_cuda(monkeypatch):
    """CUDA not in use, whatever the machine has."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device times come from the card")
    return torch.device("cuda")


def _by_name(snap, name):
    return [r for r in snap["records"] if r["name"] == name]


def _setup(dev, policy="pq_search"):
    """A 2-layer model and its policy; on cuda at the kernels' head dim."""
    cuda = dev.type == "cuda"
    kw = (dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=64,
               intermediate_size=512) if cuda else {})
    cfg = config.tiny_model_config(num_layers=2, **kw)
    ecfg = config.EngineConfig(
        model=cfg, pq=config.PQConfig(n_subbits=4, kmeans_iters=4,
                                      select_block=64 if cuda else 16),
        budget=config.BudgetConfig(compress_ratio=0.3, sink_size=4),
        runtime=config.RuntimeConfig(policy=policy, max_new_tokens=24))
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    pol = get_policy(ecfg, compute_budget(ecfg.budget, P, 24), device=dev)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, P)).to(dev)
    return cfg, params, pol, ids


def _decoder(dev, graph, B=2, chunk=4):
    """A prefilled state inserted into B slots and its decoder."""
    cfg, params, pol, ids = _setup(dev)
    st = pol.init_state()
    logits = llama.prefill(cfg, params, pol, st, ids, 0, P)
    bstate = pol.init_batched_state(B)
    for s in range(B):
        pol.insert_slot(bstate, st, s)
    tok = torch.argmax(logits).to(torch.int32).repeat(B)
    pos = torch.full((B,), P, dtype=torch.int32, device=dev)
    dec = BatchedDecoder(cfg, params, pol, bstate, chunk=chunk, graph=graph,
                         device=dev)
    return dec, tok, pos


# -- the records -------------------------------------------------------------


def test_parents_and_ids(no_cuda):
    with stages.span("outer", slot=3) as outer:
        with stages.span("inner", layer=1, steps=8) as inner:
            pass
        with stages.span("inner", layer=2):
            pass
    with stages.span("after"):
        pass
    snap = stages.snapshot()
    recs = {r["id"]: r for r in snap["records"]}
    assert [r["name"] for r in snap["records"]] == ["inner", "inner",
                                                    "outer", "after"]
    assert recs[outer.id]["parent"] is None
    assert recs[outer.id]["ids"] == {"slot": 3}
    assert recs[inner.id]["parent"] == outer.id
    assert recs[inner.id]["ids"] == {"layer": 1, "steps": 8}
    assert [r["parent"] for r in _by_name(snap, "inner")] == [outer.id] * 2
    assert _by_name(snap, "after")[0]["parent"] is None
    assert len(set(recs)) == 4
    r = recs[outer.id]
    assert r["host_start_ns"] <= recs[inner.id]["host_start_ns"]
    assert recs[inner.id]["host_end_ns"] <= r["host_end_ns"]
    assert snap["totals"]["inner"]["count"] == 2


def test_a_span_that_raises_is_recorded_and_unwound(no_cuda):
    with pytest.raises(ValueError):
        with stages.span("failing"):
            raise ValueError("x")
    with stages.span("next") as nxt:
        pass
    snap = stages.snapshot()
    assert [r["name"] for r in snap["records"]] == ["failing", "next"]
    assert nxt.parent is None


def test_totals_outlive_the_ring(no_cuda):
    n = stages.RING + 10
    for i in range(n):
        with stages.span("x", i=i):
            pass
    snap = stages.snapshot()
    assert len(snap["records"]) == stages.RING
    assert snap["dropped"] == 10
    assert snap["records"][0]["ids"] == {"i": 10}       # the oldest kept
    assert snap["records"][-1]["ids"] == {"i": n - 1}
    tot = snap["totals"]["x"]
    assert tot["count"] == n and tot["host_s"] > 0
    assert tot["device_s"] == 0.0


def test_records_are_host_only_without_cuda(no_cuda):
    with stages.span("host") as sp:
        torch.ones(64).sum()
    snap = stages.snapshot()
    (r,) = snap["records"]
    assert r["dev_start_ns"] is None and r["dev_end_ns"] is None
    assert sp.device_s is None and sp.host_s > 0
    assert r["host_end_ns"] >= r["host_start_ns"]


def test_counters_add():
    stages.count("c")
    stages.count("c", 4)
    stages.count("d", 0)
    assert stages.snapshot()["counters"] == {"c": 5, "d": 0}


def test_stage_range_only_under_recording(no_cuda):
    from torch.profiler import ProfilerActivity, profile

    def names(record):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with (stages.recording() if record else
                  contextlib.nullcontext()):
                with stages.span("probe"):
                    torch.ones(8).add_(1)
        return [e.name for e in prof.events()]
    assert stages.PREFIX + "probe" in names(True)
    assert not any(n.startswith(stages.PREFIX) for n in names(False))
    # both profiles' spans are recorded all the same
    assert stages.snapshot()["totals"]["probe"]["count"] == 2


def test_clear_empties_the_registry(no_cuda):
    with stages.span("a"):
        stages.count("n", 2)
    stages.clear()
    snap = stages.snapshot()
    assert snap["records"] == [] and snap["totals"] == {}
    assert snap["counters"] == {} and snap["dropped"] == 0
    with stages.span("b") as b:
        pass
    assert b.parent is None
    assert [r["name"] for r in stages.snapshot()["records"]] == ["b"]


def test_parents_are_per_thread(no_cuda):
    import threading
    seen = {}

    def other():
        with stages.span("t") as t:
            seen["parent"] = t.parent
    with stages.span("main"):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    assert seen["parent"] is None


# -- the spans at the port's layer boundaries --------------------------------


def _prefill_calls(name, cfg, params, pol, ids):
    st = pol.init_state()
    if name == "prefill":
        llama.prefill(cfg, params, pol, st, ids, 0, P)
    elif name == "prefill_chunked":
        llama.prefill_chunked(cfg, params, pol, st, ids, 0, P, chunk=64)
    elif name == "prefill_with_prefix":
        k, v = llama.prefill_capture_kv(cfg, params, ids[:128])
        llama.prefill_with_prefix(cfg, params, pol, st, k, v, ids[128:],
                                  P - 128)
    else:       # the serving engine's chunk-major slabs, then the tail
        L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        kbuf = torch.zeros((L, Hkv, P, D), dtype=torch.float32)
        vbuf = torch.zeros_like(kbuf)
        h = None
        for c0 in range(0, P, 64):
            h = llama.prefill_chunk_step(
                cfg, params, kbuf, vbuf,
                llama.embed_lookup(params, ids[c0:c0 + 64]), 0, c0)
        llama.prefill_finish_tail(cfg, params, pol, st, kbuf, vbuf, h, 0, P)


PREFILL_ROOTS = {"prefill": [P], "prefill_chunked": [P],
                 "prefill_with_prefix": [P - 128],
                 "chunk_step+finish_tail": [64] * 4 + [P]}


@pytest.mark.parametrize("entry", list(PREFILL_ROOTS))
def test_every_prefill_entry_is_a_span_over_its_tails(no_cuda, entry):
    cfg, params, pol, ids = _setup(torch.device("cpu"))
    _prefill_calls(entry, cfg, params, pol, ids)
    snap = stages.snapshot()
    pre = _by_name(snap, "prefill")
    assert [r["ids"]["tokens"] for r in pre] == PREFILL_ROOTS[entry]
    assert all(r["parent"] is None for r in pre)
    tails = _by_name(snap, "prefill_tail")
    assert [r["ids"]["layer"] for r in tails] == list(range(cfg.num_layers))
    # each tail inside the prefill span that ran it: the last
    assert {r["parent"] for r in tails} == {pre[-1]["id"]}


@pytest.mark.parametrize("policy", ["pq_search", "original"])
def test_insert_slot_spans(no_cuda, policy):
    cfg, params, pol, ids = _setup(torch.device("cpu"), policy=policy)
    st = pol.init_state()
    llama.prefill(cfg, params, pol, st, ids, 0, P)
    bstate = pol.init_batched_state(3)
    for s in (2, 0, 1):
        pol.insert_slot(bstate, st, s)
    ins = _by_name(stages.snapshot(), "insert_slot")
    assert [r["ids"] for r in ins] == [{"slot": 2}, {"slot": 0}, {"slot": 1}]
    assert all(r["parent"] is None for r in ins)


def test_decode_chunks_hold_their_replays_and_flush(no_cuda):
    dec, tok, pos = _decoder(torch.device("cpu"), graph=False, chunk=4)
    stages.clear()
    dec.generate(tok, pos, 7)
    snap = stages.snapshot()
    chunks = _by_name(snap, "chunk")
    assert [r["ids"] for r in chunks] == [{"chunk": 0, "steps": 4},
                                          {"chunk": 1, "steps": 3}]
    assert dec.chunks == 2
    for name, ids in (("replay", [{"steps": 4, "captured": False},
                                  {"steps": 3, "captured": False}]),
                      ("flush", [{}, {}])):
        recs = _by_name(snap, name)
        assert [r["ids"] for r in recs] == ids
        assert [r["parent"] for r in recs] == [c["id"] for c in chunks]
    assert set(snap["totals"]) == {"chunk", "replay", "flush"}


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_device_times_filled_after_snapshot(dev):
    x = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize()
    with stages.span("mm") as sp:
        for _ in range(20):
            x = torch.tanh(x @ x * 1e-3)
    assert sp.dev_start is None         # nothing resolved without a wait
    snap = stages.snapshot()
    (r,) = _by_name(snap, "mm")
    assert r["dev_start_ns"] is not None and r["dev_end_ns"] > r[
        "dev_start_ns"]
    assert sp.device_s > 0
    # the device ends after the host enqueued the work
    assert r["dev_end_ns"] >= r["host_end_ns"] - CLOCK_TOL_NS
    assert snap["totals"]["mm"]["device_s"] == pytest.approx(sp.device_s)
    assert torch.cuda.current_device() in snap["clocks"]


@pytest.mark.cuda
def test_captured_chunk_never_syncs(dev):
    # a chunk whose first step captures the graph, then a replayed chunk,
    # every span on, under set_sync_debug_mode("error"): no span reads
    # anything on the host
    dec, tok, pos = _decoder(dev, graph=True, chunk=4)
    torch.cuda.synchronize()
    stages.clear()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = dec.decode(tok, pos, 4)
        dec.decode(out[-1], pos + 4, 4)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    snap = stages.snapshot()
    reps = _by_name(snap, "replay")
    assert [r["ids"]["captured"] for r in reps] == [True, False]
    (cap,) = _by_name(snap, "capture")
    assert cap["parent"] == reps[0]["id"]
    assert dec.capture_seconds == pytest.approx(
        (cap["host_end_ns"] - cap["host_start_ns"]) / 1e9)
    for r in snap["records"]:
        assert r["dev_start_ns"] is not None, r
    assert dec.replays == 7


@pytest.mark.cuda
def test_span_inside_a_capture_is_host_only(dev):
    x = torch.ones(1024, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2                                 # warm on the side stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        with stages.span("captured"):
            y = x * 2
    x.fill_(3)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 6))
    (r,) = _by_name(stages.snapshot(), "captured")
    assert r["dev_start_ns"] is None and r["host_end_ns"] > r[
        "host_start_ns"]


@pytest.mark.cuda
def test_clock_mapping_agrees_with_the_host(dev):
    # an empty span on an idle card, over seconds in which the base moves
    # and the rate is refit: its device start cannot precede the host's
    # record of it, nor its end the return of the host's synchronize after
    # it, by more than the mapping's stated error (how long an idle card
    # takes to run the record is launch latency, not the mapping's)
    torch.ones(1, device=dev)
    errs = []
    for pause in (0.0, 0.5, 2.0, 1.5):
        time.sleep(pause)
        torch.cuda.synchronize()
        with stages.span("probe"):
            pass
        torch.cuda.synchronize()
        h1 = time.perf_counter_ns()
        r = _by_name(stages.snapshot(), "probe")[-1]
        errs.append((r["dev_start_ns"] - r["host_start_ns"],
                     h1 - r["dev_end_ns"]))
    print("clock", stages.snapshot()["clocks"], "start after the record, "
          "end before the wait returned (ns)", errs)
    for after_record, before_return in errs:
        assert after_record >= -CLOCK_TOL_NS
        assert before_return >= -CLOCK_TOL_NS


@pytest.mark.cuda
def test_spans_never_wait_for_the_card(dev):
    # 200 spans opened and closed behind a kernel that keeps the card busy
    # for about a second: the card is still busy when they are done, so
    # none of them waited (a few hundred records stay inside the card's
    # launch queue, which a full queue would block the host on)
    with stages.span("warm"):
        pass
    torch.cuda.synchronize()
    busy = torch.cuda.Event()
    torch.cuda._sleep(2_000_000_000)
    busy.record()
    for _ in range(200):
        with stages.span("behind"):
            pass
    still_busy = not busy.query()
    snap = stages.snapshot()
    assert still_busy
    recs = _by_name(snap, "behind")
    assert len(recs) == 200
    assert all(r["dev_start_ns"] >= r["host_end_ns"] for r in recs)


@pytest.mark.cuda
def test_span_host_cost(dev):
    # the host cost of an empty span's enter and exit on the card, over
    # 10^4 spans on an idle card (printed; a bound far above it)
    n = 10_000
    with stages.span("warm"):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with stages.span("empty"):
            pass
    per_us = (time.perf_counter_ns() - t0) / n / 1e3
    snap = stages.snapshot()
    print(f"span enter+exit on cuda: {per_us:.2f} us a span ({n} spans)")
    assert snap["totals"]["empty"]["count"] == n
    assert snap["totals"]["empty"]["device_s"] > 0
    assert per_us < 200
