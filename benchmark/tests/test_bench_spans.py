"""The six readers of the program's spans (``program_spans.py``): each
returns its number from a hand-filled registry, and None from an empty
one, from host-only records, or from a program that keeps no spans."""

import importlib

import pytest

from benchmark import program_spans
from pqcache_tpu_torch.runtime import stages

MS = 1_000_000                     # ns


def rec(id_, name, dev=None, host=(0, 1), parent=None, **ids):
    """A record: host and device (start, end) in ms."""
    d = (None, None) if dev is None else (dev[0] * MS, dev[1] * MS)
    return dict(id=id_, parent=parent, name=name, ids=ids,
                host_start_ns=host[0] * MS, host_end_ns=host[1] * MS,
                dev_start_ns=d[0], dev_end_ns=d[1])


def registry():
    records = [
        # set-up: a prefill holding a 500-ms build and a nested prefill
        rec(2, "build", host=(100, 600), parent=1),
        rec(3, "prefill", dev=(700, 900), parent=1, tokens=64),
        rec(1, "prefill", dev=(0, 2000), tokens=128),
        rec(4, "prefill", dev=(2100, 2400), tokens=32),    # another root
        # a turn: two inserts, then chunks 0 and 1 (the first captured)
        rec(5, "insert_slot", dev=(2500, 2501), slot=0),
        rec(6, "insert_slot", dev=(2501, 2504), slot=1),
        rec(8, "replay", dev=(2505, 3005), parent=7, steps=10,
            captured=True),
        rec(9, "flush", dev=(3005, 3010), parent=7),
        rec(7, "chunk", dev=(2504, 3010), chunk=0, steps=10),
        rec(11, "replay", dev=(3010.5, 3090.5), parent=10, steps=4,
            captured=False),
        rec(12, "flush", dev=(3090.5, 3097.5), parent=10),
        rec(10, "chunk", dev=(3010.5, 3097.5), chunk=1, steps=4),
        # the next turn: an insert, then chunks 2 and 3
        rec(13, "insert_slot", dev=(3100, 3102), slot=0),
        rec(15, "replay", dev=(3102, 3186), parent=14, steps=4,
            captured=False),
        rec(16, "flush", dev=(3186, 3195), parent=14),
        rec(14, "chunk", dev=(3102, 3195), chunk=2, steps=4),
        rec(18, "replay", dev=(3195.7, 3275.7), parent=17, steps=4,
            captured=False),
        rec(17, "chunk", dev=(3195.7, 3275.7), chunk=3, steps=4),
        rec(19, "insert_slot", slot=0),                   # host-only
    ]
    totals = {"prefill_tail": dict(count=8, host_s=0.1, device_s=0.3)}
    return dict(records=records, totals=totals, counters={}, dropped=0,
                clocks={})


# (metric, its number from registry())
WANT = {
    # roots 1 and 4: 2.0 + 0.3 s, less the build's 0.5 s of host time
    "setup.prefill_s": 1.8,
    "setup.tail_s": 0.3,
    # the device-timed inserts: 1, 3, 2 ms
    "admission.insert_ms": 2.0,
    # flushes of 5, 7, 9 ms
    "decode.flush_ms": 7.0,
    # 80 / 4, 84 / 4, 80 / 4 ms a step; the captured replay left out
    "decode.step_ms": 20.0,
    # chunk 0 -> 1: 0.5 ms and 2 -> 3: 0.7 ms; 1 -> 2 has an insert
    "decode.gap_ms": 0.6,
}


def reader(name):
    mod = name.replace(".", "_").replace("-", "_")
    return importlib.import_module(f"benchmark.layer_metrics.{mod}").read


@pytest.mark.parametrize("name", list(WANT))
def test_reader_reads_a_filled_registry(monkeypatch, name):
    monkeypatch.setattr(stages, "snapshot", registry)
    assert reader(name)(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", list(WANT))
def test_reader_of_an_empty_registry_is_none(monkeypatch, name):
    stages.clear()
    assert reader(name)(None) is None
    # nor from a program that keeps no spans (a tree before them)
    monkeypatch.delattr(stages, "snapshot")
    assert program_spans.snapshot() is None
    assert reader(name)(None) is None


@pytest.mark.parametrize("name", list(WANT))
def test_reader_of_host_only_records_is_none(monkeypatch, name):
    snap = registry()
    for r in snap["records"]:
        r["dev_start_ns"] = r["dev_end_ns"] = None
    snap["totals"]["prefill_tail"]["device_s"] = 0.0
    monkeypatch.setattr(stages, "snapshot", lambda: snap)
    assert reader(name)(None) is None


def test_a_tiny_run_opens_the_spans_the_readers_read():
    # on the CPU the records are host-only: the structure is the card's
    from benchmark.tests import tiny
    stages.clear()
    res = tiny.run(3, 0.5)
    snap = stages.snapshot()
    names = {r["name"] for r in snap["records"]}
    assert {"prefill", "prefill_tail", "insert_slot", "chunk", "replay",
            "flush"} <= names
    wl = tiny.cell()
    ins = [r for r in snap["records"] if r["name"] == "insert_slot"]
    # set-up, the warm-up turn and each window turn reset every slot
    assert len(ins) == wl["batch"] * (2 + res["attempted"] // wl["batch"])
    chunks = [r for r in snap["records"] if r["name"] == "chunk"]
    assert [r["ids"]["chunk"] for r in chunks] == list(range(len(chunks)))
    assert len(chunks) == 1 + len(res["paces"])
    stages.clear()
