"""decode.gap_ms: the median device ms from one chunk span's end to the
next one's start, where no insert_slot span lies between them (within a
turn): the caller's read-back and bookkeeping between chunks."""

from benchmark import program_spans as ps


def read(record):
    snap = ps.snapshot()
    chunks = sorted(ps.records(snap, "chunk"), key=lambda r: r["id"])
    inserts = sorted(r["id"] for r in (snap or {}).get("records", ())
                     if r["name"] == "insert_slot")
    gaps = []
    for a, b in zip(chunks, chunks[1:]):
        if any(a["id"] < i < b["id"] for i in inserts):
            continue
        gaps.append((b["dev_start_ns"] - a["dev_end_ns"]) / 1e9)
    return ps.median_ms(gaps)
