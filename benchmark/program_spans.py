"""The program's always-on spans (``pqcache_tpu_torch/runtime/stages.py``),
as the per-layer metrics of source ``program_span`` read them.

``snapshot()`` is the registry of the measuring process, every device time
resolved, or None where the program keeps no spans. A record's device
times are host-clock nanoseconds, None for a host-only span.
"""

from __future__ import annotations

import statistics


def snapshot():
    from pqcache_tpu_torch.runtime import stages
    snap = getattr(stages, "snapshot", None)
    return None if snap is None else snap()


def records(snap, name: str) -> list:
    """The device-timed records named ``name``, oldest first."""
    if not snap:
        return []
    return [r for r in snap["records"]
            if r["name"] == name and r["dev_start_ns"] is not None]


def device_s(r: dict) -> float:
    return (r["dev_end_ns"] - r["dev_start_ns"]) / 1e9


def host_s(r: dict) -> float:
    return (r["host_end_ns"] - r["host_start_ns"]) / 1e9


def has_ancestor(r: dict, name: str, by_id: dict) -> bool:
    """Whether a span named ``name`` encloses r (by the parent links)."""
    p = by_id.get(r["parent"])
    while p is not None:
        if p["name"] == name:
            return True
        p = by_id.get(p["parent"])
    return False


def median_ms(values) -> float | None:
    values = list(values)
    return statistics.median(values) * 1e3 if values else None
