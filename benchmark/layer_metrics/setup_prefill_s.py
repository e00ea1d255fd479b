"""setup.prefill_s: device seconds of the run's prefill spans that no
prefill span encloses, less the host seconds of the kernel build spans
inside them (a cold checkout's nvcc runs inside the first prefill)."""

from benchmark import program_spans as ps


def read(record):
    snap = ps.snapshot()
    if not snap:
        return None
    by_id = {r["id"]: r for r in snap["records"]}
    roots = [r for r in ps.records(snap, "prefill")
             if not ps.has_ancestor(r, "prefill", by_id)]
    if not roots:
        return None
    builds = [r for r in snap["records"] if r["name"] == "build"
              and ps.has_ancestor(r, "prefill", by_id)]
    return (sum(ps.device_s(r) for r in roots)
            - sum(ps.host_s(r) for r in builds))
