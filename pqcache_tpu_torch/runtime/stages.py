"""Named stages of a batched decode step, for torch.profiler.

``stage(name)`` marks a part of the step (the scorer, the top-k, K1, the
segment merge, the matmuls, the appends, the flush) as a profiler range
"stage:<name>" while ``recording()`` is active, and is a no-op otherwise:
the decode path pays nothing for the marks unless a profile asks for them.
A profile then attributes each kernel launch on the host to the stage whose
range holds it (``chip_smoke.py``). Inside a replayed CUDA graph no host
code runs, so the marks see only eager and captured steps.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "stage:"
_on = False


def stage(name: str):
    """A profiler range named PREFIX + name while recording, else nothing."""
    if not _on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def recording():
    """Mark stages while the block runs."""
    global _on
    prev, _on = _on, True
    try:
        yield
    finally:
        _on = prev
