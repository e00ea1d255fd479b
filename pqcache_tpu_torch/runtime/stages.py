"""Named stages and scopes of a decode step, for torch.profiler.

``stage(name)`` marks a part of the step (the scorer, the top-k, K1, the
segment merge, the matmuls, the appends, the flush) as a profiler range
"stage:<name>" while ``recording()`` is active, and is a no-op otherwise:
the decode path pays nothing for the marks unless a profile asks for them.
A profile then attributes each kernel launch on the host to the stage whose
range holds it (``chip_smoke.py``). Inside a replayed CUDA graph no host
code runs, so the marks see only eager and captured steps.

``scope(name)`` / ``scoped(name)`` are the counterpart of the JAX package's
``jax.named_scope`` marks: the retrieval functions (``core/pq.py``, the
kernel wrappers of ``ops/``) run inside a range "scope:<name>" (pq_score,
pq_select, pq_fetch, pq_append, pq_kmeans) while recording, and
``harness/trace.py`` sorts each kernel into pq / fetch / transfer / model by
the scopes around its launch. The two prefixes stay apart: a scope nests
inside a stage (and in other scopes) without taking the stage's place.
Neither reads anything on the device, so both are safe inside a capture;
when recording is off each costs one flag check.
"""

from __future__ import annotations

import contextlib
import functools

import torch

PREFIX = "stage:"
SCOPE_PREFIX = "scope:"
_on = False


def stage(name: str):
    """A profiler range named PREFIX + name while recording, else nothing."""
    if not _on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(PREFIX + name)


def scope(name: str):
    """A profiler range named SCOPE_PREFIX + name while recording, else
    nothing."""
    if not _on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SCOPE_PREFIX + name)


def scoped(name: str):
    """Decorator: every call of the function runs inside ``scope(name)``
    (the counterpart of ``@jax.named_scope(name)``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(SCOPE_PREFIX + name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def recording():
    """Mark stages and scopes while the block runs."""
    global _on
    prev, _on = _on, True
    try:
        yield
    finally:
        _on = prev
