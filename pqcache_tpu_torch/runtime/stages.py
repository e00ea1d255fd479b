"""Profiler marks of a decode step, and always-on spans and counters.

Two tiers. The first is profiler-only: ``stage`` and ``scope`` ranges,
live only while ``recording()`` is active. The second is always on:
``span`` and ``count`` records, held in memory and device-timed.

``stage(name)`` marks a part of the step (the scorer, the top-k, K1, the
segment merge, the matmuls, the appends) as a profiler range
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

``span(name, **ids)`` marks a coarse piece of work at a layer boundary
outside the captured step (a prefill, a layer's k-means tail, a slot
insert, a decode chunk and its replays, the ring flush, a capture, the
kernel build), and ``count(name, n)`` adds to a counter. Both are always
on; they sit at points crossed a few dozen times a chunk, never inside a
step. A span's record holds its name, its own id, the id of the span that
encloses it on this thread, its ids, and host start and end
(``time.perf_counter_ns``). Where CUDA is initialized and the current
stream is not capturing, it also records a pooled timing event on the
current stream at enter and at exit, and the record gets device start and
end on the same host-ns clock (``_Clock``): each event's time after a
first anchor, an event recorded at a ``synchronize`` when the registry
first touches the device (its only wait outside ``snapshot``) and mapped
to the host time read at that moment; ``snapshot`` takes a fresh anchor
and fits the rate between the card's timer and the host's clock, which
part by a few µs a second. Event times are read from a base that moves,
once a second of device time has passed, to the end of a span that closed
with no span open (``REBASE_NS``): CUDA's float milliseconds then keep
sub-µs steps, where a fixed base would step by 16 µs after four minutes
and by 0.25 ms after an hour. A
span never waits for the card: its events are resolved with ``query()``
when a later span opens outside a capture, and all of them in
``snapshot()``, which waits and which only readers call. A span entered
while a stream captures is host-only; so is every span on the CPU. While
``recording()`` is active a span also opens the profiler range
"stage:<name>", so it lies on the profiler's timeline beside the kernels.

The registry is per process (the newest ``RING`` records, and per-name
totals of count, host and device seconds that are never dropped), the
parent links per thread. ``clear()`` empties it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time

import torch

PREFIX = "stage:"
SCOPE_PREFIX = "scope:"
RING = 4096
REBASE_NS = 1_000_000_000   # device time after which a clock's base moves
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


# -- the always-on tier -----------------------------------------------------


def _timed_here() -> bool:
    """Whether a span may record events now: CUDA in use and no capture on
    the current stream."""
    return (torch.cuda.is_initialized()
            and not torch.cuda.is_current_stream_capturing())


def _anchor(dev: int):
    """(event, host ns, error ns): the card synchronized, then an event
    recorded and waited for, five times; of the tightest wait, its event,
    its middle and half its length."""
    torch.cuda.synchronize(dev)
    best = None
    for _ in range(5):
        ev = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter_ns()
        ev.record()
        ev.synchronize()
        h1 = time.perf_counter_ns()
        if best is None or h1 - h0 < best[2] - best[1]:
            best = (ev, h0, h1)
    ev, h0, h1 = best
    return ev, (h0 + h1) // 2, (h1 - h0) // 2


class _Clock:
    """One device's map from its event times to the host's ns clock.

    An event's device time ("raw": device ns after the first anchor) is
    its elapsed time after the base event plus the base's own. The host
    time is host0 + raw × rate: the card's timer and the host's clock part
    by a few µs a second, so ``fit`` (at each snapshot, which may wait)
    takes a fresh anchor and sets the rate from the first one."""

    def __init__(self, dev: int):
        self.base, self.host0, self.err = _anchor(dev)
        self.base_raw = 0
        self.rate = 1.0

    def raw(self, ev) -> int:
        return self.base_raw + round(self.base.elapsed_time(ev) * 1e6)

    def host(self, raw: int) -> int:
        return self.host0 + round(raw * self.rate)

    def fit(self, dev: int) -> None:
        ev, host, err = _anchor(dev)
        raw = self.raw(ev)
        if raw >= REBASE_NS:
            self.rate = (host - self.host0) / raw
            self.err = max(self.err, err)


class _Registry:
    """The process's records, totals, counters, pending events and clocks."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.records = collections.deque(maxlen=RING)
        self.totals = {}        # name -> [count, host ns, device ns]
        self.counters = collections.Counter()
        self.pending = collections.deque()   # spans whose events are out
        self.pool = collections.defaultdict(list)    # device -> free events
        self.clocks = {}        # device -> _Clock
        self.dropped = 0

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def event(self, dev: int):
        free = self.pool[dev]
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def clock(self, dev: int) -> _Clock:
        """The device's clock, made at the first span that touches it."""
        c = self.clocks.get(dev)
        if c is None:
            c = self.clocks[dev] = _Clock(dev)
        return c

    def add(self, sp: "Span") -> None:
        with self.lock:
            if len(self.records) == RING:
                self.dropped += 1
            self.records.append(sp)
            tot = self.totals.setdefault(sp.name, [0, 0, 0])
            tot[0] += 1
            tot[1] += sp.host_end - sp.host_start
            if sp._ev is not None:
                self.pending.append(sp)

    def resolve(self, wait: bool = False) -> None:
        """Fill the device times of finished spans, oldest first; stop at
        the first unfinished one unless ``wait``."""
        with self.lock:
            while self.pending:
                sp = self.pending[0]
                start, end = sp._ev
                if wait:
                    end.synchronize()
                    start.synchronize()
                elif not (end.query() and start.query()):
                    return
                self.pending.popleft()
                clk = self.clocks[sp._dev]
                r0 = clk.raw(start)
                r1 = r0 + round(start.elapsed_time(end) * 1e6)
                sp._raw = (r0, r1)
                sp.dev_start, sp.dev_end = clk.host(r0), clk.host(r1)
                self.totals[sp.name][2] += r1 - r0
                free = [start, end]
                if sp._root and r1 - clk.base_raw >= REBASE_NS:
                    # no span was open on the thread when this one closed,
                    # so its end precedes every later span's events: the
                    # base moves there, where float ms keep sub-µs steps
                    free[1] = clk.base
                    clk.base, clk.base_raw = end, r1
                self.pool[sp._dev] += free
                sp._ev = None

    def fit(self) -> None:
        """Refit every clock and map the records' device times again."""
        with self.lock:
            for dev, clk in self.clocks.items():
                clk.fit(dev)
            for sp in self.records:
                if sp._raw is not None:
                    clk = self.clocks[sp._dev]
                    sp.dev_start, sp.dev_end = map(clk.host, sp._raw)


_REG = _Registry()


class Span:
    """One span: a context manager and, once closed, its record. Made by
    ``span``; ``host_s`` and ``device_s`` read its durations."""

    __slots__ = ("name", "ids", "id", "parent", "host_start", "host_end",
                 "dev_start", "dev_end", "_dev", "_ev", "_raw", "_rf",
                 "_host_only", "_root")

    def __init__(self, name: str, ids: dict, host_only: bool):
        self.name, self.ids, self._host_only = name, ids, host_only
        self.id = self.parent = None
        self.host_start = self.host_end = None
        self.dev_start = self.dev_end = None
        self._dev = self._ev = self._raw = self._rf = None
        self._root = False

    def __enter__(self) -> "Span":
        st = _REG.stack()
        self.parent = st[-1].id if st else None
        self.id = next(_REG.ids)
        st.append(self)
        if _on:
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        if not self._host_only and _timed_here():
            _REG.resolve()
            self._dev = torch.cuda.current_device()
            _REG.clock(self._dev)
            self.host_start = time.perf_counter_ns()
            ev = _REG.event(self._dev)
            ev.record()
            self._ev = (ev, None)
        else:
            self.host_start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._ev is not None:
            if torch.cuda.is_current_stream_capturing():
                self._ev = None     # a capture began inside: host-only
            else:
                end = _REG.event(self._dev)
                end.record()
                self._ev = (self._ev[0], end)
        self.host_end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        st = _REG.stack()
        if st and st[-1] is self:
            st.pop()
        self._root = not st
        _REG.add(self)

    @property
    def host_s(self) -> float:
        return (self.host_end - self.host_start) / 1e9

    @property
    def device_s(self):
        """Device seconds, None until resolved or for a host-only span."""
        if self.dev_start is None:
            return None
        return (self.dev_end - self.dev_start) / 1e9

    def as_dict(self) -> dict:
        return dict(id=self.id, parent=self.parent, name=self.name,
                    ids=dict(self.ids), host_start_ns=self.host_start,
                    host_end_ns=self.host_end, dev_start_ns=self.dev_start,
                    dev_end_ns=self.dev_end)


def span(name: str, *, host_only: bool = False, **ids) -> Span:
    """An always-on span named ``name`` with ``ids`` (slot, layer, chunk,
    steps, tokens, ...): ``with span("flush"): ...``. ``host_only`` spans
    record no device events (host work such as a build)."""
    return Span(name, ids, host_only)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter ``name``."""
    with _REG.lock:
        _REG.counters[name] += n


def snapshot() -> dict:
    """The registry, every device time resolved and the clocks refit (this
    waits for the card): ``records`` (oldest first, as dicts; device times
    in host ns, None where host-only), ``totals`` per span name (count,
    host_s, device_s), ``counters``, ``dropped`` (records the ring let go)
    and ``clocks`` (each device's first anchor in host ns, the rate in host
    ns a device ns, and the anchors' error in ns)."""
    _REG.resolve(wait=True)
    _REG.fit()
    with _REG.lock:
        return dict(
            records=[sp.as_dict() for sp in _REG.records],
            totals={k: dict(count=c, host_s=h / 1e9, device_s=d / 1e9)
                    for k, (c, h, d) in _REG.totals.items()},
            counters=dict(_REG.counters), dropped=_REG.dropped,
            clocks={dev: dict(host_ns=c.host0, rate=c.rate, err_ns=c.err)
                    for dev, c in _REG.clocks.items()})


def clear() -> None:
    """Forget every record, total, counter and pending event (the clocks
    stay: their base is still valid)."""
    with _REG.lock:
        _REG.records.clear()
        _REG.totals.clear()
        _REG.counters.clear()
        _REG.pending.clear()
        _REG.dropped = 0
