"""Host spans at the port's layer boundaries: a registry of named rings.

`span(name)` times a block of host code:

    with span("train_step.forward"):
        ...

It reads the monotonic clock at enter and at exit and writes the
duration and the start time into the name's ring, which keeps the
`RING` newest occurrences in two preallocated int64 arrays, and counts
every occurrence.  A span never synchronises a device and keeps nothing
once it closes but the ring's slots.  It is always on: the profiler
slows a step's host side, so host times per layer come from unprofiled
steps, and a span costs about a microsecond.

While a torch profiler records (torch's process-wide flag, read only
when torch is already imported: this module imports no torch, so the
data loader, which uses it, stays torch-free), a span also opens
`torch.profiler.record_function(name)`, so the profiler's trace names
the span's host interval.  The profiler does not capture a
`record_function` opened on a plain Python thread; the ring holds such
spans all the same.

Start times are on the profiler's Chrome-trace clock: an event's `ts`
(us) plus the trace's `baseTimeNanoseconds` is CLOCK_REALTIME in ns.
The monotonic clock is mapped onto it by one pair of readings taken at
import, so a span the profiler did not capture (another thread's, or one
outside the traced steps) can still be placed on the device timeline.

`snapshot()` returns {name: {"count", "ms", "start_ns"}}, each list
oldest first; `reset()` empties the registry (tests).

The port's spans:

  train_step              training/train_step.py, the step's body
    train_step.forward    entry through the chain head's frame pick
    chain.den             chain/objective.py, the den's forward-backward
    chain.numerator       chain/objective.py, the numerator's
    train_step.backward   xent term, backward, grads, unscale, all-reduce,
                          finiteness, loss-scale update
    train_step.read       the wait for the previous step's skip (its
                          non-blocking copy); this step's own read only
                          with NG sites or on a re-seed of the step count
    ng.fisher_update      update_ng_states, on the steps that fold in
    ng.precondition       apply_natural_gradient
    train_step.update     gradient norm, BatchNorm select, SGD, the
                          parameter copy, the orthonormal constraint
  trainer.place_batch     training/trainer.py, a batch's upload
  loader.batch            io/dataloader.py, one batch's parse, shuffle,
                          bucketing and assembly (the producer's thread)
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from array import array
from typing import Dict

RING = 4096

_mono = time.perf_counter_ns
_before = _mono()
_REAL_OFFSET_NS = time.time_ns() - (_before + _mono()) // 2

_RINGS: Dict[str, "_Ring"] = {}
_RINGS_LOCK = threading.Lock()
_profiler = None        # torch.autograd.profiler, once torch is imported


class _Ring:
    """The newest RING durations and start times of one span name.  Each
    occurrence takes its slot from an itertools counter, whose `next` no
    other thread can interleave, so threads that record one name never
    share a slot and the count loses no occurrence."""

    __slots__ = ("name", "next", "ns", "start_ns")

    def __init__(self, name: str):
        self.name = name
        self.next = itertools.count()
        self.ns = array("q", bytes(8 * RING))
        self.start_ns = array("q", bytes(8 * RING))

    def read(self) -> dict:
        count = int(repr(self.next)[len("count("):-1])   # not consumed
        n = min(count, RING)
        order = [(count - n + k) % RING for k in range(n)]
        return {"count": count,
                "ms": [self.ns[i] / 1e6 for i in order],
                "start_ns": [self.start_ns[i] for i in order]}


def _ring(name: str) -> _Ring:
    ring = _RINGS.get(name)
    if ring is None:
        with _RINGS_LOCK:
            ring = _RINGS.setdefault(name, _Ring(name))
    return ring


def _find_profiler():
    global _profiler
    torch = sys.modules.get("torch")
    if torch is not None:
        _profiler = torch.autograd.profiler
    return _profiler


class span:
    """One occurrence of the span `name`, as a context manager; `ns`
    holds its duration once it has closed."""

    __slots__ = ("ns", "_ring", "_t0", "_rf")

    def __init__(self, name: str):
        self._ring = _RINGS.get(name) or _ring(name)
        self._rf = None

    def __enter__(self) -> "span":
        prof = _profiler or _find_profiler()
        if prof is not None and prof._is_profiler_enabled:
            self._rf = prof.record_function(self._ring.name)
            self._rf.__enter__()
        self._t0 = _mono()
        return self

    def __exit__(self, *exc) -> None:
        t0 = self._t0
        self.ns = dt = _mono() - t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        ring = self._ring
        i = next(ring.next) % RING
        ring.ns[i] = dt
        ring.start_ns[i] = t0 + _REAL_OFFSET_NS


def snapshot() -> Dict[str, dict]:
    """{name: {"count": occurrences ever, "ms": [durations], "start_ns":
    [CLOCK_REALTIME ns]}} of the kept occurrences, oldest first.  A span
    closing on another thread meanwhile may show its slot's old values."""
    with _RINGS_LOCK:
        rings = list(_RINGS.items())
    return {name: ring.read() for name, ring in rings}


def reset() -> None:
    """Forget every span (tests)."""
    with _RINGS_LOCK:
        _RINGS.clear()
