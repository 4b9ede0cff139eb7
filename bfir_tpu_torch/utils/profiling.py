"""Latency observability.

Counterpart of ``bfir_tpu/utils/profiling.py``:

- ``BlockTimer``: per-block latency histogram (p50/p95/p99) around the
  streaming step; ``measure(result)`` waits for ``result``'s CUDA device
  before the clock stops, so device time is counted;
- ``trace``: context manager around ``torch.profiler`` that writes a
  Chrome trace under a directory (the reference's XLA trace);
- ``Tracer`` (no reference counterpart): spans and counters kept in
  memory, on a clock that maps onto ``torch.profiler``'s timeline, so that
  host time and device idle time can be put down to a layer. The program
  records into the thread's current tracer (``current()``), which a
  session installs for the length of a call (``Tracer.call``); it emits no
  profiler ranges of its own.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


def _cuda_devices(result):
    """The CUDA devices of the tensors in ``result`` (a tensor, or nested
    tuples, lists and dicts of them)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        return set().union(*map(_cuda_devices, result))
    return set()


class BlockTimer:
    def __init__(self, capacity: int = 100_000):
        self._samples = []
        self._capacity = capacity

    @contextlib.contextmanager
    def measure(self, result=None):
        """Time the body; when ``result`` holds CUDA tensors (the body fills
        them in place or the caller passes what it will read), wait for
        their devices before the clock stops. A CPU result needs nothing."""
        t0 = time.perf_counter()
        yield
        for dev in _cuda_devices(result):
            torch.cuda.synchronize(dev)
        self.add(time.perf_counter() - t0)

    def add(self, seconds: float) -> None:
        if len(self._samples) < self._capacity:
            self._samples.append(seconds)

    @property
    def count(self) -> int:
        return len(self._samples)

    def percentiles(self, qs=(50, 95, 99)):
        if not self._samples:
            return {q: float("nan") for q in qs}
        arr = np.asarray(self._samples)
        return {q: float(np.percentile(arr, q)) for q in qs}

    def summary(self) -> str:
        p = self.percentiles()
        return (f"{self.count} blocks: p50 {p[50]*1e3:.3f} ms, "
                f"p95 {p[95]*1e3:.3f} ms, p99 {p[99]*1e3:.3f} ms")

    def reset(self) -> None:
        self._samples = []


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the body (CPU activity, and CUDA activity
    where CUDA is available), written as a Chrome trace
    ``trace-<pid>-<ns>.json`` under ``log_dir`` (view it in Perfetto or
    chrome://tracing). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class Span(NamedTuple):
    """One recorded span. Times are ``time.perf_counter_ns()`` readings
    (``Tracer.to_unix_ns`` maps them onto the profiler's clock); ``parent``
    is the index of the enclosing span of the same call (-1: the call's
    root); ``call`` is the call's id, 1, 2, ... in the order of the calls."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int


_FIELDS = len(Span._fields)


class _Current(threading.local):
    tracer: Optional["Tracer"] = None


_CURRENT = _Current()


def current() -> Optional["Tracer"]:
    """The tracer the current thread records into, or None (tracing off)."""
    return _CURRENT.tracer


class Tracer:
    """Spans and counters of a program's calls, kept in memory.

    Spans nest: ``begin(name)`` opens one inside the innermost open span,
    ``end()`` closes the innermost, and ``next(name)`` closes it and opens
    ``name`` in its place at one clock reading (phases that tile a step).
    At most ``capacity`` spans are kept; later ones are counted in
    ``dropped``. ``counters`` maps a name to an int (``count``).

    The clock is ``time.perf_counter_ns()``; one anchor pair (perf counter,
    Unix time), read when the tracer is made, maps a span's times to Unix
    nanoseconds (``to_unix_ns``), the base ``torch.profiler`` (Kineto)
    gives its events. A span site costs the caller one ``None`` test while
    no tracer is installed.
    """

    def __init__(self, capacity: int = 1_000_000):
        self.capacity = capacity
        self.dropped = 0
        self.counters: Dict[str, int] = {}
        self.calls = 0
        self._rec: list = []  # _FIELDS entries a span, in Span's order
        self._limit = capacity * _FIELDS
        # the open spans' offsets in _rec, innermost last (-1: dropped)
        self._open: List[int] = []
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def to_unix_ns(self, t_ns: int) -> int:
        """A span time mapped to Unix nanoseconds."""
        return t_ns - self.anchor[0] + self.anchor[1]

    def _open_at(self, name: str, t: int) -> None:
        rec, opened = self._rec, self._open
        if len(rec) >= self._limit:
            self.dropped += 1
            opened.append(-1)
            return
        parent = opened[-1] // _FIELDS if opened and opened[-1] >= 0 else -1
        opened.append(len(rec))
        rec += (name, t, t, parent, self.calls)

    def _close_at(self, t: int) -> None:
        i = self._open.pop()
        if i >= 0:
            self._rec[i + 2] = t

    def begin(self, name: str) -> None:
        self._open_at(name, time.perf_counter_ns())

    def end(self) -> None:
        self._close_at(time.perf_counter_ns())

    def next(self, name: str) -> None:
        t = time.perf_counter_ns()
        self._close_at(t)
        self._open_at(name, t)

    def count(self, name: str, k: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + k

    @contextlib.contextmanager
    def call(self, name: str):
        """One call into the program: a new call id, the root span ``name``
        around the body, and this tracer as the thread's current tracer for
        the body. Spans the body leaves open (it raised) end with the
        root."""
        self.calls += 1
        depth = len(self._open)
        prev = _CURRENT.tracer
        _CURRENT.tracer = self
        self.begin(name)
        try:
            yield self
        finally:
            _CURRENT.tracer = prev
            t = time.perf_counter_ns()
            while len(self._open) > depth:
                self._close_at(t)

    @property
    def spans(self) -> List[Span]:
        """The recorded spans in the order they began."""
        r = self._rec
        return [Span(*r[i:i + _FIELDS]) for i in range(0, len(r), _FIELDS)]


@contextlib.contextmanager
def untraced():
    """The body runs with no current tracer (work inside a call that is no
    part of its trace, such as a build's self-check)."""
    prev = _CURRENT.tracer
    _CURRENT.tracer = None
    try:
        yield
    finally:
        _CURRENT.tracer = prev
