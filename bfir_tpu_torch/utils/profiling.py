"""Latency observability: ``BlockTimer``, a per-block latency histogram
(p50/p95/p99) around the streaming step.

Counterpart of ``BlockTimer`` in ``bfir_tpu/utils/profiling.py``. Callers
time work that ends in a host copy of its output, so the host clock covers
the device time; a profiler trace is ``torch.profiler``'s job here.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


class BlockTimer:
    def __init__(self, capacity: int = 100_000):
        self._samples = []
        self._capacity = capacity

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
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
