"""Latency observability.

Counterpart of ``bfir_tpu/utils/profiling.py``:

- ``BlockTimer``: per-block latency histogram (p50/p95/p99) around the
  streaming step; ``measure(result)`` waits for ``result``'s CUDA device
  before the clock stops, so device time is counted;
- ``trace``: context manager around ``torch.profiler`` that writes a
  Chrome trace under a directory (the reference's XLA trace).
"""

from __future__ import annotations

import contextlib
import os
import time

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
