"""What the drivers share: the window's record, the sample kept for the
check, and the statistics the readers take from them."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Window:
    """One measured window. It opens at ``t0`` (the first timed call) and
    closes when the last call issued before ``t0 + seconds`` returns
    (``t_end``), so a rate over it takes all the work and all the time."""

    t0: float
    t_end: float = 0.0
    calls: int = 0
    frames: int = 0  # output frames returned by the window's calls
    failed: int = 0  # calls that returned another count of frames
    # open loops: per block, its stream index, its latency from the time it
    # was due, how late the generator issued it, and the call's own time
    block_index: List[int] = field(default_factory=list)
    latency_s: List[float] = field(default_factory=list)
    issue_late_s: List[float] = field(default_factory=list)
    service_s: List[float] = field(default_factory=list)
    ends: List[float] = field(default_factory=list)  # each call's return

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0

    def record(self, given: int, returned: int) -> None:
        self.t_end = time.perf_counter()
        self.ends.append(self.t_end)
        self.calls += 1
        self.frames += returned
        self.failed += given != returned


class Reservoir:
    """``k`` of the items offered, each equally likely (Algorithm R), drawn
    from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def log_calls(w: Window, what: str) -> None:
    """The spread of the window's calls on standard error."""
    took = np.diff([w.t0, *w.ends]) * 1e3
    parts = np.array_split(took, min(10, len(took)))
    print(f"{what}: {w.calls} calls, ms each p10 "
          f"{percentile(took, 10):.3f}, p50 {percentile(took, 50):.3f}, "
          f"p90 {percentile(took, 90):.3f}, max {took.max():.3f}; mean of "
          "each tenth of the window "
          + " ".join(f"{p.mean():.2f}" for p in parts), file=sys.stderr)


def late_pct(w: Window, period_s: float) -> Optional[float]:
    """The share (%) of the window's blocks that came back late: whose
    latency exceeds one block period ``period_s`` (N / fs), so their
    output missed its deadline. None where the window recorded no
    per-block latencies (a closed loop)."""
    lat = np.asarray(w.latency_s)
    if not lat.size:
        return None
    return 100.0 * float(np.mean(lat > period_s))


def spin_until(t: float) -> None:
    """Busy-wait on the host clock until ``t`` (``time.perf_counter``)."""
    while time.perf_counter() < t:
        pass


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
