"""The least time one block's work could take on the card.

Frozen here so that it reads the same work whatever implements it: the
bytes one N-frame block must move at the deployment's geometry (each
partition's ring and coefficient plane at its storage tier, read once, and
the block's input and output) and its operations, over the published peaks
of one NVIDIA H100 SXM (3.35 TB/s; 67 TFLOP/s float32 and 34 TFLOP/s
float64 outside the tensor cores). ``Uniform`` is the one-stage geometry of
P partitions of N, counted as ``NuSpec.traffic_bytes_per_block`` counts a
stage; ``bound`` is the smoke test's ``_bound``, copied, with the float64
peak beside it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float64": 8, "float32": 4}


def bound(nbytes: float, flops: float, dtype: str = "float32"):
    """(ms, "bytes" | "operations"): the least time to move ``nbytes``
    (each input read once, each output written once) and do ``flops``
    operations of ``dtype`` at the peaks."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FLOPS_PER_S[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def geometry(cfg: dict) -> "Uniform":
    """The geometry of a configuration (its ``geometry`` entry gives the
    storage tiers)."""
    return Uniform(int(cfg["taps"]), int(cfg["engine"]["block_length"]),
                   int(cfg["channels"]), **cfg["geometry"])


@dataclass(frozen=True)
class Uniform:
    """``taps`` in P = taps / N partitions of N (the one-stage engine):
    each block reads every ring and coefficient plane (re, im; N lanes a
    plane, lane 0 holding DC and Nyquist) of every channel once."""

    taps: int
    n: int
    channels: int
    store: str = "float64"
    in_store: str = "float32"

    @property
    def partitions(self) -> int:
        return -(-self.taps // self.n)

    def mac_bytes(self) -> int:
        return (2 * self.partitions * 2 * self.n * ITEMSIZE[self.store]
                * self.channels)

    def io_bytes(self) -> int:
        """The block's input (``in_store``) and output (``store``)."""
        return self.channels * self.n * (ITEMSIZE[self.in_store]
                                         + ITEMSIZE[self.store])

    def flops(self) -> float:
        """A complex multiply-add (8) a lane a partition, and a real FFT of
        2N points (5 N log2 2N) each way, a channel."""
        fft = 5 * self.n * math.log2(2 * self.n)
        return (8 * self.n * self.partitions + 2 * fft) * self.channels

    def least_ms(self):
        """(ms, what bounds it) for one block."""
        return bound(self.mac_bytes() + self.io_bytes(), self.flops(),
                     self.store)
