"""The least time one block's work could take on the card, two stages.

Frozen here, beside ``roofline``, so that it reads the same work whatever
implements it. ``TwoStage`` is the geometry of a head of ``p_head``
partitions of N, which runs every block, and a tail of ``p_tail``
partitions of M = ratio x N, which runs once every ``ratio`` blocks and
starts where the head ends (``p_head`` = 2 x ratio: the least head that
leaves the tail a block of slack). Bytes are counted as
``NuSpec.traffic_bytes_per_block`` counts them: each stage's ring and
coefficient planes (re, im; N or M lanes a plane) at the stage's storage
tier, read once, the tail's over ``ratio`` blocks, and the block's input
and output. Operations: a complex multiply-add (8) a lane a partition,
and a real FFT of 2N points (5 N log2 2N, as ``roofline.Uniform``) each
way, with the tail's 2M-point pair over ``ratio`` blocks. Both go over
``roofline.bound``'s H100 peaks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from portbench.roofline import ITEMSIZE, bound

STORE_BYTES = {**ITEMSIZE, "int24": 3, "int16": 2, "bfloat16": 2}


def geometry(cfg: dict) -> "TwoStage":
    """The two-stage geometry of a configuration (its ``stages`` entry
    gives the ratio and the tiers)."""
    st = cfg["stages"]
    return TwoStage(int(cfg["taps"]), int(cfg["engine"]["block_length"]),
                    int(cfg["channels"]), int(st["ratio"]),
                    st["head_store"], st["tail_store"],
                    cfg["geometry"]["in_store"], cfg["engine"]["dtype"])


@dataclass(frozen=True)
class TwoStage:
    taps: int
    n: int
    channels: int
    ratio: int
    head_store: str
    tail_store: str
    in_store: str = "float32"
    dtype: str = "float32"  # the output's, and the arithmetic's

    @property
    def m(self) -> int:
        return self.ratio * self.n

    @property
    def p_head(self) -> int:
        return 2 * self.ratio

    @property
    def p_tail(self) -> int:
        rest = max(0, self.taps - self.p_head * self.n)
        return max(1, -(-rest // self.m))

    def mac_bytes(self) -> float:
        head = 2 * self.p_head * 2 * self.n * STORE_BYTES[self.head_store]
        tail = (2 * self.p_tail * 2 * self.m * STORE_BYTES[self.tail_store]
                / self.ratio)
        return (head + tail) * self.channels

    def io_bytes(self) -> int:
        """The block's input (``in_store``) and output (``dtype``)."""
        return self.channels * self.n * (ITEMSIZE[self.in_store]
                                         + ITEMSIZE[self.dtype])

    def flops(self) -> float:
        head = 8 * self.n * self.p_head + 2 * 5 * self.n * math.log2(
            2 * self.n)
        tail = 8 * self.m * self.p_tail + 2 * 5 * self.m * math.log2(
            2 * self.m)
        return (head + tail / self.ratio) * self.channels

    def least_ms(self):
        """(ms, what bounds it) for one block."""
        return bound(self.mac_bytes() + self.io_bytes(), self.flops(),
                     self.dtype)
