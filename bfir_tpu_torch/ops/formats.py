"""Output-format accounting for float outputs.

Counterpart of ``count_float_overflow`` in ``bfir_tpu/ops/formats.py``; the
integer output stage is not ported yet.
"""

from __future__ import annotations

import torch

from bfir_tpu_torch.ops.dither import OverflowStats


def count_float_overflow(x: torch.Tensor, of: OverflowStats,
                         fmax: float = 1.0) -> OverflowStats:
    """Count |x| > fmax per channel and track the peak; never clip
    (REAL_OVERFLOW_UPDATE, real2raw.cpp:17-32). x: [C, T]."""
    mag = x.abs()
    n_of = of.n_overflows + (mag > fmax).sum(dim=1, dtype=torch.int32)
    largest = torch.maximum(of.largest, mag.amax(dim=1).to(of.largest.dtype))
    return OverflowStats(n_of, largest, of.intlargest)
