"""Per-channel overflow accounting.

Counterpart of the ``OverflowStats`` part of ``bfir_tpu/ops/dither.py``
(reference ``bfoverflow_t``, reported by brutefir::print_overflows,
brutefir.cpp:585-629). The dither quantizer is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OverflowStats(NamedTuple):
    n_overflows: torch.Tensor  # int32 [C]
    largest: torch.Tensor  # float [C] — largest magnitude seen
    intlargest: torch.Tensor  # int32 [C] — largest emitted |integer|


def init_overflow_stats(n_channels: int, dtype=torch.float32, *,
                        device) -> OverflowStats:
    return OverflowStats(
        n_overflows=torch.zeros((n_channels,), dtype=torch.int32, device=device),
        largest=torch.zeros((n_channels,), dtype=dtype, device=device),
        intlargest=torch.zeros((n_channels,), dtype=torch.int32, device=device),
    )
