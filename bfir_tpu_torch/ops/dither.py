"""TPDF dither, error-feedback requantization and overflow accounting.

Counterpart of ``bfir_tpu/ops/dither.py`` (reference ``dither.{cpp,hpp}``):

- the dither value of each sample is ``0.5 + (diff + 1)/255`` over the
  difference of consecutive random bytes in [-128, 128), the last byte of a
  block carried into the next (the closed form of the reference's
  ``randmap``, dither.cpp:77-103): triangular and first-difference
  high-passed;
- error feedback ``x' = x + e0 - e1``, ``e1 <- e0``, ``e0 <- x' - q``
  (dither.cpp:154-156, 209);
- the quantizer ``q = floor(d)`` for ``d >= 0`` and ``ceil(d) - 1`` below
  zero (dither.cpp:163-207), then clip to [imin, imax] with per-channel
  overflow accounting;
- mid-tread without dither: add 0.5, then the same truncation
  (dither.cpp:214-274).

The random bytes come from a ``torch.Generator`` seeded from ``seed`` on the
state's device, where the reference draws them from JAX's threefry: the two
agree in their statistics only. ``quantize_hp_tpdf`` is split in two so the
quantizer is a pure function of given dither values: ``dither_values``
draws them, ``quantize_hp_tpdf_values`` runs the per-sample recurrence
(kernel K9 on CUDA tensors, its plain loop on CPU tensors).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class DitherState(NamedTuple):
    """Per-channel dither state (reference ``dither_state_t``)."""

    e0: torch.Tensor  # previous quantization error [C]
    e1: torch.Tensor  # the error before that [C]
    prev_byte: torch.Tensor  # int32 [C]: last random byte of the last block
    generator: torch.Generator  # advanced in place by every draw


class OverflowStats(NamedTuple):
    """Per-channel clip accounting (reference ``bfoverflow_t``, reported by
    brutefir::print_overflows, brutefir.cpp:585-629)."""

    n_overflows: torch.Tensor  # int32 [C]
    largest: torch.Tensor  # float [C]: largest clipped (or float) magnitude
    intlargest: torch.Tensor  # int32 [C]: largest emitted |integer|


def init_dither_state(n_channels: int, seed: int = 1, dtype=torch.float32, *,
                      device) -> DitherState:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    prev = torch.randint(-128, 128, (n_channels,), generator=gen, device=dev,
                         dtype=torch.int32)
    return DitherState(
        e0=torch.zeros((n_channels,), dtype=dtype, device=dev),
        e1=torch.zeros((n_channels,), dtype=dtype, device=dev),
        prev_byte=prev,
        generator=gen,
    )


def init_overflow_stats(n_channels: int, dtype=torch.float32, *,
                        device) -> OverflowStats:
    return OverflowStats(
        n_overflows=torch.zeros((n_channels,), dtype=torch.int32, device=device),
        largest=torch.zeros((n_channels,), dtype=dtype, device=device),
        intlargest=torch.zeros((n_channels,), dtype=torch.int32, device=device),
    )


def _trunc_quantize(d: torch.Tensor) -> torch.Tensor:
    """q = floor(d), and ceil(d) - 1 where d < 0 (dither.cpp:163-207)."""
    return torch.where(d < 0, torch.ceil(d) - 1.0, torch.floor(d))


def _clip_account(d: torch.Tensor, imin: torch.Tensor, imax: torch.Tensor,
                  of: OverflowStats):
    """Quantize and clip ``d`` [C] to [imin, imax] with the reference's
    accounting: clipped samples bump ``n_overflows`` and track the largest
    clipped |d|; the others track the largest emitted |q|."""
    q = _trunc_quantize(d)
    clip_lo = d <= imin
    clip_hi = d > imax
    clipped = clip_lo | clip_hi
    q = torch.where(clip_lo, imin, torch.where(clip_hi, imax, q))
    n_of = of.n_overflows + clipped.to(torch.int32)
    largest = torch.where(clipped, torch.maximum(of.largest, d.abs()),
                          of.largest)
    intlargest = torch.where(clipped, of.intlargest,
                             torch.maximum(of.intlargest,
                                           q.abs().to(torch.int32)))
    return q, OverflowStats(n_of, largest.to(of.largest.dtype), intlargest)


def dither_values(state: DitherState, n: int, dtype
                  ) -> Tuple[torch.Tensor, DitherState]:
    """Draw the next ``n`` dither values per channel -> (dv [C, n] of
    ``dtype``, state with the new ``prev_byte``); the generator advances in
    place. The closed form of ops/dither.py:122-126."""
    c = state.prev_byte.shape[0]
    dev = state.prev_byte.device
    if n == 0:
        return torch.zeros((c, 0), dtype=dtype, device=dev), state
    b = torch.randint(-128, 128, (c, n), generator=state.generator,
                      device=dev, dtype=torch.int32)
    diff = torch.diff(torch.cat([state.prev_byte[:, None], b], dim=1), dim=1)
    dv = 0.5 + (diff.to(dtype) + 1.0) / 255.0
    return dv, state._replace(prev_byte=b[:, -1].contiguous())


def quantize_hp_tpdf_values(x: torch.Tensor, dv: torch.Tensor, imin: float,
                            imax: float, state: DitherState, of: OverflowStats
                            ) -> Tuple[torch.Tensor, DitherState,
                                       OverflowStats]:
    """Requantize ``x`` [C, T] (integer full-scale units) with the given
    dither values ``dv`` [C, T] and the {1, -1} error feedback. Returns
    (int32 samples [C, T], state with new e0/e1, new overflow stats). Runs
    kernel K9 on CUDA tensors and its plain loop on CPU tensors."""
    from bfir_tpu_torch.kernels.dither_kernel import quantize_hp_tpdf

    q, e0, e1, nof, lg, ilg = quantize_hp_tpdf(
        x, dv, state.e0, state.e1, float(imin), float(imax), of.n_overflows,
        of.largest, of.intlargest)
    return q, state._replace(e0=e0, e1=e1), OverflowStats(nof, lg, ilg)


def quantize_hp_tpdf(x: torch.Tensor, imin: float, imax: float,
                     state: DitherState, of: OverflowStats
                     ) -> Tuple[torch.Tensor, DitherState, OverflowStats]:
    """Requantize ``x`` [C, T] with high-passed TPDF dither and {1, -1}
    error feedback: ``dither_values``, then ``quantize_hp_tpdf_values``."""
    dv, state = dither_values(state, x.shape[1], x.dtype)
    return quantize_hp_tpdf_values(x, dv, imin, imax, state, of)


def quantize_no_dither(x: torch.Tensor, imin: float, imax: float,
                       of: OverflowStats
                       ) -> Tuple[torch.Tensor, OverflowStats]:
    """Mid-tread requantization without dither (dither.cpp:214-274): add
    0.5, truncate (with the negative-integer quirk), clip, account. No
    sequential state."""
    lo = x.new_tensor(imin)
    hi = x.new_tensor(imax)
    d = x + x.new_tensor(0.5)
    q = _trunc_quantize(d)
    clip_lo = d <= lo
    clip_hi = d > hi
    clipped = clip_lo | clip_hi
    q = torch.where(clip_lo, lo, torch.where(clip_hi, hi, q))
    n_of = of.n_overflows + clipped.sum(dim=1, dtype=torch.int32)
    if x.shape[1] == 0:
        return q.to(torch.int32), OverflowStats(n_of, of.largest,
                                                of.intlargest)
    mag = torch.where(clipped, d.abs(), torch.zeros_like(d))
    largest = torch.maximum(of.largest, mag.amax(dim=1).to(of.largest.dtype))
    largest = torch.where(clipped.any(dim=1), largest, of.largest)
    intmag = torch.where(clipped, torch.zeros_like(q), q.abs()).to(torch.int32)
    intlargest = torch.maximum(of.intlargest, intmag.amax(dim=1))
    return q.to(torch.int32), OverflowStats(n_of, largest, intlargest)
