"""Kaiser window + windowed-sinc FIR design.

Counterpart of ``bfir_tpu/ops/firwindow.py`` (reference ``firwindow.c``),
with ``torch.special.i0`` for the Bessel function. Like the reference
port, the window is applied once in every branch (``firwindow.c:129-130``
applies it twice on the fractional-offset branch, treated as a bug there).
"""

from __future__ import annotations

import numpy as np
import torch


def kaiser_window(x, beta: float, dtype=torch.float64) -> torch.Tensor:
    """w(x) = I0(beta * sqrt(1 - x^2)) / I0(beta) at positions x in [-1, 1]
    (firwindow.c:54-87)."""
    x = torch.clamp(torch.as_tensor(x, dtype=dtype), -1.0, 1.0)
    return (torch.special.i0(beta * torch.sqrt(1.0 - x * x))
            / torch.special.i0(torch.tensor(beta, dtype=dtype)))


def window_positions(length: int, offset: float = 0.0) -> np.ndarray:
    """Normalized window positions for a length-N window, in the
    reference's three cases (firwindow.c:102-209): odd N centred at N//2,
    even N centred between the middle samples, and a fractional offset
    with asymmetric rise and fall."""
    n = np.arange(length, dtype=np.float64)
    if offset != 0.0:
        center = length // 2 + offset
        max_i = int(np.floor(center))
        frac = center - max_i
        rise = max_i + frac
        fall = (length - max_i - 1) - frac
        x = np.where(n <= max_i, (n - center) / rise, (n - center) / fall)
    elif length % 2 == 1:
        half = length // 2
        x = (n - half) / half
    else:
        half = length // 2
        x = (n - (half - 0.5)) / (half - 0.5)
    return np.clip(x, -1.0, 1.0)


def apply_kaiser(target, beta: float, offset: float = 0.0) -> torch.Tensor:
    """Apply a Kaiser window over an impulse (firwindow_kaiser)."""
    target = torch.as_tensor(target)
    x = torch.as_tensor(window_positions(target.shape[-1], offset),
                        dtype=target.dtype)
    return target * kaiser_window(x, beta, dtype=target.dtype)


def sinc_impulse(length: int, cutoff: float, offset: float = 0.0,
                 dtype=np.float64) -> np.ndarray:
    """Ideal lowpass impulse, normalized cutoff in (0, 0.5], centred at
    length//2 + offset, unit DC gain."""
    n = np.arange(length, dtype=np.float64) - (length // 2 + offset)
    return (2.0 * cutoff * np.sinc(2.0 * cutoff * n)).astype(dtype)


def kaiser_beta_for_attenuation(atten_db: float) -> float:
    """Standard Kaiser beta for a target stopband attenuation."""
    a = atten_db
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def design_lowpass(length: int, cutoff: float, beta: float = 9.0,
                   offset: float = 0.0, dtype=np.float64) -> np.ndarray:
    """Kaiser-windowed sinc lowpass FIR (design time, host numpy)."""
    h = sinc_impulse(length, cutoff, offset, dtype=np.float64)
    x = window_positions(length, offset)
    w = np.i0(beta * np.sqrt(1.0 - x * x)) / np.i0(beta)
    return (h * w).astype(dtype)
