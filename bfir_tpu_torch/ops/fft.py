"""Real FFTs in the split and halfcomplex plane layouts, on ``torch.fft``.

Counterpart of ``bfir_tpu/ops/fft.py``. The reference builds its transforms
from matmuls because its TPU backend had no FFT op; that machinery is plain
XLA, not a kernel, so here every transform is ``torch.fft`` and only the
layout contract is kept:

- numpy conventions: transforms over the last axis, the inverse carries the
  1/n scale;
- split planes: ``(re, im)``, each ``[..., n//2 + 1]``;
- halfcomplex planes: ``(hr, hi)``, each ``[..., n//2]``, with lane 0 of
  ``hi`` holding the Nyquist bin's real part (X[0] and X[n/2] are real for
  real input, so both fit in lane 0).

The reference's half-DFT tail basis (``_hc_tail_weights``) is kept for
the one kernel that multiplies by it, K12 (``step_hc_fused``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def rfft(x: torch.Tensor, n: Optional[int] = None, dim: int = -1) -> torch.Tensor:
    return torch.fft.rfft(x, n=n, dim=dim)


def irfft(y: torch.Tensor, n: Optional[int] = None, dim: int = -1) -> torch.Tensor:
    return torch.fft.irfft(y, n=n, dim=dim)


def rfft_split(x: torch.Tensor, n: Optional[int] = None):
    """rfft over the last axis -> (re, im), each [..., n//2 + 1]."""
    y = torch.fft.rfft(x, n=n or x.shape[-1], dim=-1)
    return y.real, y.imag


def irfft_split(yr: torch.Tensor, yi: torch.Tensor,
                n: Optional[int] = None) -> torch.Tensor:
    """Inverse rfft from split re/im planes -> real [..., n]."""
    m = n or 2 * (yr.shape[-1] - 1)
    return torch.fft.irfft(torch.complex(yr, yi), n=m, dim=-1)


def rfft_split_hc(x: torch.Tensor, n: Optional[int] = None):
    """rfft over the last axis -> halfcomplex planes [..., n//2]."""
    m = n or x.shape[-1]
    h = m // 2
    xr, xi = rfft_split(x, n=m)
    return xr[..., :h], torch.cat([xr[..., h:h + 1], xi[..., 1:h]], dim=-1)


def _hc_to_complex(hr: torch.Tensor, hi: torch.Tensor, h: int) -> torch.Tensor:
    """Halfcomplex planes (lane-padded allowed) -> complex [..., h + 1]."""
    hr = hr[..., :h]
    hi = hi[..., :h]
    zero = torch.zeros_like(hr[..., :1])
    yr = torch.cat([hr, hi[..., :1]], dim=-1)
    yi = torch.cat([zero, hi[..., 1:], zero], dim=-1)
    return torch.complex(yr, yi)


def irfft_split_hc(hr: torch.Tensor, hi: torch.Tensor,
                   n: Optional[int] = None) -> torch.Tensor:
    """Inverse rfft from halfcomplex planes -> real [..., n]. Accepts
    lane-padded planes (width >= n//2; extra lanes ignored)."""
    m = n or 2 * hr.shape[-1]
    return torch.fft.irfft(_hc_to_complex(hr, hi, m // 2), n=m, dim=-1)


def irfft_hc_tail(hr: torch.Tensor, hi: torch.Tensor,
                  n: Optional[int] = None) -> torch.Tensor:
    """``irfft_split_hc(hr, hi, n)[..., n//2:]``: the overlap-save tail, the
    only half of the inverse the engines keep. Lane-padded inputs
    accepted."""
    m = n or 2 * hr.shape[-1]
    return irfft_split_hc(hr, hi, m)[..., m // 2:]


@functools.lru_cache(maxsize=16)
def _hc_tail_weights(m: int, dtype: str):
    """Direct half-DFT basis, numpy [h, h] each (h = m/2), computed in
    float64 and cast once to ``dtype``: row k of (wr, wi) is the
    contribution of (hr[k], hi[k]) to the irfft(m) tail samples [h, m);
    lane 0 carries (DC, Nyquist):

      x[t] = (1/m) [ X0 + Xny (-1)^t
                     + 2 sum_{k=1}^{h-1} (hr_k cos(2pi k t/m)
                                          - hi_k sin(2pi k t/m)) ]
    """
    h = m // 2
    t = np.arange(h, m)[None, :]
    k = np.arange(h)[:, None]
    ang = 2.0 * np.pi * k * t / m
    wr = (2.0 / m) * np.cos(ang)
    wr[0, :] = 1.0 / m  # DC row (no doubling)
    wi = -(2.0 / m) * np.sin(ang)
    wi[0, :] = ((-1.0) ** t[0]) / m  # Nyquist rides lane 0 of the im plane
    return wr.astype(dtype), wi.astype(dtype)


def rfft_hc_staged_eligible(m: int) -> bool:
    """Whether ``rfft_split_hc_partA``/``partB`` split the forward transform
    in two halves of work. The reference splits its matmul four-step FFT at
    the stage boundary; ``torch.fft`` has no such boundary, so never (the
    reference's own answer on its CPU backend)."""
    return False


def rfft_split_hc_partA(x: torch.Tensor, n: Optional[int] = None):
    """First half of ``rfft_split_hc``, as the split-tail schedule's phase 0
    calls it. Not ``rfft_hc_staged_eligible``, so it computes the whole
    halfcomplex transform -> (hr, hi) [..., n//2]."""
    return rfft_split_hc(x, n=n or x.shape[-1])


def rfft_split_hc_partB(ar: torch.Tensor, ai: torch.Tensor, n: int):
    """Second half of ``rfft_split_hc_partA``: partA finished the
    transform, so its planes pass through."""
    return ar, ai
