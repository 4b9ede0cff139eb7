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
  real input, so both fit in lane 0);
- ``n`` pads or truncates the transformed axis as numpy's does; a tail is
  the upper half ``[n//2, n)`` of an inverse, the overlap-save output;
  ``cols`` / ``rows`` are ``(start, count)`` output selections.

The leading-axis forms (``fft0``, ``ifft0``, ``fft0_split``,
``ifft0_slice``) are the reference's left-matmul alternatives; here they
are ``torch.fft`` along dim 0. The reference's mode knobs (``set_mode``,
``set_karatsuba``, ``set_matmul_precision``) choose among its TPU
implementations and their MXU precision; there is one implementation
here, so they have no counterpart.

The reference's half-DFT tail basis (``_hc_tail_weights``) is kept for
the one kernel that multiplies by it, K12 (``step_hc_fused``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def rfft(x: torch.Tensor, n: Optional[int] = None,
         axis: int = -1) -> torch.Tensor:
    return torch.fft.rfft(x, n=n, dim=axis)


def irfft(y: torch.Tensor, n: Optional[int] = None,
          axis: int = -1) -> torch.Tensor:
    return torch.fft.irfft(y, n=n, dim=axis)


def fft(y: torch.Tensor, n: Optional[int] = None,
        axis: int = -1) -> torch.Tensor:
    return torch.fft.fft(y, n=n, dim=axis)


def ifft(y: torch.Tensor, n: Optional[int] = None,
         axis: int = -1) -> torch.Tensor:
    return torch.fft.ifft(y, n=n, dim=axis)


def _check_range(what: str, sel, m: int) -> None:
    start, count = sel
    if start < 0 or count < 1 or start + count > m:
        raise ValueError(f"{what} [{start}, {start + count}) out of range "
                         f"for {m}")


def _cfft_split(yr, yi, n, inverse: bool, sel, dim: int, what: str):
    """Complex FFT along ``dim`` of split planes, keeping ``sel`` =
    (start, count) of its outputs (all when None) -> (re, im)."""
    m = n or yr.shape[dim]
    if sel is not None:
        _check_range(what, sel, m)
    fn = torch.fft.ifft if inverse else torch.fft.fft
    z = fn(torch.complex(yr, yi), n=m, dim=dim)
    if sel is not None:
        z = z.narrow(dim, *sel)
    return z.real, z.imag


def cfft_split(yr: torch.Tensor, yi: torch.Tensor, n: Optional[int] = None,
               inverse: bool = False, cols=None):
    """Complex FFT over the last axis on split re/im planes -> (re, im);
    ``cols=(start, count)`` keeps output columns [start, start + count)."""
    return _cfft_split(yr, yi, n, inverse, cols, -1, "cols")


def fft0(y: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """FFT over the leading axis."""
    return torch.fft.fft(y, n=n, dim=0)


def ifft0(y: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Inverse FFT over the leading axis."""
    return torch.fft.ifft(y, n=n, dim=0)


def fft0_split(yr: torch.Tensor, yi: torch.Tensor, n: Optional[int] = None,
               inverse: bool = False, rows=None):
    """Complex FFT over the leading axis on split re/im planes -> (re, im);
    ``rows=(start, count)`` keeps output rows [start, start + count)."""
    return _cfft_split(yr, yi, n, inverse, rows, 0, "rows")


def ifft0_slice(y: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """``ifft(y, axis=0)[start : start + count]``."""
    _check_range("rows", (start, count), y.shape[0])
    return torch.fft.ifft(y, dim=0)[start:start + count]


def rfft_split(x: torch.Tensor, n: Optional[int] = None):
    """rfft over the last axis -> (re, im), each [..., n//2 + 1]."""
    y = torch.fft.rfft(x, n=n or x.shape[-1], dim=-1)
    return y.real, y.imag


def irfft_split(yr: torch.Tensor, yi: torch.Tensor,
                n: Optional[int] = None) -> torch.Tensor:
    """Inverse rfft from split re/im planes -> real [..., n]."""
    m = n or 2 * (yr.shape[-1] - 1)
    return torch.fft.irfft(torch.complex(yr, yi), n=m, dim=-1)


def irfft_split_tail(yr: torch.Tensor, yi: torch.Tensor,
                     n: Optional[int] = None) -> torch.Tensor:
    """``irfft_split(yr, yi, n)[..., n//2:]``: only the upper half."""
    m = n or 2 * (yr.shape[-1] - 1)
    return irfft_split(yr, yi, m)[..., m // 2:]


def irfft_tail(y: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """``irfft(y, n, axis=-1)[..., n//2:]``."""
    m = n or 2 * (y.shape[-1] - 1)
    return torch.fft.irfft(y, n=m, dim=-1)[..., m // 2:]


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


def czeros(shape, dtype=torch.complex64, *, device) -> torch.Tensor:
    """Complex zeros on ``device``."""
    return torch.zeros(shape, dtype=dtype, device=device)


def to_numpy(x) -> np.ndarray:
    """A tensor (any device, complex included) or array as a host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def from_numpy_complex(x, *, device) -> torch.Tensor:
    """A host array, complex or real, as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)
