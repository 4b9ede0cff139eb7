"""The two-stage tail fire's inverse transform (K4).

Counterpart of ``bfir_tpu/kernels/fft_fused.py::irfft_split_hc_tail_balanced``:
halfcomplex planes -> samples [n/2, n) of the length-n inverse real FFT, by
the real-packing route: tangle the spectrum into that of the length-h
complex sequence z[j] = x[2j] + i x[2j+1] (h = n/2), inverse-transform z,
keep its tail half and interleave (re, im) into sample pairs. The CUDA
kernel (``csrc/irfft_hc_tail.cu``) computes the transform in its own body;
the plain version beside it runs the same tangle around ``torch.fft``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bfir_tpu_torch.kernels import cuda_lib


@functools.lru_cache(maxsize=16)
def _twiddles(n: int) -> np.ndarray:
    """e^{+2 pi i k / n} for k < n/2, built in float64: (cos, sin) pairs."""
    ang = 2.0 * np.pi * np.arange(n // 2) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


@functools.lru_cache(maxsize=16)
def _device_tables(h: int, device: torch.device):
    """The kernel's float32 twiddle tables on ``device``: the tangle's
    e^{+2 pi i k / 2h} (k < h) and the FFT's e^{+2 pi i j / h} (j < h/2)."""
    tw_n = torch.from_numpy(_twiddles(2 * h).astype(np.float32)).to(device)
    tw_h = torch.from_numpy(_twiddles(h).astype(np.float32)).to(device)
    return tw_n, tw_h


def _tangle(hr: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """hc planes [.., h] -> complex spectrum Z [.., h] of the packed
    sequence (``fft_fused._tangle_xla``): A = (X[k] + X*[h-k]) / 2,
    D = (X[k] - X*[h-k]) / 2, Z = A + i e^{+2 pi i k / n} D, with lane 0
    holding (DC, Nyquist)."""
    tw = torch.from_numpy(_twiddles(n)).to(hr.dtype).to(hr.device)
    twr, twi = tw[:, 0], tw[:, 1]
    lane0 = torch.zeros(hr.shape[-1], dtype=torch.bool, device=hr.device)
    lane0[0] = True
    xr_rev = torch.roll(torch.flip(hr, dims=[-1]), 1, dims=-1)
    xi_rev = torch.roll(torch.flip(hi, dims=[-1]), 1, dims=-1)
    xr_rev = torch.where(lane0, hi[..., :1], xr_rev)
    xi_rev = torch.where(lane0, 0.0, xi_rev)
    xi_true = torch.where(lane0, 0.0, hi)
    ar = 0.5 * (hr + xr_rev)
    ai = 0.5 * (xi_true - xi_rev)
    dr = 0.5 * (hr - xr_rev)
    di = 0.5 * (xi_true + xi_rev)
    er = twr * dr - twi * di
    ei = twr * di + twi * dr
    return torch.complex(ar - ei, ai + er)


def irfft_split_hc_tail_plain(hr: torch.Tensor, hi: torch.Tensor,
                              n: int) -> torch.Tensor:
    """Plain PyTorch version of K4 (the reference's arithmetic: tangle,
    inverse FFT with 1/h, tail half, interleave)."""
    h = n // 2
    z = _tangle(hr[..., :h], hi[..., :h], n)
    c = torch.fft.ifft(z, dim=-1)[..., h // 2:]
    return torch.view_as_real(c).reshape(*c.shape[:-1], h)


def irfft_split_hc_tail_balanced(hr: torch.Tensor, hi: torch.Tensor,
                                 n: int) -> torch.Tensor:
    """K4: ``irfft_split_hc(hr, hi, n)[..., n/2:]`` for halfcomplex planes
    [..., >= n/2] (lane padding ignored) -> [..., n/2]. CUDA inputs must be
    float32 with unit lane stride; h = n/2 a power of two <= 16384. Replaces
    ``fft_fused.irfft_split_hc_tail_balanced`` (``cfft_balanced_fused``)."""
    h = n // 2
    if hr.device.type == "cpu":
        return irfft_split_hc_tail_plain(hr, hi, n)
    if hr.device.type != "cuda" or hi.device != hr.device:
        raise ValueError(f"hr, hi must be on one CUDA device, got "
                         f"{hr.device}, {hi.device}")
    if hr.dtype != torch.float32 or hi.dtype != torch.float32:
        raise TypeError(f"hr, hi must be float32, got {hr.dtype}, {hi.dtype}")
    if h < 2 or h & (h - 1) or h > 16384:
        raise ValueError(f"h = n/2 must be a power of two <= 16384, got {h}")
    if hr.shape != hi.shape or hr.shape[-1] < h:
        raise ValueError(f"hr {tuple(hr.shape)} and hi {tuple(hi.shape)} "
                         f"must match, with >= {h} lanes")
    batch = hr.shape[:-1]
    hr2 = hr.reshape(-1, hr.shape[-1])
    hi2 = hi.reshape(-1, hi.shape[-1])
    rows = hr2.shape[0]
    if (hr2.stride(-1) != 1 or hi2.stride(-1) != 1
            or hr2.stride(0) != hi2.stride(0)):
        raise ValueError("hr, hi must have unit lane stride and equal row "
                         "strides")
    out = torch.empty((rows, h), dtype=torch.float32, device=hr.device)
    tw_n, tw_h = _device_tables(h, hr.device)
    lib = cuda_lib.load()
    with torch.cuda.device(hr.device):
        err = lib.bfir_irfft_hc_tail(hr2.data_ptr(), hi2.data_ptr(),
                                     hr2.stride(0), out.data_ptr(),
                                     tw_n.data_ptr(), tw_h.data_ptr(), rows,
                                     h, cuda_lib.stream_of(out))
    cuda_lib.check(err, "irfft_split_hc_tail_balanced")
    irfft_split_hc_tail_balanced.launches += 1
    return out.reshape(*batch, h)


irfft_split_hc_tail_balanced.launches = 0
