"""Fused transforms of ``bfir_tpu/kernels/fft_fused.py`` (K4, K14-K16).

- ``irfft_split_hc_tail_balanced(hr, hi, n)`` (K4), the two-stage tail
  fire's inverse: halfcomplex planes -> samples [n/2, n) of the length-n
  inverse real FFT, by the real-packing route: tangle the spectrum into that
  of the length-h complex sequence z[j] = x[2j] + i x[2j+1] (h = n/2),
  inverse-transform z, keep its tail half and interleave (re, im) into
  sample pairs (``csrc/irfft_hc_tail.cu``, on the register-radix core of
  ``csrc/fft_common.cuh``; the kernel of K16 and K17 too).
- ``cfft_balanced_fused(zr, zi, h, *, inverse, tail_only=False)`` (K14):
  the length-h complex FFT of split planes, natural order, on the same
  register-radix core as K4; ``rfft_split_hc_balanced(x, n=None)`` wraps
  it in the reference's deinterleave and untangle, kept in PyTorch around
  the kernel as the reference keeps them in XLA.
- ``rfft_hc_fused(x, n=None)`` (K15): rfft -> halfcomplex planes on the
  same register-radix core, with the untangle in pairs (k, h - k) after
  it; the kernel is K18's (``kernels/fft_pallas.rfft_hc_pallas``), which
  computes the same function.
- ``irfft_hc_tail_fused(hr, hi, n)`` (K16): K4's function, with the
  reference's domain (n/8 >= 256); on the card K4's kernel.

K14 and K15 live in ``csrc/fft_family.cu``, K4 and K16 in
``csrc/irfft_hc_tail.cu``; all share the core in ``csrc/fft_common.cuh``
(``tests/test_torch_fft_core.py`` models it).
Each kernel computes its transform in its own body; the plain version
beside each wrapper runs ``torch.fft`` on CPU tensors (float32 or
float64), and CUDA tensors (float32) launch the kernel or raise. The TPU
tiling arguments (``rows_per_tile``, ``interpret``) are dropped.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bfir_tpu_torch.kernels import cuda_lib
from bfir_tpu_torch.kernels.fft_pallas import (_check_cuda, _check_dtype,
                                               _check_n, _check_planes,
                                               _device_table, _pad_last,
                                               launch_irfft_tail,
                                               launch_rfft_hc)
from bfir_tpu_torch.ops import fft as F


@functools.lru_cache(maxsize=16)
def _twiddles(n: int) -> np.ndarray:
    """e^{+2 pi i k / n} for k < n/2, built in float64: (cos, sin) pairs."""
    ang = 2.0 * np.pi * np.arange(n // 2) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


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
    float32 with unit lane stride; h = n/2 a power of two in [1024, 16384]
    (``cfft_balanced_fused``'s own rule; ValueError otherwise). Replaces
    ``fft_fused.irfft_split_hc_tail_balanced`` (``cfft_balanced_fused``)."""
    h = n // 2
    if hr.device.type == "cpu":
        return irfft_split_hc_tail_plain(hr, hi, n)
    if hr.dtype != torch.float32 or hi.dtype != torch.float32:
        raise TypeError(f"hr, hi must be float32, got {hr.dtype}, {hi.dtype}")
    if h < 1024 or h & (h - 1) or h > 16384:
        raise ValueError(f"the CUDA kernel needs h = n/2 a power of two in "
                         f"[1024, 16384], got {h}")
    if hr.shape != hi.shape or hr.shape[-1] < h:
        raise ValueError(f"hr {tuple(hr.shape)} and hi {tuple(hi.shape)} "
                         f"must match, with >= {h} lanes")
    return launch_irfft_tail(hr, hi, n, irfft_split_hc_tail_balanced,
                             strict=True)


irfft_split_hc_tail_balanced.launches = 0


def _check_balanced(h: int) -> None:
    """The reference's rule: pow2 h split as n1 x 128 with n1 % 8 == 0."""
    if h < 1024 or h & (h - 1):
        raise ValueError(f"cfft_balanced_fused needs pow2 h with h/128 % 8 "
                         f"== 0 (got h={h}: {h // 128}x128)")


def cfft_balanced_fused_plain(zr: torch.Tensor, zi: torch.Tensor, h: int, *,
                              inverse: bool, tail_only: bool = False):
    """Plain version of K14: ``torch.fft.fft`` (or ``ifft``, with 1/h) of
    zr + i zi, outputs [h/2, h) where ``tail_only``."""
    z = torch.complex(zr, zi)
    y = torch.fft.ifft(z, dim=-1) if inverse else torch.fft.fft(z, dim=-1)
    if tail_only:
        y = y[..., h // 2:]
    return y.real.contiguous(), y.imag.contiguous()


def cfft_balanced_fused(zr: torch.Tensor, zi: torch.Tensor, h: int, *,
                        inverse: bool, tail_only: bool = False):
    """K14: the length-h complex FFT of split planes zr, zi [..., h],
    forward or inverse (the inverse carries 1/h) -> (re, im) [..., h_out] in
    natural order; h_out = h/2 (outputs [h/2, h)) when ``tail_only``.
    Replaces ``fft_fused.cfft_balanced_fused``."""
    _check_balanced(h)
    if zr.shape != zi.shape or zr.shape[-1] != h:
        raise ValueError(f"zr {tuple(zr.shape)} and zi {tuple(zi.shape)} "
                         f"must match, with {h} lanes")
    _check_dtype(zr, "zr")
    _check_dtype(zi, "zi")
    if zr.device.type == "cpu" and zi.device.type == "cpu":
        return cfft_balanced_fused_plain(zr, zi, h, inverse=inverse,
                                         tail_only=tail_only)
    dev = zr.device
    _check_cuda(h, dev, zr, zi)
    batch = zr.shape[:-1]
    zr2 = zr.reshape(-1, h).contiguous()
    zi2 = zi.reshape(-1, h).contiguous()
    rows = zr2.shape[0]
    h_out = h // 2 if tail_only else h
    out_r = torch.empty((rows, h_out), dtype=torch.float32, device=dev)
    out_i = torch.empty_like(out_r)
    if rows:
        tw = _device_table(h, dev)
        lib = cuda_lib.load()
        with torch.cuda.device(dev):
            err = lib.bfir_cfft_balanced(zr2.data_ptr(), zi2.data_ptr(),
                                         out_r.data_ptr(), out_i.data_ptr(),
                                         tw.data_ptr(), rows, h, int(inverse),
                                         int(tail_only),
                                         cuda_lib.stream_of(out_r))
        cuda_lib.check(err, "cfft_balanced_fused")
        cfft_balanced_fused.launches += 1
    return out_r.reshape(*batch, h_out), out_i.reshape(*batch, h_out)


@functools.lru_cache(maxsize=16)
def _half_twiddle(m: int) -> np.ndarray:
    """e^{-2 pi i k / m} for k < m/2 in float64: (cos, sin) rows."""
    ang = -2.0 * np.pi * np.arange(m // 2) / m
    return np.stack([np.cos(ang), np.sin(ang)])


def rfft_split_hc_balanced(x: torch.Tensor, n: int | None = None):
    """``rfft_split_hc``-equivalent on K14: the even/odd deinterleave, the
    length-n/2 complex FFT (K14), the untangle and hc pack -> (hr, hi)
    [..., n/2]. x is cut or zero-padded to n (default: its length).
    Replaces ``fft_fused.rfft_split_hc_balanced``."""
    m = n or x.shape[-1]
    h = m // 2
    batch = x.shape[:-1]
    x2 = _pad_last(x.reshape(-1, x.shape[-1]), m)
    zr, zi = cfft_balanced_fused(x2[..., 0::2], x2[..., 1::2], h,
                                 inverse=False)
    # untangle + hc pack (the reference's post-pass)
    zr_rev = torch.cat([zr[..., :1], zr[..., 1:].flip(-1)], dim=-1)
    zi_rev = torch.cat([zi[..., :1], zi[..., 1:].flip(-1)], dim=-1)
    ar = 0.5 * (zr + zr_rev)
    ai = 0.5 * (zi - zi_rev)
    br = 0.5 * (zi + zi_rev)
    bi = -0.5 * (zr - zr_rev)
    twr, twi = torch.from_numpy(_half_twiddle(m)).to(zr.dtype).to(zr.device)
    xr = ar + twr * br - twi * bi
    xi = ai + twr * bi + twi * br
    xi[..., 0] = zr[..., 0] - zi[..., 0]  # Nyquist.re in lane 0
    return xr.reshape(*batch, h), xi.reshape(*batch, h)


def rfft_hc_fused_plain(x: torch.Tensor, m: int):
    """Plain version of K15: ``torch.fft.rfft`` of x cut or padded to m,
    packed as halfcomplex planes."""
    return F.rfft_split_hc(x, n=m)


def rfft_hc_fused(x: torch.Tensor, n: int | None = None):
    """K15: rfft over the last axis -> halfcomplex planes (hr, hi), each
    [..., h = n/2]; lane 0 = (DC.re, Nyquist.re). x is cut or zero-padded
    to n (default: its length). Replaces ``fft_fused.rfft_hc_fused``."""
    m = n or x.shape[-1]
    _check_n("rfft_hc_fused", m, 128)
    _check_dtype(x, "x")
    if x.device.type == "cpu":
        return rfft_hc_fused_plain(x, m)
    return launch_rfft_hc(x, m, rfft_hc_fused)


def irfft_hc_tail_fused_plain(hr: torch.Tensor, hi: torch.Tensor,
                              n: int) -> torch.Tensor:
    """Plain version of K16: ``torch.fft.irfft`` of the planes' first n/2
    lanes, tail half."""
    return F.irfft_hc_tail(hr, hi, n)


def irfft_hc_tail_fused(hr: torch.Tensor, hi: torch.Tensor,
                        n: int) -> torch.Tensor:
    """K16: ``irfft_split_hc(hr, hi, n)[..., n/2:]``, the overlap-save tail,
    for halfcomplex planes [..., >= n/2] (lane padding ignored) -> [...,
    n/2]. Replaces ``fft_fused.irfft_hc_tail_fused``."""
    _check_n("irfft_hc_tail_fused", n, 256)
    _check_planes(hr, hi, n // 2)
    _check_dtype(hr, "hr")
    _check_dtype(hi, "hi")
    if hr.device.type == "cpu" and hi.device.type == "cpu":
        return irfft_hc_tail_fused_plain(hr, hi, n)
    return launch_irfft_tail(hr, hi, n, irfft_hc_tail_fused)


cfft_balanced_fused.launches = 0
rfft_hc_fused.launches = 0
irfft_hc_tail_fused.launches = 0
