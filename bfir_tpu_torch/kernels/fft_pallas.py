"""Whole-transform real FFTs in the halfcomplex layout (K17, K18).

Counterpart of ``bfir_tpu/kernels/fft_pallas.py``: the engine's forward
real FFT to halfcomplex planes and its overlap-save inverse tail, each one
kernel that keeps a row's whole transform on chip.

- ``rfft_hc_pallas(x, n=None)`` (K18): rfft over the last axis -> (hr, hi),
  each ``[..., n/2]``, lane 0 = (DC.re, Nyquist.re). CUDA kernel: the
  register-radix core (``csrc/fft_common.cuh``) over the packed sequence
  z[j] = x[2j] + i x[2j+1], then the untangle and hc pack in pairs
  (k, h - k) (``rfft_hc_kernel`` in ``csrc/fft_family.cu``, shared with
  K15, which computes the same function).
- ``irfft_hc_tail_pallas(hr, hi, n)`` (K17): samples [n/2, n) of the
  inverse of halfcomplex planes ``[..., >= n/2]`` (lane padding ignored).
  CUDA kernel: K4's, the tangle as pass 0 of the register-radix core
  loads, the inverse with only the tail half stored
  (``csrc/irfft_hc_tail.cu``, shared with K4 and K16, which compute the
  same function).

Both need a power-of-two n with n/8 >= 128, as the reference's; the CUDA
kernels also need n/2 <= 16384 (a row's transform in shared memory). The
TPU tiling arguments (``rows_per_tile``, ``interpret``) are dropped: a CUDA
block takes one row, any row count works.

Each wrapper runs its plain PyTorch version (``torch.fft``) on CPU tensors,
float32 or float64, and launches its kernel on CUDA tensors, float32 only.
The launch helpers here serve K4, K15 and K16 in ``kernels/fft_fused.py``
too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bfir_tpu_torch.kernels import cuda_lib
from bfir_tpu_torch.ops import fft as F

MAX_H = 16384  # the kernels' limit on n/2: 8 n/2 bytes of shared memory


@functools.lru_cache(maxsize=16)
def _device_table(h: int, device: torch.device) -> torch.Tensor:
    """The kernels' twiddle table for half-length h on ``device``:
    e^{-2 pi i t / 2h} for t < 2h, (cos, sin) pairs built in float64 and
    rounded once to float32."""
    ang = -np.pi * np.arange(2 * h) / h
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """x cut or zero-padded to n along the last axis."""
    if x.shape[-1] >= n:
        return x[..., :n]
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def _check_n(name: str, m: int, n1_min: int) -> None:
    """The reference's rule: n a power of two with n//8 >= n1_min."""
    if m < 1 or m & (m - 1) or m // 8 < n1_min:
        raise ValueError(f"{name} needs pow2 n with n//8 >= {n1_min}, got {m}")


def _check_dtype(t: torch.Tensor, name: str) -> None:
    """float32 or float64 on the CPU; float32 on any other device."""
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32 (or "
                        "float64 on the CPU)")
    if t.device.type != "cpu" and t.dtype == torch.float64:
        raise NotImplementedError(
            f"{name} is float64: the kernel computes in float32; float64 on "
            'CUDA runs on engine_mode="extended" (or "auto")')


def _check_cuda(h: int, device: torch.device, *tensors) -> None:
    """Raise unless h is within the kernels' shared-memory limit and every
    tensor lies on the CUDA ``device``."""
    if h > MAX_H:
        raise ValueError(f"h = {h} is above the kernels' shared-memory "
                         f"limit {MAX_H}")
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"the kernel needs a CUDA tensor on {device}, got "
                             f"{t.device}")


def _check_planes(hr: torch.Tensor, hi: torch.Tensor, h: int) -> None:
    if hr.shape != hi.shape or hr.shape[-1] < h:
        raise ValueError(f"hr {tuple(hr.shape)} and hi {tuple(hi.shape)} "
                         f"must match, with >= {h} lanes")


def _rows_with_stride(hr: torch.Tensor, hi: torch.Tensor, h: int,
                      strict: bool = False):
    """Planes as rows [R, width] that share one row stride of at least h
    and have unit lane stride (copying the first h lanes where they do
    not; ``strict``: raising where the lane or row strides do not), and
    that stride."""
    hr2 = hr.reshape(-1, hr.shape[-1])
    hi2 = hi.reshape(-1, hi.shape[-1])
    strided = (hr2.stride(-1) == 1 and hi2.stride(-1) == 1
               and hr2.stride(0) == hi2.stride(0))
    if strict and not strided:
        raise ValueError("hr, hi must have unit lane stride and equal row "
                         "strides")
    if not strided or hr2.stride(0) < h:
        hr2, hi2 = hr2[:, :h].contiguous(), hi2[:, :h].contiguous()
    return hr2, hi2, hr2.stride(0) if hr2.shape[0] > 1 else h


def launch_rfft_hc(x: torch.Tensor, m: int, wrapper):
    """Run the forward kernel of ``wrapper`` (K15 or K18: one kernel, each
    wrapper counting its own launches) on CUDA rows of x cut or padded to
    m -> (hr, hi) [..., m/2]."""
    h = m // 2
    _check_cuda(h, x.device, x)
    batch = x.shape[:-1]
    x2 = _pad_last(x.reshape(-1, x.shape[-1]), m).contiguous()
    if x2.data_ptr() % 8:  # the kernels read sample pairs as float2
        x2 = x2.clone()
    rows = x2.shape[0]
    hr = torch.empty((rows, h), dtype=torch.float32, device=x.device)
    hi = torch.empty_like(hr)
    if rows:
        tw = _device_table(h, x.device)
        lib = cuda_lib.load()
        with torch.cuda.device(x.device):
            err = lib.bfir_rfft_hc(x2.data_ptr(), hr.data_ptr(),
                                   hi.data_ptr(), tw.data_ptr(), rows, h,
                                   cuda_lib.stream_of(hr))
        cuda_lib.check(err, wrapper.__name__)
        wrapper.launches += 1
    return hr.reshape(*batch, h), hi.reshape(*batch, h)


def launch_irfft_tail(hr: torch.Tensor, hi: torch.Tensor, n: int,
                      wrapper, strict: bool = False) -> torch.Tensor:
    """Run the inverse-tail kernel of ``wrapper`` (K4, K16 or K17: one
    kernel, each wrapper counting its own launches) on CUDA planes
    [..., >= n/2] -> samples [n/2, n), [..., n/2]. ``strict``: planes
    that would need a copy (``_rows_with_stride``) raise instead."""
    h = n // 2
    _check_cuda(h, hr.device, hr, hi)
    batch = hr.shape[:-1]
    hr2, hi2, stride = _rows_with_stride(hr, hi, h, strict)
    rows = hr2.shape[0]
    out = torch.empty((rows, h), dtype=torch.float32, device=hr.device)
    if rows:
        tw = _device_table(h, hr.device)
        lib = cuda_lib.load()
        with torch.cuda.device(hr.device):
            err = lib.bfir_irfft_hc_tail(hr2.data_ptr(), hi2.data_ptr(),
                                         stride, out.data_ptr(),
                                         tw.data_ptr(), rows, h,
                                         cuda_lib.stream_of(out))
        cuda_lib.check(err, wrapper.__name__)
        wrapper.launches += 1
    return out.reshape(*batch, h)


def rfft_hc_pallas_plain(x: torch.Tensor, m: int):
    """Plain version of K18: ``torch.fft.rfft`` of x cut or padded to m,
    packed as halfcomplex planes."""
    return F.rfft_split_hc(x, n=m)


def rfft_hc_pallas(x: torch.Tensor, n: int | None = None):
    """K18: rfft over the last axis -> halfcomplex planes (hr, hi), each
    [..., h = n/2]; lane 0 = (DC.re, Nyquist.re). x is cut or zero-padded
    to n (default: its length). Replaces ``fft_pallas.rfft_hc_pallas``."""
    m = n or x.shape[-1]
    _check_n("rfft_hc_pallas", m, 128)
    _check_dtype(x, "x")
    if x.device.type == "cpu":
        return rfft_hc_pallas_plain(x, m)
    return launch_rfft_hc(x, m, rfft_hc_pallas)


def irfft_hc_tail_pallas_plain(hr: torch.Tensor, hi: torch.Tensor,
                               n: int) -> torch.Tensor:
    """Plain version of K17: ``torch.fft.irfft`` of the planes' first n/2
    lanes, tail half."""
    return F.irfft_hc_tail(hr, hi, n)


def irfft_hc_tail_pallas(hr: torch.Tensor, hi: torch.Tensor,
                         n: int) -> torch.Tensor:
    """K17: ``irfft_split_hc(hr, hi, n)[..., n/2:]``, the overlap-save tail,
    for halfcomplex planes [..., >= n/2] (lane padding ignored) -> [...,
    n/2]. Replaces ``fft_pallas.irfft_hc_tail_pallas``."""
    _check_n("irfft_hc_tail_pallas", n, 128)
    _check_planes(hr, hi, n // 2)
    _check_dtype(hr, "hr")
    _check_dtype(hi, "hi")
    if hr.device.type == "cpu" and hi.device.type == "cpu":
        return irfft_hc_tail_pallas_plain(hr, hi, n)
    return launch_irfft_tail(hr, hi, n, irfft_hc_tail_pallas)


rfft_hc_pallas.launches = 0
irfft_hc_tail_pallas.launches = 0
