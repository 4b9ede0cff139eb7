"""The hp-TPDF requantizer loop (K9).

Counterpart of ``bfir_tpu/kernels/dither_kernel.py``. The {1, -1} error
feedback (dither.cpp:154-161) is sequential per sample and nonlinear (floor
and clip), so time cannot be split: the CUDA kernel ``csrc/dither_q.cu``
runs the whole loop of each channel in one thread. The dither values are
given, so the function is pure and the kernel must equal its plain version
bit for bit.

``quantize_hp_tpdf`` takes its plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors (or raises); it counts launches in its
``launches`` attribute.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bfir_tpu_torch.kernels import cuda_lib
from bfir_tpu_torch.ops.dither import OverflowStats, _clip_account

_FLOATS = (torch.float32, torch.float64)


def quantize_hp_tpdf_plain(x, dither_vals, e0, e1, imin: float, imax: float,
                           n_overflows, largest, intlargest):
    """Plain version of K9: a loop over the samples, vectorized across
    channels, in ``x``'s dtype -> (q [C, T] int32, e0', e1',
    n_overflows', largest', intlargest')."""
    lo = x.new_tensor(imin)
    hi = x.new_tensor(imax)
    of = OverflowStats(n_overflows, largest, intlargest)
    q = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    for t in range(x.shape[1]):
        xp = x[:, t] + e0 - e1  # error feedback (dither.cpp:154-155)
        d = xp + dither_vals[:, t]
        qt, of = _clip_account(d, lo, hi, of)
        q[:, t] = qt.to(torch.int32)
        e0, e1 = xp - qt, e0  # dither.cpp:209
    return (q, e0, e1, *of)


def _check(t: torch.Tensor, name: str, shape, dtypes, device) -> None:
    cuda_lib.require_cuda(t, name, dtypes, device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")


def quantize_hp_tpdf(x: torch.Tensor, dither_vals: torch.Tensor,
                     e0: torch.Tensor, e1: torch.Tensor, imin: float,
                     imax: float, n_overflows: torch.Tensor,
                     largest: torch.Tensor, intlargest: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """K9: requantize x [C, T] (float32 or float64, integer full-scale
    units) with dither values [C, T], error-feedback state e0, e1 [C] and
    overflow stats [C] -> (q [C, T] int32, e0', e1', n_overflows',
    largest', intlargest'). Replaces
    ``dither_kernel.quantize_hp_tpdf_pallas``."""
    if x.device.type == "cpu":
        return quantize_hp_tpdf_plain(x, dither_vals, e0, e1, imin, imax,
                                      n_overflows, largest, intlargest)
    dev = x.device
    if x.ndim != 2:
        raise ValueError(f"x must be [C, T], got {list(x.shape)}")
    c, t = x.shape
    _check(x, "x", (c, t), _FLOATS, dev)
    _check(dither_vals, "dither_vals", (c, t), (x.dtype,), dev)
    for name, v, dts in (("e0", e0, (x.dtype,)), ("e1", e1, (x.dtype,)),
                         ("n_overflows", n_overflows, (torch.int32,)),
                         ("largest", largest, (x.dtype,)),
                         ("intlargest", intlargest, (torch.int32,))):
        _check(v, name, (c,), dts, dev)
    q = torch.empty((c, t), dtype=torch.int32, device=dev)
    outs = (torch.empty_like(e0), torch.empty_like(e1),
            torch.empty_like(n_overflows), torch.empty_like(largest),
            torch.empty_like(intlargest))
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        err = lib.bfir_quantize_hp_tpdf(
            x.data_ptr(), dither_vals.data_ptr(), e0.data_ptr(),
            e1.data_ptr(), n_overflows.data_ptr(), largest.data_ptr(),
            intlargest.data_ptr(), q.data_ptr(),
            *(o.data_ptr() for o in outs), c, t, float(imin), float(imax),
            int(x.dtype == torch.float64), cuda_lib.stream_of(x))
    cuda_lib.check(err, "quantize_hp_tpdf")
    quantize_hp_tpdf.launches += 1
    return (q, *outs)


quantize_hp_tpdf.launches = 0
