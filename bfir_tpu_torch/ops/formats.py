"""PCM sample-format codecs and the output stage.

Counterpart of ``bfir_tpu/ops/formats.py`` (reference ``raw2real`` and
``real2raw``):

- the byte packing (endianness, 24-bit samples in 3 bytes, padded
  ``S24_4*`` containers with their shift) runs on the host. ``decode`` and
  ``encode_int`` go through the native C++ codec
  (``bfir_tpu_torch.native``) on every device, as the reference's do when
  its library is built; a failed build or call raises, nothing falls back.
  ``decode_plain`` and ``encode_int_plain`` are the numpy codec, kept as
  the plain versions the tests and ``chip_smoke.py`` hold the native bytes
  against; no path of the engine calls them. ``encode_float`` is numpy, as
  in the reference;
- the scaling and quantization (real2raw.cpp:38-1224) run on the tensor's
  device: ``output_stage`` scales to the integer domain and requantizes with
  hp-TPDF dither and error feedback (``ops.dither``, kernel K9 on CUDA) or
  mid-tread rounding; float outputs are never clipped, only counted
  (REAL_OVERFLOW_UPDATE, real2raw.cpp:17-32): on the device
  (``count_float_overflow``), or on the host where the samples already are
  (``count_float_overflow_host``, the session's float output).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bfir_tpu_torch import native
from bfir_tpu_torch.core.spec import SampleFormat
from bfir_tpu_torch.ops import dither as dth
from bfir_tpu_torch.ops.dither import DitherState, OverflowStats


def _np_int_dtype(fmt: SampleFormat):
    e = ">" if fmt.big_endian else "<"
    if fmt.bytes == 1:
        return np.dtype(np.int8)
    return np.dtype(f"{e}i{fmt.bytes}")


def decode(raw, fmt: SampleFormat, n_channels: int,
           dtype=np.float64) -> np.ndarray:
    """Interleaved raw PCM (bytes, bytearray, memoryview or a uint8 array)
    -> float [C, N] at +-1 full scale (raw2real with the input ``sf.scale``,
    brutefir.cpp:435-539), through the native codec. A trailing partial
    frame is dropped."""
    return native.decode_f64(raw, fmt, n_channels).astype(dtype, copy=False)


def decode_plain(raw, fmt: SampleFormat, n_channels: int,
                 dtype=np.float64) -> np.ndarray:
    """``decode`` in numpy: the plain version of the native decode."""
    buf = (np.frombuffer(raw, dtype=np.uint8)
           if isinstance(raw, (bytes, bytearray))
           else np.asarray(raw, dtype=np.uint8))
    frame_bytes = fmt.bytes * n_channels
    n = buf.size // frame_bytes
    buf = buf[: n * frame_bytes]
    if fmt.isfloat:
        fdt = np.dtype((">" if fmt.big_endian else "<")
                       + ("f4" if fmt.bytes == 4 else "f8"))
        x = buf.view(fdt).astype(dtype)
    elif fmt.bytes == 3:
        b = buf.reshape(-1, 3)
        if fmt.big_endian:
            b = b[:, ::-1]
        i32 = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = (i32 << 8) >> 8
        x = i32.astype(dtype) / fmt.full_scale
    else:
        ints = buf.view(_np_int_dtype(fmt)).astype(np.int64)
        if fmt.sbytes != fmt.bytes:  # padded container: the high sbytes
            ints = ints >> ((fmt.bytes - fmt.sbytes) * 8)
        x = ints.astype(dtype) / fmt.full_scale
    return x.reshape(n, n_channels).T.copy()


def encode_int(q: np.ndarray, fmt: SampleFormat) -> bytes:
    """Quantized int32 samples [C, N] -> interleaved raw bytes, through the
    native codec."""
    if fmt.isfloat:
        raise ValueError("encode_int is for integer formats")
    return native.encode_int(q, fmt)


def encode_int_plain(q: np.ndarray, fmt: SampleFormat) -> bytes:
    """``encode_int`` in numpy: the plain version of the native encode."""
    if fmt.isfloat:
        raise ValueError("encode_int is for integer formats")
    inter = np.asarray(q, dtype=np.int64).T.reshape(-1)
    if fmt.bytes == 3:
        flat = inter.astype(np.int32)
        b = np.empty((flat.size, 3), dtype=np.uint8)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        if fmt.big_endian:
            b = b[:, ::-1]
        return b.tobytes()
    if fmt.sbytes != fmt.bytes:
        inter = inter << ((fmt.bytes - fmt.sbytes) * 8)
    return inter.astype(_np_int_dtype(fmt)).tobytes()


def encode_float(x: np.ndarray, fmt: SampleFormat) -> bytes:
    """Float samples [C, N] at +-1 full scale -> interleaved raw bytes."""
    if not fmt.isfloat:
        raise ValueError("encode_float is for float formats")
    e = ">" if fmt.big_endian else "<"
    return np.asarray(x).T.astype(np.dtype(f"{e}f{fmt.bytes}")).tobytes()


def count_float_overflow(x: torch.Tensor, of: OverflowStats,
                         fmax: float = 1.0) -> OverflowStats:
    """Count |x| > fmax per channel and track the peak; never clip
    (REAL_OVERFLOW_UPDATE, real2raw.cpp:17-32). x: [C, T]."""
    mag = x.abs()
    n_of = of.n_overflows + (mag > fmax).sum(dim=1, dtype=torch.int32)
    largest = torch.maximum(of.largest, mag.amax(dim=1).to(of.largest.dtype))
    return OverflowStats(n_of, largest, of.intlargest)


def count_float_overflow_host(x: np.ndarray, of: OverflowStats,
                              fmax: float = 1.0,
                              out: Optional[np.ndarray] = None
                              ) -> OverflowStats:
    """``count_float_overflow`` on host samples: x [C, T] numpy, ``of``
    numpy stats. The same operations in numpy (a NaN peak, Infs counted);
    counts add and peaks take their maximum, so the stats equal
    ``count_float_overflow``'s over the same samples however they are
    split. |x| > fmax is counted only where some peak is not <= fmax.
    ``out``: an array of x's shape and dtype that takes |x|, or None (a
    temporary)."""
    if x.shape[1] == 0:
        return of
    mag = np.abs(x, out=out)
    peak = mag.max(axis=1)
    largest = np.maximum(of.largest, peak.astype(of.largest.dtype, copy=False))
    n_of = of.n_overflows
    if not (peak <= fmax).all():  # a NaN peak, too
        n_of = n_of + np.count_nonzero(mag > fmax, axis=1).astype(np.int32)
    return OverflowStats(n_of, largest, of.intlargest)


def output_stage(y: torch.Tensor, fmt: SampleFormat, of: OverflowStats,
                 dither_state: Optional[DitherState] = None
                 ) -> Tuple[torch.Tensor, OverflowStats,
                            Optional[DitherState]]:
    """Engine-domain output [C, N] (+-1 full scale) -> the output format's
    numeric domain, on ``y``'s device:

    - float formats: ``y`` itself, overflow counted, never clipped;
    - integer formats with ``dither_state``: scaled to the integer domain,
      hp-TPDF dither, error feedback and clip (convolver_cbuf2raw with
      apply_dither, fftw_convolver.cpp:405-466);
    - integer formats without: mid-tread rounding and clip.

    Returns (samples, new overflow stats, new dither state): float samples
    for ``encode_float``, int32 for ``encode_int``."""
    if fmt.isfloat:
        return y, count_float_overflow(y, of), dither_state
    scaled = y * y.new_tensor(fmt.full_scale)
    if dither_state is not None:
        q, dither_state, of = dth.quantize_hp_tpdf(scaled, fmt.imin,
                                                   fmt.imax, dither_state, of)
    else:
        q, of = dth.quantize_no_dither(scaled, fmt.imin, fmt.imax, of)
    return q, of, dither_state


def input_stage(raw, fmt: SampleFormat, n_channels: int,
                dtype=np.float32) -> np.ndarray:
    """Raw input bytes -> the engine float domain (raw2cbuf's raw2real
    call, fftw_convolver.cpp:156-185)."""
    return decode(raw, fmt, n_channels, dtype=dtype)
