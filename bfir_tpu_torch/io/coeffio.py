"""Coefficient (impulse response) file loaders.

Counterpart of ``bfir_tpu/io/coeffio.py``, the reference's
``brutefir/coeff.{cpp,hpp}`` loader family:

- ``load_dirac``  -> ``coeff::load_dirac_coeff`` (coeff.cpp:32-59): a unit
  impulse per channel;
- ``load_text``   -> ``coeff::load_text_coeff`` (coeff.cpp:72-140): one
  float per line (whitespace-separated accepted), shared across channels;
- ``load_raw``    -> ``coeff::load_raw_coeff`` (coeff.cpp:153-228): packed
  binary samples of a given PCM format, scaled to +-1 full scale;
- ``load_sound``  -> ``coeff::load_snd_coeff`` (coeff.cpp:245-277): through
  the any-format reader (``io.sndio``), deinterlaced to [C, taps].

Every loader returns float64 numpy [C, taps] (C = 1 for shared
coefficients, which the engines broadcast). Host code: no tensors, so no
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from bfir_tpu_torch.core.spec import SampleFormat
from bfir_tpu_torch.io import sndio
from bfir_tpu_torch.ops import formats as fm


def load_dirac(n_channels: int, taps: int) -> np.ndarray:
    h = np.zeros((n_channels, taps))
    h[:, 0] = 1.0
    return h


def load_text(path: str) -> np.ndarray:
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", ";")):
                continue
            vals.extend(float(tok) for tok in line.split())
    if not vals:
        raise ValueError(f"no coefficients in {path}")
    return np.asarray(vals, dtype=np.float64)[None, :]


def load_raw(path: str, fmt: SampleFormat = SampleFormat.FLOAT64_LE,
             n_channels: int = 1) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    return fm.decode(raw, fmt, n_channels)


def dump_text(path: str, impulse: np.ndarray) -> None:
    """Write an impulse as one float per line (channel 0 of a
    multi-channel impulse), the format ``convolver_debug_dump_cbuf`` emits
    (fftw_convolver.cpp:604-651) and ``load_text`` reads back."""
    h = np.asarray(impulse)
    if h.ndim == 2:
        h = h[0]
    with open(path, "w") as f:
        for v in h:
            f.write(f"{v:.17g}\n")


def load_sound(path: str, max_taps: Optional[int] = None) -> np.ndarray:
    audio, _rate = sndio.read(path)
    h = audio.T
    if max_taps is not None:
        h = h[:, :max_taps]
    return h
