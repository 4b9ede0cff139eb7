"""31-band ISO 1/3-octave equalizer rendered to a linear-phase FIR.

Counterpart of ``bfir_tpu/ops/equalizer.py`` (reference equalizer.cpp):
per rfft bin, raised-cosine interpolation of the band magnitudes (with
virtual endpoints at 0 and Nyquist) and linear phase, inverse FFT, and the
causal upper half as the filter. Phases convert degrees -> radians by
pi/180 (the reference divides by 180*pi, a bug with no effect at phase 0).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bfir_tpu_torch.ops import fft as F
from bfir_tpu_torch.utils.device import resolve_device

# ISO 1/3-octave centre frequencies, Hz (equalizer.hpp:17-50).
ISO_BANDS = (
    20.0, 25.0, 31.5, 40.0, 50.0, 63.0, 80.0, 100.0, 125.0, 160.0,
    200.0, 250.0, 315.0, 400.0, 500.0, 630.0, 800.0, 1000.0, 1250.0, 1600.0,
    2000.0, 2500.0, 3150.0, 4000.0, 5000.0, 6300.0, 8000.0, 10000.0, 12500.0,
    16000.0, 20000.0,
)


def synthesize_spectrum(taps: int, band_freqs_hz: Sequence[float],
                        band_mags_db: Sequence[float], sample_rate: int,
                        band_phases_deg: Optional[Sequence[float]] = None,
                        dtype=torch.float64) -> torch.Tensor:
    """The EQ filter's rfft spectrum [taps//2 + 1] (equalizer.cpp:330-354,
    band grid from :57-66,101-121)."""
    freqs = np.asarray(band_freqs_hz, dtype=np.float64)
    mags_db = np.asarray(band_mags_db, dtype=np.float64)
    phases = (np.zeros_like(freqs) if band_phases_deg is None
              else np.asarray(band_phases_deg, dtype=np.float64))
    if not (len(freqs) == len(mags_db) == len(phases)):
        raise ValueError("band arrays must have equal length")
    if np.any(np.diff(freqs) <= 0):
        raise ValueError("band frequencies must be strictly increasing")
    nyq = sample_rate / 2.0
    if freqs[0] <= 0 or freqs[-1] > nyq:
        raise ValueError("band frequencies must lie in (0, nyquist]")
    gf = np.concatenate([[0.0], freqs, [nyq]]) / sample_rate
    gm = 10.0 ** (np.concatenate([[mags_db[0]], mags_db, [mags_db[-1]]]) / 20.0)
    gp = np.deg2rad(np.concatenate([[phases[0]], phases, [phases[-1]]]))
    if gf[-1] == gf[-2]:  # last band at Nyquist: drop the duplicate point
        gf, gm, gp = gf[:-1], gm[:-1], gp[:-1]

    curfreq = torch.arange(1, taps // 2, dtype=dtype) / taps
    gf_t = torch.as_tensor(gf, dtype=dtype)
    gm_t = torch.as_tensor(gm, dtype=dtype)
    gp_t = torch.as_tensor(gp, dtype=dtype)
    # interval with gf[lo] <= curfreq <= gf[hi] (equalizer.cpp:338-341)
    hi = torch.clamp(torch.searchsorted(gf_t, curfreq, side="left"), 1,
                     gf_t.shape[0] - 1)
    lo = hi - 1
    t = (curfreq - gf_t[lo]) / (gf_t[hi] - gf_t[lo])

    def cosine_int(a, b):  # equalizer.cpp:182-204
        return (a - b) * 0.5 * torch.cos(np.pi * t) + (a + b) * 0.5

    mag = cosine_int(gm_t[lo], gm_t[hi])
    rad = -taps * np.pi * curfreq + cosine_int(gp_t[lo], gp_t[hi])
    re = torch.cat([gm_t[:1], mag * torch.cos(rad), gm_t[-1:]])
    im = torch.cat([torch.zeros(1, dtype=dtype), mag * torch.sin(rad),
                    torch.zeros(1, dtype=dtype)])
    return torch.complex(re, im)


def render_fir(taps: int, band_mags_db: Sequence[float], sample_rate: int,
               band_freqs_hz: Sequence[float] = ISO_BANDS,
               band_phases_deg: Optional[Sequence[float]] = None,
               dtype=torch.float64, mode: str = "reference") -> torch.Tensor:
    """Render the EQ to a FIR: ``mode="reference"`` keeps the causal upper
    half (length taps//2, equalizer::generate + render_d);
    ``mode="accurate"`` returns the full symmetric linear-phase FIR."""
    if taps < 4 or taps & (taps - 1):
        raise ValueError(f"taps must be a power of two >= 4, got {taps}")
    if mode not in ("reference", "accurate"):
        raise ValueError(f"unknown mode {mode!r}")
    spectrum = synthesize_spectrum(taps, band_freqs_hz, band_mags_db,
                                   sample_rate, band_phases_deg, dtype=dtype)
    impulse = F.irfft(spectrum, n=taps)
    if mode == "accurate":
        return impulse
    return impulse[taps // 2:]


def render_eq_spec(eq, filter_spec, eq_filter_blocks: int, sample_rate: int,
                   *, device) -> torch.Tensor:
    """Render an ``EqSpec`` as the plugin does at init
    (foo_dsp_bfir.cpp:150-176): taps = block_length * eq_filter_blocks, 31
    ISO bands, magnitudes in 0.1 dB steps; the FIR in the filter's dtype on
    ``device``."""
    taps = filter_spec.block_length * eq_filter_blocks
    fir = render_fir(taps, eq.mag_db, sample_rate,
                     dtype=getattr(torch, filter_spec.dtype))
    return fir.to(resolve_device(device))
