"""Polyphase windowed-sinc sample-rate conversion.

Counterpart of ``bfir_tpu/ops/resample.py`` (replacing the reference's
libsamplerate call, buffer.cpp:224-330): rational L/M conversion with a
Kaiser-windowed sinc prototype designed on the host, applied as a gather
of input windows reduced against per-phase coefficients.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from bfir_tpu_torch.ops.firwindow import design_lowpass, kaiser_beta_for_attenuation
from bfir_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=16)
def _polyphase_filter(l: int, m: int, taps_per_phase: int, atten_db: float,
                      rolloff: float) -> np.ndarray:
    """The prototype lowpass as a polyphase bank [L, K]."""
    k = taps_per_phase
    cutoff = rolloff * 0.5 * min(1.0 / l, 1.0 / m)
    beta = kaiser_beta_for_attenuation(atten_db)
    h = design_lowpass(l * k, cutoff, beta=beta) * l  # gain L keeps the level
    return h.reshape(k, l).T.copy()


def taps_per_phase_for(atten_db: float, rolloff: float) -> int:
    """Kaiser length per polyphase branch for the transition band
    (1 - rolloff) * pi at the narrower Nyquist."""
    n = (atten_db - 8.0) / (2.285 * (1.0 - rolloff) * math.pi)
    return max(16, int(math.ceil(n)))


def resample(x, rate_in: int, rate_out: int, taps_per_phase: int = None,
             atten_db: float = 145.0, rolloff: float = 0.945,
             dtype: torch.dtype = None) -> torch.Tensor:
    """Resample ``x`` [..., T] from rate_in to rate_out ->
    [..., ceil(T * rate_out / rate_in)], time-aligned with the input (the
    prototype's group delay is removed)."""
    if rate_in < 1 or rate_out < 1:
        raise ValueError(f"sample rates must be >= 1, got {rate_in} -> {rate_out}")
    x = torch.as_tensor(x)
    if dtype is not None:
        x = x.to(dtype)
    if rate_in == rate_out:
        return x
    g = math.gcd(rate_in, rate_out)
    l, m = rate_out // g, rate_in // g
    if taps_per_phase is None:
        taps_per_phase = taps_per_phase_for(atten_db, rolloff)
    bank = torch.as_tensor(_polyphase_filter(l, m, taps_per_phase, atten_db,
                                             rolloff), dtype=x.dtype)
    k = bank.shape[1]
    t = x.shape[-1]
    j_out = int(np.ceil(t * l / m))
    # output j sits at upsampled position j*M; the flipped K-tap filter spans
    # inputs n_j-K+1 .. n_j after removing the (L*K)//2 group delay
    pos = np.arange(j_out) * m + (l * k) // 2
    n0 = pos // l
    phase = pos % l
    idx = n0[:, None] - np.arange(k)[None, :]  # [J, K]
    valid = (idx >= 0) & (idx < t)
    win = x[..., torch.as_tensor(np.clip(idx, 0, t - 1))] * torch.as_tensor(
        valid, dtype=x.dtype, device=x.device)
    return (win * bank.to(x.device)[torch.as_tensor(phase)]).sum(dim=-1)


def resample_to(x, rate_in: int, rate_out: int, *, device,
                **kw) -> torch.Tensor:
    """buffer::resample_snd_file semantics (buffer.cpp:224-330): resample a
    whole impulse or audio buffer [C, T] to the target rate, on
    ``device``."""
    return resample(torch.as_tensor(x).to(resolve_device(device)), rate_in,
                    rate_out, **kw)
