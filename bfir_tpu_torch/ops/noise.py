"""White-noise generation and the headroom (attenuation) probe.

Counterpart of ``bfir_tpu/ops/noise.py``:

- ``buffer::load_white_noise`` (buffer.cpp:454-493): full-scale uniform
  white noise from a seeded generator. Here a seeded ``torch.Generator``
  on the device (the reference: JAX's threefry; the boost generator of the
  plugin differs from both), so the noise agrees with the reference's in
  its statistics only;
- ``preprocessor::calculate_attenuation`` (preprocessor.cpp:249-412): stream
  ``n_blocks`` blocks of full-scale white noise through an offline engine
  instance (here ``core.convolver.process_blocks`` on the device), track
  the peak |output|, and return ``-20 log10(peak)`` dB if the peak exceeds
  1.0, else 0: the level auto-set that fires when an impulse file is
  selected (prefs_file.cpp:155-176, connection.cpp:318-346);
- ``attenuation_bound``: the analytic worst case (the impulse's L1 norm), a
  capability the reference adds beyond the plugin.
"""

from __future__ import annotations

import numpy as np
import torch

from bfir_tpu_torch.core import convolver as cv
from bfir_tpu_torch.core.spec import FilterSpec
from bfir_tpu_torch.utils.device import resolve_device


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def white_noise(n_channels: int, n_samples: int, seed: int = 0, *, dtype,
                device) -> torch.Tensor:
    """Full-scale uniform white noise [C, T] in [-1, 1) on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = torch.rand((n_channels, n_samples), generator=gen,
                   dtype=_torch_dtype(dtype), device=dev)
    return 2.0 * u - 1.0


def _probe_db(h: np.ndarray, noise, block_length: int, dtype: str,
              device) -> float:
    """The probe's body: ``noise`` [C, n_blocks * N] (a tensor or an array)
    through the impulse rows ``h`` [C, taps] as ``n_blocks`` N-blocks of the
    uniform engine; the attenuation in dB (<= 0)."""
    c, taps = h.shape
    n_blocks = max(1, -(-taps // block_length))
    spec = FilterSpec(block_length=block_length, n_partitions=n_blocks,
                      dtype=dtype)
    state = cv.init_state(spec, c, device=device)
    coeffs = cv.coeffs_to_spectra(h, spec, device=device)
    if not torch.is_tensor(noise):
        noise = torch.from_numpy(np.array(noise))
    x = noise.to(device=device, dtype=_torch_dtype(dtype))
    blocks = x.reshape(c, n_blocks, block_length).transpose(0, 1)
    _, out = cv.process_blocks(state, coeffs, blocks)
    peak = float(out.abs().max())
    if peak > 1.0:
        return -20.0 * float(np.log10(peak))
    return 0.0


def calculate_attenuation(impulse, block_length: int = 1024,
                          dtype: str = "float64", seed: int = 0, *,
                          device) -> float:
    """Noise-probe headroom measurement (preprocessor.cpp:249-412).

    impulse: [taps] or [C, taps]. Returns the attenuation in dB (<= 0), the
    gain that keeps full-scale noise from clipping; 0 if none is needed."""
    dev = resolve_device(device)
    h = np.asarray(impulse)
    if h.ndim == 1:
        h = h[None, :]
    c, taps = h.shape
    n_blocks = max(1, -(-taps // block_length))
    noise = white_noise(c, block_length * n_blocks, seed=seed, dtype=dtype,
                        device=dev)
    return _probe_db(h, noise, block_length, dtype, dev)


def attenuation_bound(impulse) -> float:
    """Analytic worst-case headroom: the L1 norm of the impulse bounds |y|
    for any |x| <= 1 input. Stricter than the noise probe (which can
    undershoot on pathological filters)."""
    h = np.asarray(impulse)
    l1 = np.abs(h).sum(axis=-1).max()
    if l1 > 1.0:
        return -20.0 * float(np.log10(l1))
    return 0.0
