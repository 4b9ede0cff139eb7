"""Integer and fractional (subsample) delay lines.

Counterpart of ``bfir_tpu/ops/delay.py`` (reference ``delay.{cpp,hpp}``):

- integer delays with runtime changes (``delay_allocate_buffer``,
  ``update_delay_buffer``, ``change_delay``, delay.cpp:56-140, 495-600): a
  [C, Dmax] history of the last input samples and a per-channel gather;
  changing a delay is changing the delay vector;
- subsample delays through a bank of Kaiser-windowed sinc interpolators
  (``subsample_init`` / ``sample_sinc``, delay.cpp:182-306), built on the
  host in float64 and applied as a dot product over gathered windows.

The reference port's two documented divergences hold here too: the
``beta`` argument is honoured (``sample_sinc`` hardcodes 9, the default),
and the fractional-offset Kaiser window is applied once (firwindow.c
applies it twice). Plain PyTorch on the tensors' device; no kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from bfir_tpu_torch.ops.firwindow import window_positions


class DelayState(NamedTuple):
    """history: [C, Dmax], the last Dmax input samples per channel (newest
    at the right edge)."""

    history: torch.Tensor


def init_delay_state(n_channels: int, max_delay: int, dtype=torch.float32, *,
                     device) -> DelayState:
    return DelayState(history=torch.zeros((n_channels, max_delay),
                                          dtype=dtype, device=device))


def apply_delay(state: DelayState, block: torch.Tensor,
                delays: torch.Tensor) -> Tuple[DelayState, torch.Tensor]:
    """Delay each channel of ``block`` [C, N] by ``delays`` [C] samples
    (0 <= delay <= Dmax); the delays may change from one call to the next
    (change_delay, delay.cpp:552-600)."""
    n = block.shape[1]
    dmax = state.history.shape[1]
    ext = torch.cat([state.history, block.to(state.history.dtype)], dim=1)
    # out[c, t] = ext[c, Dmax + t - d_c]
    idx = (torch.arange(n, device=ext.device)[None, :]
           + (dmax - delays.to(ext.device, torch.int64))[:, None])
    out = torch.gather(ext, 1, idx)
    new_hist = ext[:, ext.shape[1] - dmax:] if dmax > 0 else state.history
    return DelayState(history=new_hist), out


def sinc_interp_bank(step_count: int, half_length: int, beta: float = 9.0,
                     dtype=np.float64) -> np.ndarray:
    """Fractional-delay filters for offsets s / step_count, s in
    [-(S-1), S-1] (delay.cpp:222-265) -> [2*step_count - 1,
    2*half_length + 1], row s + step_count - 1; the s = 0 row is the exact
    dirac (delay.cpp:236-247)."""
    if step_count < 2 or half_length < 1:
        raise ValueError("step_count >= 2 and half_length >= 1 required")
    length = 2 * half_length + 1
    bank = np.zeros((2 * step_count - 1, length), dtype=np.float64)
    n = np.arange(length)
    for s in range(-(step_count - 1), step_count):
        row = s + step_count - 1
        if s == 0:
            bank[row, half_length] = 1.0
            continue
        offset = s / step_count
        x = np.pi * ((n - half_length) - offset)
        h = np.where(x == 0.0, 1.0, np.sin(x) / np.where(x == 0, 1.0, x))
        w = window_positions(length, offset)
        win = np.i0(beta * np.sqrt(1.0 - w * w)) / np.i0(beta)
        bank[row] = h * win
    return bank.astype(dtype)


class FractionalDelayLine:
    """Streaming fractional delay: the integer part through the history
    gather, the fractional part through the sinc bank (the reference
    applies the bank with its time-domain convolver, delay.cpp:148-180).
    The bank's causal span adds ``half_length`` samples of latency."""

    def __init__(self, n_channels: int, max_delay: int, step_count: int = 16,
                 half_length: int = 16, beta: float = 9.0,
                 dtype=torch.float32, *, device):
        self.step_count = step_count
        self.half_length = half_length
        self.bank = torch.from_numpy(
            sinc_interp_bank(step_count, half_length, beta)).to(device, dtype)
        self.length = 2 * half_length + 1
        self.n_channels = n_channels
        self.dmax = max_delay + self.length  # integer delay + filter span
        self.dtype = dtype
        self.device = torch.device(device)

    def init_state(self) -> DelayState:
        return init_delay_state(self.n_channels, self.dmax, self.dtype,
                                device=self.device)

    # samples per gathered window set: bounds the [C, n, 2 * half_length + 1]
    # windows of a long call
    CHUNK = 8192

    def __call__(self, state: DelayState, block: torch.Tensor,
                 delays_int: torch.Tensor, substeps: torch.Tensor
                 ) -> Tuple[DelayState, torch.Tensor]:
        """Delay ``block`` [C, n], any n: delays_int [C] integer sample
        delays; substeps [C] in [-(step_count-1), step_count-1]: a
        fractional delay of substep / step_count samples (subsample_update's
        sign convention, delay.cpp:148-180)."""
        outs = []
        for part in block.split(self.CHUNK, dim=1):
            state, y = self._chunk(state, part, delays_int, substeps)
            outs.append(y)
        return state, outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def _chunk(self, state, block, delays_int, substeps):
        c, n = block.shape
        hist = state.history.shape[1]
        ext = torch.cat([state.history, block.to(self.dtype)], dim=1)
        dev = ext.device
        # the window of output t starts at base + t and spans the filter;
        # the total shift is delays_int + half_length, so it stays causal
        base = hist - delays_int.to(dev, torch.int64) - self.length + 1
        k_idx = (torch.arange(n, device=dev)[None, :, None] + base[:, None, None]
                 + torch.arange(self.length, device=dev)[None, None, :])
        win = torch.gather(ext, 1, k_idx.reshape(c, -1)).reshape(
            c, n, self.length)
        coefs = self.bank[substeps.to(dev, torch.int64) + self.step_count - 1]
        out = torch.einsum("cnk,ck->cn", win, coefs.flip(-1))
        return DelayState(history=ext[:, ext.shape[1] - hist:]), out
