"""The plain reference: linear convolution in NumPy float64.

It imports NumPy alone: nothing of the program, of JAX or of the JAX
package. It takes the impulse and the input that the benchmark made, never
anything the program derived from them, and works out one segment of the
output at a time (an FFT of the segment's history, channels in groups), so
that it fits in the host's memory at any stream length.
"""

from __future__ import annotations

import numpy as np

ROWS = 8  # channels transformed together


class Reference:
    """y[c, t] = sum_k h[c, k] x[c, t - k] for an impulse h [C, T]."""

    def __init__(self, impulse: np.ndarray):
        self.h = np.asarray(impulse, dtype=np.float32).astype(np.float64)
        self._spectra = {}

    @property
    def taps(self) -> int:
        return self.h.shape[1]

    def _spectrum(self, nfft: int) -> np.ndarray:
        if nfft not in self._spectra:
            self._spectra = {nfft: np.fft.rfft(self.h, nfft)}
        return self._spectra[nfft]

    def segment(self, history: np.ndarray) -> np.ndarray:
        """The outputs [C, n] whose inputs end ``history`` [C, T - 1 + n]:
        output j takes inputs j .. j + T - 1 of ``history``."""
        x = np.asarray(history, dtype=np.float32)
        c, length = x.shape
        n = length - (self.taps - 1)
        if c != self.h.shape[0] or n < 1:
            raise ValueError(f"history {x.shape} for an impulse "
                             f"{self.h.shape}")
        # a circular convolution of at least the history's length wraps
        # nothing into outputs T - 1 and on
        nfft = 1 << (length - 1).bit_length()
        spec = self._spectrum(nfft)
        y = np.empty((c, n), dtype=np.float64)
        for r in range(0, c, ROWS):
            xs = np.fft.rfft(x[r:r + ROWS].astype(np.float64), nfft)
            y[r:r + ROWS] = np.fft.irfft(xs * spec[r:r + ROWS], nfft)[
                :, self.taps - 1:length]
        return y
