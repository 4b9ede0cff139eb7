"""The seeded inputs: the impulse, the input audio, and the impulse file.

Everything is drawn from ``--seed`` with a ``torch.Generator`` on the
run's device, in a few large calls, and copied to the host once: the same
seed on the same device gives the same inputs. The impulse follows the law
of a decaying-noise room response (``impulse``); the input is white noise
at a fixed level. The program gets the impulse as a float32 WAV that
``write_wav`` writes here (not the program's writer) and the audio as the
host arrays; the reference gets the same arrays.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np
import torch


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 32-bit seeds from ``seed`` (any whole number)."""
    state = np.random.SeedSequence(abs(int(seed))).generate_state(n)
    return [int(s) for s in state]


def noise(seed: int, shape, device) -> torch.Tensor:
    """Standard normal float32 noise of ``shape`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def impulse(seed: int, rows: int, taps: int, tau: float, scale: float,
            device) -> np.ndarray:
    """A decaying-noise room response [rows, taps], float32: noise times
    exp(-t / tau) (tau in samples), each row scaled to energy
    ``scale`` ** 2 (the law of the smoke test's impulse)."""
    h = noise(seed, (rows, taps), device)
    h *= torch.exp(-torch.arange(taps, device=device, dtype=torch.float32)
                   / tau)
    h *= scale / h.square().sum(dim=1, keepdim=True).sqrt()
    return h.cpu().numpy()


def audio(seed: int, shape, level: float, device) -> np.ndarray:
    """White noise of RMS ``level`` (full scale 1), float32, on the host."""
    return (noise(seed, shape, device) * level).cpu().numpy()


def write_wav(path: str, rows: np.ndarray, rate: int) -> None:
    """``rows`` [channels, frames] as an IEEE-float 32-bit WAV."""
    payload = np.ascontiguousarray(rows.T, dtype="<f4").tobytes()
    ch = rows.shape[0]
    fmt = struct.pack("<HHIIHH", 3, ch, rate, rate * ch * 4, ch * 4, 32)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"fact" + struct.pack("<II", 4, rows.shape[1])
            + b"data" + struct.pack("<I", len(payload)))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body) + len(payload)))
        f.write(body)
        f.write(payload)


class Pool:
    """A stream made of ``chunks`` [n, C, F] played in a loop from frame 0:
    frame t is ``chunks[(t // F) % n][:, t % F]``, and silence before 0."""

    def __init__(self, chunks: np.ndarray):
        self.chunks = chunks

    @property
    def chunk_frames(self) -> int:
        return self.chunks.shape[2]

    def chunk(self, i: int) -> np.ndarray:
        return self.chunks[i % self.chunks.shape[0]]

    def frames(self, a: int, b: int) -> np.ndarray:
        """Frames [a, b) of the stream, [C, b - a] float32."""
        n, c, f = self.chunks.shape
        out = np.zeros((c, b - a), dtype=np.float32)
        t = max(a, 0)
        while t < b:
            k, off = divmod(t, f)
            take = min(f - off, b - t)
            out[:, t - a:t - a + take] = self.chunks[k % n][:, off:off + take]
            t += take
        return out
