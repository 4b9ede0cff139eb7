"""Offline/bulk rendering engine.

Counterpart of ``bfir_tpu/core/bulk.py``. The streaming engines are shaped
by the one-block latency bound; an offline render has the whole input up
front, so it takes another geometry:

- long float32 filters (>= ``NU_BULK_MIN_TAPS``) run the two-stage
  engine's bulk schedules: on CUDA the G-cycle batched scan
  (``core.nubatch``, G = ``GBATCH_CYCLES``, kernels K7 and K4), on the CPU
  the split-tail scan (``core.nonuniform.process_blocks_nu_split``, kernels
  K1, K5 and K4);
- other filters are re-partitioned at a large block size M and run the
  batched block-axis-FFT formulation (``core.convolver.process_batch``).

Outputs are the exact linear convolution either way, so a bulk render
agrees with the streaming engines' output to float rounding. Each dispatch
takes one host-to-device copy of its input and one copy of its output
back; the state threads through the dispatches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bfir_tpu_torch.core import convolver as cv
from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.core import nubatch as NB
from bfir_tpu_torch.core.spec import FilterSpec


@dataclass(frozen=True)
class BulkSpec:
    """Bulk render geometry: partition/block size M, partition count P at M,
    and the number of M-blocks per batched dispatch."""

    block_length: int
    n_partitions: int
    batch_blocks: int
    dtype: str = "float32"

    @property
    def filter_spec(self) -> FilterSpec:
        return FilterSpec(self.block_length, self.n_partitions, self.dtype)

    @property
    def samples_per_dispatch(self) -> int:
        return self.block_length * self.batch_blocks


def bulk_geometry(taps: int, dtype: str = "float32", max_block: int = 8192,
                  samples_per_dispatch: int = 245760) -> BulkSpec:
    """The offline geometry for a ``taps``-long filter: M the largest power
    of two <= ``max_block`` not much larger than the filter, P covering the
    taps at M, and ~``samples_per_dispatch`` samples (at least 4 blocks)
    per dispatch, the reference's choices."""
    taps = max(1, int(taps))
    m = 1024
    while m < max_block and m < taps:
        m *= 2
    m = min(m, max_block)
    p = max(1, -(-taps // m))
    b = max(4, samples_per_dispatch // m)
    return BulkSpec(m, p, b, dtype)


# Filters this long take the two-stage bulk schedules; below it the head
# alone would cover the filter and the batched form is the engine.
NU_BULK_MIN_TAPS = 65536
GBATCH_CYCLES = 8  # M-cycles per batched-scan iteration (the reference's)
# one nonuniform dispatch: 24 M-cycles, a multiple of GBATCH_CYCLES
_NU_DISPATCH_CYCLES = 24


class BulkRenderer:
    """One-shot offline renderer: exact linear convolution of [C, T] audio
    with a [C, taps] (or [1, taps] shared) impulse at the bulk geometry, on
    ``device``.

    ``store``: the two-stage tail store ("auto" = float32, also for the
    split scan, as the reference). ``nu_engine``: "auto" (gbatch on CUDA
    with a float32 store, split otherwise), "gbatch" or "split"."""

    def __init__(self, impulse, n_channels: int, scale: float = 1.0,
                 dtype: str = "float32", spec: Optional[BulkSpec] = None,
                 store: str = "auto", block_length: int = 1024,
                 nu_engine: str = "auto", *, device):
        impulse = np.atleast_2d(np.asarray(impulse))
        taps = impulse.shape[-1]
        self.n_channels = n_channels
        self.device = torch.device(device)
        self.engine = ("nonuniform"
                       if spec is None and taps >= NU_BULK_MIN_TAPS
                       and dtype == "float32" else "batch")
        if self.engine == "nonuniform":
            if store == "auto":
                store = "float32"
            if nu_engine == "auto":
                nu_engine = ("gbatch" if self.device.type == "cuda"
                             and store == "float32" else "split")
            if nu_engine not in ("gbatch", "split"):
                raise ValueError(f"nu_engine must be auto, gbatch or split, "
                                 f"got {nu_engine!r}")
            if nu_engine == "gbatch" and store != "float32":
                raise ValueError("nu_engine='gbatch' is float-plane only; "
                                 "use store='float32'")
            self.nu_engine = nu_engine
            self.nuspec = NU.nu_geometry(taps, block_length, ratio=8,
                                         dtype=dtype, tail_store=store)
            self.spec = None
            # one filter for every channel: the correlation kernel reads
            # [P, 2, Hp] shared planes for all channels
            shared = (nu_engine == "gbatch" and impulse.shape[0] == 1
                      and n_channels > 1)
            self._co = NU.nu_coeffs(impulse, self.nuspec, n_channels,
                                    scale=scale, shared=shared,
                                    device=self.device)
            return
        self.spec = spec or bulk_geometry(taps, dtype)
        self._co = cv.coeffs_to_spectra(impulse, self.spec.filter_spec,
                                        scale=scale, device=self.device)
        self._hs = cv.prepare_batch_coeffs(self._co, self.spec.batch_blocks)

    @property
    def samples_per_dispatch(self) -> int:
        if self.engine == "nonuniform":
            return (_NU_DISPATCH_CYCLES * self.nuspec.ratio
                    * self.nuspec.block_length)
        return self.spec.samples_per_dispatch

    def _init_state(self, c: int):
        if self.engine == "batch":
            return cv.init_state(self.spec.filter_spec, c, device=self.device)
        if self.nu_engine == "gbatch":
            return NU.init_nu_state(self.nuspec, c, device=self.device)
        return NU.init_nu_split_state(self.nuspec, c, device=self.device)

    def _dispatch(self, state, blocks):
        if self.engine == "batch":
            return cv.process_batch(state, self._co, blocks,
                                    coeff_batch_fft=self._hs)
        if self.nu_engine == "gbatch":
            return NB.process_blocks_nu_gbatch(state, self._co, blocks,
                                               cycles_per_step=GBATCH_CYCLES)
        return NU.process_blocks_nu_split(state, self._co, blocks)

    def render(self, x) -> np.ndarray:
        """Filter [C, T] -> [C, T] (exact convolution, first T samples).

        The input is cut into fixed-size dispatches (the last zero-padded)
        and the output cut back to T; the state threads through the
        dispatches, so the result is the one linear convolution the
        streaming engines produce."""
        x = np.atleast_2d(np.asarray(x))
        c, t = x.shape
        if c != self.n_channels:
            raise ValueError(f"expected {self.n_channels} channels, got {c}")
        spec = self.nuspec if self.engine == "nonuniform" else self.spec
        width = spec.block_length
        step = self.samples_per_dispatch
        n_disp = -(-max(t, 1) // step)
        xp = np.zeros((c, n_disp * step), dtype=spec.dtype)
        xp[:, :t] = x
        state = self._init_state(c)
        outs = []
        for i in range(n_disp):
            chunk = torch.from_numpy(xp[:, i * step:(i + 1) * step])
            blocks = (chunk.to(self.device).reshape(c, step // width, width)
                      .transpose(0, 1).contiguous())
            state, out = self._dispatch(state, blocks)
            outs.append(out.transpose(0, 1).reshape(c, step).cpu().numpy())
        return np.concatenate(outs, axis=1)[:, :t]
