"""Filter-chain composition: EQ + impulse files -> one impulse response.

Counterpart of ``bfir_tpu/engine/chain.py`` (foo_dsp_bfir.cpp:140-300,
preprocessor.cpp:33-233), with the same cache file schemes and the same
scale semantics (every impulse's level is applied). Chain building is
build-time work: it runs in float64 on the CPU whatever device the stream
uses, and only the finished coefficient planes move to the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from bfir_tpu_torch.core.convolver import direct_convolve_spectra
from bfir_tpu_torch.core.spec import (ChainSpec, EngineConfig, FilterSpec,
                                      StreamSpec)
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.io import sndio, wavio
from bfir_tpu_torch.ops.equalizer import ISO_BANDS, render_fir
from bfir_tpu_torch.ops.resample import resample
from bfir_tpu_torch.utils.logging import pinfo


@dataclass
class BuiltChain:
    """The composed impulse [C, taps] (None: chain inactive, the stream
    passes through), the scale to fold into the coefficients, and the
    partition count the impulse length implies."""

    impulse: Optional[np.ndarray]
    scale: float
    n_partitions: int


def _load_impulse_file(f, stream: StreamSpec,
                       cache: ArtifactCache) -> Optional[np.ndarray]:
    """One impulse slot: channel/rate check, cached resample when the file's
    flag allows it, else dropped (foo_dsp_bfir.cpp:177-247)."""
    if not f.filename or not os.path.exists(f.filename):
        pinfo("Impulse file missing: %s", f.filename)
        return None
    info = sndio.read_info(f.filename)
    if info.n_channels not in (1, stream.n_channels):
        pinfo("Impulse channel mismatch (%d vs %d): %s",
              info.n_channels, stream.n_channels, f.filename)
        return None
    if info.sample_rate != stream.sample_rate:
        if not f.resample:
            pinfo("Impulse rate mismatch without resample flag: %s", f.filename)
            return None
        cached = cache.resampled_filename(f.filename, stream.n_channels,
                                          stream.sample_rate)
        if os.path.exists(cached):
            audio, _ = wavio.read(cached)
        else:
            audio, src_rate = sndio.read(f.filename)
            audio = resample(audio.T, src_rate, stream.sample_rate,
                             dtype=torch.float64).numpy().T
            # the reference caches resampled impulses as float32 WAV
            wavio.write(cached, audio, stream.sample_rate, subtype="float32")
    else:
        audio, _ = sndio.read(f.filename)
    imp = audio.T  # [C, taps]
    if imp.shape[0] == 1 and stream.n_channels > 1:
        imp = np.repeat(imp, stream.n_channels, axis=0)
    return imp


def build_chain(config: EngineConfig, stream: StreamSpec,
                cache: Optional[ArtifactCache] = None) -> BuiltChain:
    """Compose the configured chain for this stream format. Returns
    impulse=None when nothing is enabled (foo_dsp_bfir.cpp:352-357)."""
    cache = cache or ArtifactCache()
    chain: ChainSpec = config.chain
    fspec: FilterSpec = config.filter
    realsize = 4 if fspec.dtype == "float32" else 8
    impulses: List[Tuple[np.ndarray, float]] = []

    if chain.eq.enabled:
        taps = fspec.block_length * config.eq_filter_blocks
        eq_path = cache.eq_filename(
            ISO_BANDS, chain.eq.mag_db, [0.0] * len(ISO_BANDS),
            taps // 2, realsize, stream.n_channels, stream.sample_rate)
        audio = cache.get_or_render_wav(
            eq_path,
            lambda: np.repeat(
                render_fir(taps, chain.eq.mag_db, stream.sample_rate)
                .numpy()[:, None], stream.n_channels, axis=1),
            stream.sample_rate,
            subtype="float32" if realsize == 4 else "float64")
        impulses.append((audio.T, chain.eq.level_linear))

    for f in chain.files:
        if f.enabled and f.filename:
            imp = _load_impulse_file(f, stream, cache)
            if imp is not None:
                impulses.append((imp, f.level_linear))

    if not impulses:
        return BuiltChain(impulse=None, scale=1.0, n_partitions=1)
    if len(impulses) == 1:
        imp, scale = impulses[0]
    else:
        # direct spectral multiplication, truncated to the longest
        # constituent (preprocessor.cpp:85,196-201)
        max_len = max(i.shape[1] for i, _ in impulses)
        acc = impulses[0][0] * impulses[0][1]
        for nxt, s in impulses[1:]:
            acc = direct_convolve_spectra(acc, nxt * s,
                                          max_taps=max_len).numpy()
        imp, scale = acc[:, :max_len], 1.0
    n_partitions = max(1, -(-imp.shape[1] // fspec.block_length))
    return BuiltChain(impulse=imp, scale=scale, n_partitions=n_partitions)
