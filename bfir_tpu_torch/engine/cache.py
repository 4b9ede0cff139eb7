"""Hash-keyed derived-artifact cache.

Replaces ``brutefir/bfir_path.{cpp,hpp}`` + the reference's pervasive
derived-artifact caching (SURVEY.md §5 "Checkpoint/resume"):

- profile dir with ``~`` expansion        -> bfir_path.cpp:15-110
  (default ``~\\brutefir``, bfir_path.hpp:16; here ``~/.bfir_tpu``)
- temp subdir wiped on shutdown           -> bfir_path.cpp:153-181,
  foo_dsp_bfir.cpp:69
- cache filename schemes                  -> ``eq-<hash>-...`` (equalizer.cpp:
  152-180), ``ir-<hash>-<ch>-<rate>.wav`` (buffer.cpp:243-253),
  ``file-<hash>-...`` (preprocessor.cpp:89-98), DJB hashes of the params

The FFTW wisdom files (fftw_convolver.cpp:81-137) have no equivalent here:
XLA's compilation cache plays that role.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np

from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.utils.hashing import djb_hash

DEFAULT_DIR = "~/.bfir_tpu"


class ArtifactCache:
    def __init__(self, base_dir: Optional[str] = None):
        self.base = Path(os.path.expanduser(base_dir or DEFAULT_DIR))
        self.temp = self.base / "temp"
        self.base.mkdir(parents=True, exist_ok=True)
        self.temp.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> str:
        """bfir_path::append_path equivalent."""
        return str(self.base / name)

    def temp_path(self, name: str) -> str:
        """bfir_path::append_temp_path equivalent."""
        return str(self.temp / name)

    def clean_temp(self) -> None:
        """Wipe the temp subdir (bfir_path::clean_path, bfir_path.cpp:153-181)."""
        if self.temp.exists():
            shutil.rmtree(self.temp, ignore_errors=True)
        self.temp.mkdir(parents=True, exist_ok=True)

    # -- cache key schemes ---------------------------------------------------

    def eq_filename(self, band_freqs, band_mags_db, band_phases, taps_half: int,
                    realsize: int, n_channels: int, rate: int) -> str:
        """``eq-<djbhash>-<taps/2>-<realsize>-<ch>-<rate>.wav``
        (equalizer::make_filename, equalizer.cpp:152-180: hash over the raw
        band doubles)."""
        data = (
            np.asarray(band_freqs, dtype="<f8").tobytes()
            + np.asarray(band_mags_db, dtype="<f8").tobytes()
            + np.asarray(band_phases, dtype="<f8").tobytes()
        )
        h = djb_hash(data)
        return self.temp_path(f"eq-{h:x}-{taps_half}-{realsize}-{n_channels}-{rate}.wav")

    def resampled_filename(self, src_path: str, n_channels: int, rate: int) -> str:
        """``ir-<djbhash(filename)>-<ch>-<rate>.wav`` (buffer.cpp:243-253)."""
        h = djb_hash(str(src_path).encode("utf-8", "surrogatepass"))
        return self.temp_path(f"ir-{h:x}-{n_channels}-{rate}.wav")

    def preconvolved_filename(self, filenames, n_frames: int, realsize: int,
                              n_channels: int, rate: int) -> str:
        """``file-<djbhash(concat names)>-<frames>-<realsize>-<ch>-<rate>.wav``
        (preprocessor.cpp:89-98)."""
        h = djb_hash("".join(str(f) for f in filenames).encode("utf-8", "surrogatepass"))
        return self.temp_path(f"file-{h:x}-{n_frames}-{realsize}-{n_channels}-{rate}.wav")

    # -- load/store helpers --------------------------------------------------

    def get_or_render_wav(self, path: str, render_fn, sample_rate: int,
                          subtype: str = "float64"):
        """Return audio [frames, ch] from ``path``; render + save on miss
        (the render-if-missing pattern of equalizer.cpp:127-137 etc.)."""
        if os.path.exists(path):
            audio, _ = wavio.read(path)
            return audio
        audio = np.asarray(render_fn())
        wavio.write(path, audio, sample_rate, subtype=subtype)
        return audio
