"""Mutable config store behind the control plane.

Counterpart of ``bfir_tpu/cli/store.py``; the attenuation probe that a new
impulse file triggers runs on the store's explicit ``device``.

The plugin mutates foobar2000 ``cfg_*`` globals directly from the CLI
thread (connection.cpp:66-672) and the running DSP only notices at the next
re-init. Here the store holds an immutable ``EngineConfig`` snapshot plus the
three file-metadata strings (``cfg_fileN_metadata``, common.h:77-79), applies
the protocol's clamping semantics, and notifies a listener (e.g.
``StreamProcessor.reconfigure``) after every successful mutation — changes
take effect at the next block boundary instead of the next format change.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Optional

from bfir_tpu_torch.core.spec import (
    LEVEL_RANGE_MAX,
    LEVEL_RANGE_MIN,
    LEVEL_STEPS_PER_DB,
    EngineConfig,
    N_EQ_BANDS,
)
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.ops.noise import calculate_attenuation
from bfir_tpu_torch.utils.device import resolve_device
from bfir_tpu_torch.utils.logging import pinfo


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, v))


class ConfigStore:
    def __init__(self, config: Optional[EngineConfig] = None,
                 on_change: Optional[Callable[[EngineConfig], None]] = None,
                 *, device):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._config = config or EngineConfig()
        self._metadata = ["", "", ""]
        self._on_change = on_change
        self._listeners = []  # extra callbacks (e.g. audio-server sessions)

    @property
    def config(self) -> EngineConfig:
        with self._lock:
            return self._config

    def add_listener(self, cb: Callable[[EngineConfig], None]) -> None:
        """Register an additional change callback (cli.audio_server wires
        one per streaming session so live control changes crossfade into
        every running stream)."""
        with self._lock:
            self._listeners.append(cb)

    def remove_listener(self, cb) -> None:
        with self._lock:
            if cb in self._listeners:
                self._listeners.remove(cb)

    def _mutate(self, fn):
        """Apply ``fn(config) -> new_config`` atomically: the read, the
        modification, and the swap all happen under the lock so concurrent
        mutators cannot lose each other's updates (the reference has exactly
        this race on its cfg_* globals — SURVEY.md §5). The change callbacks
        fire outside the lock."""
        with self._lock:
            self._config = fn(self._config)
            cfg = self._config
            listeners = list(self._listeners)
        if self._on_change:
            self._on_change(cfg)
        for cb in listeners:
            try:
                cb(cfg)
            except Exception as e:  # a dead session must not break control
                pinfo("Config listener failed (%s).", e)

    # -- EQ -----------------------------------------------------------------

    def get_eq_mag(self, band: int) -> int:
        band = _clamp(band, 0, N_EQ_BANDS - 1)
        return self.config.chain.eq.mag_steps[band]

    def set_eq_mag(self, band: int, val: int) -> None:
        band = _clamp(band, 0, N_EQ_BANDS - 1)  # connection.cpp:86-87
        val = _clamp(val, LEVEL_RANGE_MIN, LEVEL_RANGE_MAX)

        def fn(c):
            mags = list(c.chain.eq.mag_steps)
            mags[band] = val
            eq = dataclasses.replace(c.chain.eq, mag_steps=tuple(mags))
            return dataclasses.replace(c, chain=dataclasses.replace(c.chain, eq=eq))

        self._mutate(fn)

    def get_eq_enable(self) -> int:
        return int(self.config.chain.eq.enabled)

    def set_eq_enable(self, val: int) -> None:
        self._mutate(lambda c: dataclasses.replace(c, chain=dataclasses.replace(
            c.chain, eq=dataclasses.replace(c.chain.eq, enabled=bool(_clamp(val, 0, 1))))))

    def get_eq_level(self) -> int:
        return self.config.chain.eq.level_steps

    def set_eq_level(self, val: int) -> None:
        v = _clamp(val, LEVEL_RANGE_MIN, LEVEL_RANGE_MAX)
        self._mutate(lambda c: dataclasses.replace(c, chain=dataclasses.replace(
            c.chain, eq=dataclasses.replace(c.chain.eq, level_steps=v))))

    # -- impulse file slots (1-based index like F1/F2/F3) --------------------

    def _file(self, idx: int):
        return self.config.chain.files[idx - 1]

    def _set_file(self, idx: int, **fields) -> None:
        def fn(c):
            files = list(c.chain.files)
            files[idx - 1] = dataclasses.replace(files[idx - 1], **fields)
            return dataclasses.replace(
                c, chain=dataclasses.replace(c.chain, files=tuple(files)))

        self._mutate(fn)

    def get_file_enable(self, idx: int) -> int:
        return int(self._file(idx).enabled)

    def set_file_enable(self, idx: int, val: int) -> None:
        self._set_file(idx, enabled=bool(_clamp(val, 0, 1)))

    def get_file_level(self, idx: int) -> int:
        return self._file(idx).level_steps

    def set_file_level(self, idx: int, val: int) -> None:
        self._set_file(idx, level_steps=_clamp(val, LEVEL_RANGE_MIN, LEVEL_RANGE_MAX))

    def get_file_name(self, idx: int) -> str:
        return self._file(idx).filename or ""

    def clear_file(self, idx: int) -> None:
        """FxFN '?' (connection.cpp:308-317): clear filename/metadata, reset
        level, disable."""
        self._metadata[idx - 1] = ""
        self._set_file(idx, filename=None, level_steps=0, enabled=False)

    def set_file_name(self, idx: int, path: str) -> bool:
        """FxFN <path> (connection.cpp:318-346): probe attenuation, record
        metadata, auto-set level, enable; the probe runs on ``device``.
        Returns False if the file is unusable (-> ERR)."""
        if not os.path.isfile(path):
            return False
        try:
            info = wavio.read_info(path)
            audio, _ = wavio.read(path)
        except Exception:
            return False
        att = calculate_attenuation(
            audio.T, block_length=self.config.filter.block_length,
            dtype=self.config.filter.dtype, device=self.device)
        self._metadata[idx - 1] = (
            f"{info.n_frames} samples, {info.n_channels} channels, "
            f"{info.sample_rate} Hz"
        )
        self._set_file(
            idx,
            filename=path,
            level_steps=int(att * LEVEL_STEPS_PER_DB),
            enabled=True,
        )
        return True

    def get_file_metadata(self, idx: int) -> str:
        return self._metadata[idx - 1]
