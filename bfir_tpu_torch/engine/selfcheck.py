"""Known-answer self-check of an engine's step, with a verdict cache.

Counterpart of ``bfir_tpu/engine/selfcheck.py``: at coefficient build time,
stream seeded noise through the exact step callable and coefficient tensors
production will use, and compare every channel against a scipy float64
oracle; raise ``EngineSelfCheckError`` below the bound. The verdict cache
keeps the reference's file format and failure expiry; its key covers the
port's stack instead: torch, its CUDA build, the device's name, and the
port's kernel, core and ops sources.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from bfir_tpu_torch.core.spec import FilterSpec
from bfir_tpu_torch.utils.hashing import backend_fingerprint
from bfir_tpu_torch.utils.logging import pinfo

# float32 partitioned convolution measures ~130 dB against the float64
# oracle; a broken kernel is O(1) wrong. 80 dB splits those regimes with
# margin on both sides.
DEFAULT_MIN_SNR_DB = 80.0

# a cached failure expires after a day, so a transient fault cannot refuse
# an engine for good; passes never expire (a stale pass changes the key)
FAILURE_TTL_S = 24 * 3600.0


class EngineSelfCheckError(RuntimeError):
    """An engine failed its known-answer check."""


@functools.lru_cache(maxsize=1)
def _source_fingerprint() -> str:
    """Hash of the port's compute-path sources (kernels, csrc, core, ops)."""
    import bfir_tpu_torch

    root = os.path.dirname(os.path.abspath(bfir_tpu_torch.__file__))
    h = hashlib.sha256()
    for sub in ("kernels", "csrc", "core", "ops"):
        d = os.path.join(root, sub)
        for name in sorted(os.listdir(d)):
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(d, name), "rb") as f:
                    h.update(name.encode())
                    h.update(f.read())
    return h.hexdigest()


def cache_key(impl: str, impulse: np.ndarray, spec: FilterSpec,
              n_channels: int, n_blocks: int, min_snr_db: float,
              device: torch.device, extra: str = "") -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(impulse, dtype=np.float64)).tobytes())
    h.update(repr((impl, spec, n_channels, n_blocks, round(min_snr_db, 3),
                   extra, impulse.shape)).encode())
    h.update(backend_fingerprint(device).encode())
    h.update(_source_fingerprint().encode())
    return h.hexdigest()[:24]


def load_verdict(cache_file: Optional[str], key: str):
    """The cached {"snr": float, "ok": bool} verdict, or None. Failed
    verdicts older than ``FAILURE_TTL_S`` count as absent."""
    if not cache_file or not os.path.exists(cache_file):
        return None
    try:
        with open(cache_file) as f:
            verdict = json.load(f).get(key)
    except (OSError, ValueError, AttributeError):
        return None
    if verdict is not None and not verdict.get("ok", False):
        if time.time() - float(verdict.get("t", 0.0)) > FAILURE_TTL_S:
            return None
    return verdict


def store_verdict(cache_file: Optional[str], key: str, snr: float,
                  ok: bool) -> None:
    if not cache_file:
        return
    try:
        data = {}
        if os.path.exists(cache_file):
            with open(cache_file) as f:
                data = json.load(f)
        data[key] = {"snr": float(snr), "ok": bool(ok), "t": time.time()}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(cache_file) or ".")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f)
        os.replace(tmp, cache_file)  # atomic against concurrent sessions
    except (OSError, ValueError) as e:  # a cache fault never breaks the engine
        pinfo("Self-check verdict cache write failed (%s).", e)


def _oracle(x: np.ndarray, impulse: np.ndarray) -> np.ndarray:
    """Per-channel linear convolution in float64 (scipy), cut to the
    stream length. impulse: [C, taps] or [1, taps] (broadcast)."""
    from scipy import signal

    c, t = x.shape
    h = np.atleast_2d(np.asarray(impulse, dtype=np.float64))
    ref = np.empty((c, t), dtype=np.float64)
    for ch in range(c):
        hh = h[0] if h.shape[0] == 1 else h[ch]
        ref[ch] = signal.fftconvolve(x[ch].astype(np.float64), hh)[:t]
    return ref


def _worst_snr_db(y: np.ndarray, ref: np.ndarray) -> float:
    """Minimum per-channel SNR: one wrong channel must not hide behind good
    ones."""
    worst = np.inf
    for ch in range(y.shape[0]):
        sig = float((ref[ch] ** 2).sum())
        err = float(((y[ch] - ref[ch]) ** 2).sum())
        worst = min(worst, 10 * np.log10(max(sig, 1e-300) / max(err, 1e-300)))
    return worst


def _stream(step_call, init_state, coeffs, x: np.ndarray, n: int,
            device) -> np.ndarray:
    state = init_state()
    outs = []
    for b in range(x.shape[1] // n):
        blk = torch.from_numpy(np.ascontiguousarray(x[:, b * n:(b + 1) * n]))
        state, out = step_call(state, coeffs, blk.to(device))
        outs.append(out.cpu().numpy())
    return np.concatenate(outs, axis=1).astype(np.float64)


def check_stream(step_call: Callable, init_state: Callable, coeffs,
                 impulse: np.ndarray, spec: FilterSpec, n_channels: int, *,
                 device, n_blocks: int = 3,
                 min_snr_db: float = DEFAULT_MIN_SNR_DB, label: str = "step",
                 cache_file: Optional[str] = None,
                 cache_extra: str = "") -> float:
    """Run ``n_blocks`` of seeded noise through ``step_call(state, coeffs,
    block)`` on ``device`` and compare with scipy. Returns the worst-channel
    SNR in dB; raises ``EngineSelfCheckError`` below ``min_snr_db``.
    ``impulse`` is the scaled impulse the coefficients were built from. A
    cached pass for the same key still gets a 2-block spot check."""

    def _refuse(snr):
        raise EngineSelfCheckError(
            f"known-answer check FAILED for {label}: worst-channel SNR "
            f"{snr:.1f} dB < {min_snr_db:.0f} dB (geometry: C={n_channels}, "
            f"N={spec.block_length}, P={spec.n_partitions}, {spec.dtype}, "
            f"device {device})")

    n = spec.block_length
    key = None
    if cache_file:
        key = cache_key(label, np.atleast_2d(impulse), spec, n_channels,
                        n_blocks, min_snr_db, device, extra=cache_extra)
        verdict = load_verdict(cache_file, key)
        if verdict is not None:
            if not verdict["ok"]:
                _refuse(verdict["snr"])
            rng = np.random.default_rng(0x5B07)
            x = rng.standard_normal((n_channels, 2 * n)).astype(spec.dtype)
            spot = _worst_snr_db(
                _stream(step_call, init_state, coeffs, x, n, device),
                _oracle(x, impulse))
            if np.isfinite(spot) and spot >= min_snr_db:
                pinfo("Self-check (%s): cached pass, worst-channel SNR "
                      "%.1f dB (spot check %.1f dB).", label, verdict["snr"],
                      spot)
                return float(verdict["snr"])
            pinfo("Self-check (%s): cached pass CONTRADICTED by the spot "
                  "check (%.1f dB) — rerunning the full check.", label, spot)
    rng = np.random.default_rng(0xB51C)
    x = rng.standard_normal((n_channels, n_blocks * n)).astype(spec.dtype)
    snr = _worst_snr_db(_stream(step_call, init_state, coeffs, x, n, device),
                        _oracle(x, impulse))
    ok = bool(np.isfinite(snr) and snr >= min_snr_db)
    if key is not None:
        store_verdict(cache_file, key, snr, ok)
    if not ok:
        _refuse(snr)
    pinfo("Self-check (%s): worst-channel SNR %.1f dB.", label, snr)
    return snr
