"""ctypes bindings for the port's native host codec and stream reblocker.

Counterpart of ``bfir_tpu/native/__init__.py``, with its names (``load``,
``decode_f64``, ``encode_int``, ``encode_float``, ``Reblocker``). The byte
packing of raw PCM (endianness, 24-bit samples in 3 bytes, the padded
``S24_4*`` containers, interleaving) and the plugin's re-block loop
(foo_dsp_bfir.cpp:303-351) run as C++ on the host, from the port's own
``codec.cpp`` beside this file. ``ops.formats.decode`` and
``ops.formats.encode_int`` go through it on every device.

Building: at first use, g++ compiles ``codec.cpp`` alone, with the
reference Makefile's flags, into
``build/bfir_tpu_torch/libbfir_native-<digest>.so`` at the root of the
checkout (git-ignored), the digest taken over the source and the flags.
Each build writes into a temporary directory of its own and moves the
library into place with ``os.replace``, so processes that build at once
never load a half-written file. Importing this module builds nothing.

Departures from the reference:

- a failed build raises ``RuntimeError`` with g++'s output; the
  reference's ``load`` returns None and its ``ops.formats`` falls back to
  numpy;
- a non-zero return code from a C function raises ``RuntimeError``;
  nothing falls back to numpy;
- there is no committed library and no ``available()``;
- sizes are checked before a pointer is passed: a channel count below 1, a
  sample array that is not 2-D or a ``Reblocker.push`` with another
  channel count raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "bfir_tpu_torch")
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


class _FormatDesc(ctypes.Structure):
    _fields_ = [
        ("bytes", ctypes.c_int32),
        ("sbytes", ctypes.c_int32),
        ("is_float", ctypes.c_int32),
        ("big_endian", ctypes.c_int32),
    ]


def _desc(fmt) -> _FormatDesc:
    return _FormatDesc(fmt.bytes, fmt.sbytes, int(fmt.isfloat),
                       int(fmt.big_endian))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def library_path(build_dir: str = BUILD_DIR, cxx: str = CXX) -> str:
    """Path of the library built from ``codec.cpp``, building it into
    ``build_dir`` with the compiler ``cxx`` first if it is missing. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    so = os.path.join(build_dir, f"libbfir_native-{_digest()}.so")
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build_dir)
    try:
        lib = os.path.join(tmp, "lib.so")
        cmd = [cxx, *CXX_FLAGS, "-o", lib, SOURCE]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building the native codec failed: "
                               f"{' '.join(cmd)}: {e}") from e
        if res.returncode:
            raise RuntimeError(
                f"building the native codec failed: {' '.join(cmd)} (exit "
                f"{res.returncode}):\n{(res.stdout + res.stderr)[-4000:]}")
        os.replace(lib, so)  # atomic against a concurrent build
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_FMT = ctypes.POINTER(_FormatDesc)
_SIGNATURES = {  # name -> (argtypes, restype)
    "bfir_decode_f64": ([_P, _P, _I64, _I32, _FMT], ctypes.c_int),
    "bfir_encode_int": ([_P, _P, _I64, _I32, _FMT], ctypes.c_int),
    "bfir_encode_float": ([_P, _P, _I64, _I32, _FMT], ctypes.c_int),
    "bfir_reblocker_new": ([_I64, _I32], _P),
    "bfir_reblocker_free": ([_P], None),
    "bfir_reblocker_fill": ([_P], _I64),
    "bfir_reblocker_reset": ([_P], None),
    "bfir_reblocker_push": ([_P, _P, _I64, _P, _I64], _I64),
}


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The native library, built on first use and bound."""
    lib = ctypes.CDLL(library_path())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _check(rc: int, what: str, fmt) -> None:
    if rc:
        raise RuntimeError(f"native {what} refused {fmt.name} (return code "
                           f"{rc})")


def _check_channels(n_channels: int) -> None:
    if n_channels < 1:
        raise ValueError(f"n_channels must be >= 1, got {n_channels}")


def _planar(a, dtype) -> np.ndarray:
    """A C-contiguous 2-D [C, T] array of ``dtype``."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.ndim != 2:
        raise ValueError(f"expected samples [C, T], got shape {a.shape}")
    _check_channels(a.shape[0])
    return a


def decode_f64(raw, fmt, n_channels: int) -> np.ndarray:
    """Interleaved raw PCM (bytes, bytearray, memoryview or a uint8 array)
    -> planar float64 [C, N] at +-1 full scale. A trailing partial frame is
    dropped."""
    _check_channels(n_channels)
    if isinstance(raw, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(raw, dtype=np.uint8)
    else:
        buf = np.ascontiguousarray(np.asarray(raw, dtype=np.uint8).reshape(-1))
    n_frames = buf.size // (fmt.bytes * n_channels)
    out = np.empty((n_channels, n_frames), dtype=np.float64)
    _check(load().bfir_decode_f64(buf.ctypes.data, out.ctypes.data, n_frames,
                                  n_channels, ctypes.byref(_desc(fmt))),
           "decode", fmt)
    return out


def encode_int(q, fmt) -> bytes:
    """Quantized int32 samples [C, N] -> interleaved raw bytes."""
    q = _planar(q, np.int32)
    c, n = q.shape
    out = np.empty(n * c * fmt.bytes, dtype=np.uint8)
    _check(load().bfir_encode_int(q.ctypes.data, out.ctypes.data, n, c,
                                  ctypes.byref(_desc(fmt))), "encode_int", fmt)
    return out.tobytes()


def encode_float(x, fmt) -> bytes:
    """Float samples [C, N] at +-1 full scale -> interleaved raw bytes."""
    x = _planar(x, np.float64)
    c, n = x.shape
    out = np.empty(n * c * fmt.bytes, dtype=np.uint8)
    _check(load().bfir_encode_float(x.ctypes.data, out.ctypes.data, n, c,
                                    ctypes.byref(_desc(fmt))),
           "encode_float", fmt)
    return out.tobytes()


class Reblocker:
    """Native fixed-block accumulator (foo_dsp_bfir.cpp:303-351)."""

    def __init__(self, block: int, n_channels: int):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        _check_channels(n_channels)
        self._lib = load()
        self.block = block
        self.n_channels = n_channels
        self._h = self._lib.bfir_reblocker_new(block, n_channels)

    def push(self, frames) -> np.ndarray:
        """frames [C, T] float64 -> complete blocks [n_blocks, C, block]."""
        frames = _planar(frames, np.float64)
        c, t = frames.shape
        if c != self.n_channels:
            raise ValueError(f"pushed {c} channels into a reblocker of "
                             f"{self.n_channels}")
        max_blocks = (t + self.fill) // self.block + 1
        out = np.empty((max_blocks, c, self.block), dtype=np.float64)
        n = self._lib.bfir_reblocker_push(self._h, frames.ctypes.data, t,
                                          out.ctypes.data, max_blocks)
        return out[:n]

    @property
    def fill(self) -> int:
        return self._lib.bfir_reblocker_fill(self._h)

    def reset(self) -> None:
        self._lib.bfir_reblocker_reset(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bfir_reblocker_free(self._h)
            self._h = None
