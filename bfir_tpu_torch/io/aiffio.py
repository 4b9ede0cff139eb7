"""AIFF / AIFF-C reader (pure numpy).

The reference accepts AIFF impulse files through libsndfile
(brutefir/buffer.cpp:37-139); this covers the same surface
natively: PCM 8/16/24/32-bit big-endian ('NONE'), little-endian ('sowt'),
and AIFF-C float32/float64 ('fl32'/'FL32'/'fl64'/'FL64').
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


class AiffError(ValueError):
    pass


def _read_extended80(b: bytes) -> float:
    """80-bit IEEE 754 extended float (the COMM sample-rate field)."""
    (se,) = struct.unpack(">H", b[:2])
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    mant = int.from_bytes(b[2:10], "big")
    if exp == 0 and mant == 0:
        return 0.0
    return sign * mant * 2.0 ** (exp - 16383 - 63)


def _chunks(data: bytes):
    if len(data) < 12 or data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise AiffError("not an AIFF/AIFC file")
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        yield cid, data[pos + 8 : pos + 8 + size]
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def read_info(path: str) -> Tuple[int, int, int, str]:
    """(n_channels, sample_rate, n_frames, compression)."""
    with open(path, "rb") as f:
        data = f.read()
    for cid, body in _chunks(data):
        if cid == b"COMM":
            ch, frames, bits = struct.unpack(">hIh", body[:8])
            rate = int(round(_read_extended80(body[8:18])))
            comp = body[18:22].decode("latin1") if len(body) >= 22 else "NONE"
            return ch, rate, frames, comp
    raise AiffError("AIFF file has no COMM chunk")


def read(path: str):
    """-> (audio float64 [frames, channels] in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    comm = None
    ssnd = None
    for cid, body in _chunks(data):
        if cid == b"COMM":
            comm = body
        elif cid == b"SSND":
            ssnd = body
    if comm is None or ssnd is None:
        raise AiffError("AIFF file missing COMM or SSND chunk")
    ch, frames, bits = struct.unpack(">hIh", comm[:8])
    rate = int(round(_read_extended80(comm[8:18])))
    comp = comm[18:22].decode("latin1") if len(comm) >= 22 else "NONE"
    offset, _blk = struct.unpack(">II", ssnd[:8])
    raw = ssnd[8 + offset :]

    if comp in ("NONE", "") or comp == "\x00\x00\x00\x00":
        endian = ">"
    elif comp == "sowt":
        endian = "<"
    elif comp.lower() == "fl32":
        a = np.frombuffer(raw[: frames * ch * 4], dtype=">f4").astype(np.float64)
        return a.reshape(-1, ch), rate
    elif comp.lower() == "fl64":
        a = np.frombuffer(raw[: frames * ch * 8], dtype=">f8").astype(np.float64)
        return a.reshape(-1, ch), rate
    else:
        raise AiffError(f"unsupported AIFF-C compression {comp!r}")

    nbytes = (bits + 7) // 8
    raw = raw[: frames * ch * nbytes]
    if nbytes == 1:
        a = np.frombuffer(raw, dtype=np.int8).astype(np.float64)
    elif nbytes == 2:
        a = np.frombuffer(raw, dtype=f"{endian}i2").astype(np.float64)
    elif nbytes == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        if endian == "<":
            b = b[:, ::-1]
        v = (b[:, 0].astype(np.int32) << 16) | (b[:, 1].astype(np.int32) << 8) | b[:, 2]
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        a = v.astype(np.float64)
    elif nbytes == 4:
        a = np.frombuffer(raw, dtype=f"{endian}i4").astype(np.float64)
    else:
        raise AiffError(f"unsupported AIFF sample width {bits}")
    scale = float(1 << (bits - 1))
    return (a / scale).reshape(-1, ch), rate
