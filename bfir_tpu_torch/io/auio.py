"""Sun/NeXT AU (.au/.snd) reader + writer.

Part of the libsndfile-equivalent IO front door (reference loads impulses
through sf_wchar_open, which accepts AU among its built-in formats —
brutefir/buffer.cpp:37-139; format constant SF_FORMAT_AU in
libsndfile/sndfile.h). Own implementation from the format
spec; no reference code involved (the reference ships AU support only
inside the libsndfile binary DLL).

Format: 24-byte big-endian header
    magic ".snd" | data_offset | data_size | encoding | sample_rate | channels
optionally followed by an annotation, then interleaved big-endian samples.
Supported encodings: 1 (mu-law), 2/3/4/5 (s8/s16/s24/s32 PCM), 6/7
(float32/float64), 27 (a-law).
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Tuple

import numpy as np

_MAGIC = b".snd"

_ENC_NAMES = {
    1: "mulaw", 2: "s8", 3: "s16", 4: "s24", 5: "s32",
    6: "float32", 7: "float64", 27: "alaw",
}


class AuInfo(NamedTuple):
    n_channels: int
    sample_rate: int
    n_frames: int
    encoding: str


def _parse_header(f):
    head = f.read(24)
    if len(head) != 24 or head[:4] != _MAGIC:
        raise ValueError("not an AU file (missing .snd magic)")
    data_offset, data_size, encoding, rate, channels = struct.unpack(
        ">IIIII", head[4:24])
    if encoding not in _ENC_NAMES:
        raise ValueError(f"unsupported AU encoding {encoding}")
    if channels < 1 or rate < 1:
        raise ValueError(f"invalid AU header (rate {rate}, channels {channels})")
    return data_offset, data_size, encoding, rate, channels


_BYTES = {1: 1, 2: 1, 3: 2, 4: 3, 5: 4, 6: 4, 7: 8, 27: 1}


def _mulaw_decode(u: np.ndarray) -> np.ndarray:
    """ITU-T G.711 mu-law -> float64, scaled /32768 like libsndfile's
    sf_read_float of a ulaw file (validated against audioop.ulaw2lin)."""
    u = (~u) & 0xFF
    sign = (u & 0x80) != 0
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = ((mant.astype(np.int32) << 3) + 0x84) << exp
    val = (mag - 0x84).astype(np.float64)
    return np.where(sign, -val, val) / 32768.0


def _alaw_decode(a: np.ndarray) -> np.ndarray:
    """ITU-T G.711 a-law -> float64 /32768 (sign bit 1 = positive;
    validated against audioop.alaw2lin)."""
    a = (a ^ 0x55).astype(np.int32)
    sign = (a & 0x80) != 0  # set -> positive in A-law
    exp = (a >> 4) & 0x07
    mant = a & 0x0F
    mag = np.where(exp == 0, (mant << 4) + 8, ((mant << 4) + 0x108) << (exp - 1))
    val = mag.astype(np.float64)
    return np.where(sign, val, -val) / 32768.0


def read(path: str) -> Tuple[np.ndarray, int]:
    """-> (audio float64 [frames, channels], sample_rate)."""
    with open(path, "rb") as f:
        data_offset, data_size, enc, rate, ch = _parse_header(f)
        f.seek(data_offset)
        raw = f.read() if data_size in (0, 0xFFFFFFFF) else f.read(data_size)
    bps = _BYTES[enc]
    n = len(raw) // (bps * ch) * bps * ch
    raw = raw[:n]
    if enc == 1:
        x = _mulaw_decode(np.frombuffer(raw, dtype=np.uint8))
    elif enc == 27:
        x = _alaw_decode(np.frombuffer(raw, dtype=np.uint8))
    elif enc == 2:
        x = np.frombuffer(raw, dtype=np.int8).astype(np.float64) / 128.0
    elif enc == 3:
        x = np.frombuffer(raw, dtype=">i2").astype(np.float64) / 32768.0
    elif enc == 4:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        v = ((b[:, 0].astype(np.int32) << 16) | (b[:, 1].astype(np.int32) << 8)
             | b[:, 2].astype(np.int32))
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        x = v.astype(np.float64) / float(1 << 23)
    elif enc == 5:
        x = np.frombuffer(raw, dtype=">i4").astype(np.float64) / float(1 << 31)
    elif enc == 6:
        x = np.frombuffer(raw, dtype=">f4").astype(np.float64)
    else:  # 7
        x = np.frombuffer(raw, dtype=">f8").astype(np.float64)
    frames = len(x) // ch
    return x[: frames * ch].reshape(frames, ch), rate


def read_info(path: str) -> AuInfo:
    with open(path, "rb") as f:
        data_offset, data_size, enc, rate, ch = _parse_header(f)
        if data_size in (0, 0xFFFFFFFF):
            f.seek(0, 2)
            data_size = f.tell() - data_offset
    return AuInfo(ch, rate, data_size // (_BYTES[enc] * ch), _ENC_NAMES[enc])


_W_ENC = {"s16": (3, ">i2"), "s24": (4, None), "s32": (5, ">i4"),
          "float32": (6, ">f4"), "float64": (7, ">f8")}


def write(path: str, audio: np.ndarray, rate: int,
          encoding: str = "float32") -> None:
    """Write [frames, channels] (or [frames]) audio as AU."""
    if encoding not in _W_ENC:
        raise ValueError(f"unsupported AU write encoding {encoding!r}")
    a = np.asarray(audio, dtype=np.float64)
    if a.ndim == 1:
        a = a[:, None]  # [frames] -> [frames, 1], matching wavio.write
    frames, ch = a.shape
    enc, dt = _W_ENC[encoding]
    if encoding == "s24":
        v = np.clip(np.round(a * (1 << 23)), -(1 << 23), (1 << 23) - 1).astype(np.int32)
        flat = v.reshape(-1)
        body = np.empty((flat.size, 3), dtype=np.uint8)
        body[:, 0] = (flat >> 16) & 0xFF
        body[:, 1] = (flat >> 8) & 0xFF
        body[:, 2] = flat & 0xFF
        payload = body.tobytes()
    elif encoding in ("s16", "s32"):
        scale = 1 << (15 if encoding == "s16" else 31)
        v = np.clip(np.round(a * scale), -scale, scale - 1)
        payload = v.astype(dt).tobytes()
    else:
        payload = a.astype(dt).tobytes()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(">IIIII", 24, len(payload), enc, int(rate), ch))
        f.write(payload)
