"""Apple Core Audio Format (.caf) linear-PCM reader.

Part of the libsndfile-equivalent IO front door (reference accepts CAF via
the libsndfile binary — SF_FORMAT_CAF in libsndfile/
sndfile.h; impulse loading at brutefir/buffer.cpp:37-139).
Own implementation from Apple's CAF spec; linear PCM only (the impulse-file
universe), named error for compressed codecs.

Layout: 8-byte file header ('caff', version 1), then chunks of
(4-byte type, signed 8-byte big-endian size):

- 'desc': f64 sample_rate, 4cc format_id ('lpcm'), u32 format_flags
  (bit0 = float, bit1 = little-endian), u32 bytes_per_packet,
  u32 frames_per_packet, u32 channels_per_frame, u32 bits_per_channel
- 'data': u32 edit_count then the interleaved samples (size may be -1 =
  rest of file)
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Tuple

import numpy as np


class CafInfo(NamedTuple):
    n_channels: int
    sample_rate: int
    n_frames: int
    encoding: str


def _parse(path: str, want_data: bool):
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8 or head[:4] != b"caff":
            raise ValueError("not a CAF file (missing caff magic)")
        desc = None
        data = None
        while True:
            ch = f.read(12)
            if len(ch) < 12:
                break
            ctype = ch[:4]
            (size,) = struct.unpack(">q", ch[4:12])
            if ctype == b"desc":
                body = f.read(32)
                if len(body) != 32:  # named error, not struct.error (ADVICE r3)
                    raise ValueError("truncated CAF desc chunk")
                (rate, fmt, flags, bpp, fpp, nch, bits) = struct.unpack(
                    ">d4sIIIII", body)
                desc = (rate, fmt, flags, bpp, fpp, nch, bits)
                if size > 32:
                    f.seek(size - 32, 1)
            elif ctype == b"data":
                f.read(4)  # edit count
                payload_size = None if size < 0 else size - 4
                if want_data:
                    data = f.read() if payload_size is None else f.read(payload_size)
                else:
                    pos = f.tell()
                    if payload_size is None:  # -1 size: data runs to EOF
                        f.seek(0, 2)
                        data = f.tell() - pos
                    else:
                        data = payload_size
                        f.seek(pos + payload_size)
            else:
                if size < 0:
                    break
                f.seek(size, 1)
    if desc is None:
        raise ValueError("CAF file has no desc chunk")
    if data is None:
        raise ValueError("CAF file has no data chunk")
    return desc, data


def _decode(desc, raw: bytes) -> Tuple[np.ndarray, int]:
    rate, fmt, flags, bpp, fpp, nch, bits = desc
    if fmt != b"lpcm":
        raise ValueError(
            f"unsupported CAF codec {fmt.decode('latin1')!r}: this build reads "
            "linear PCM CAF only")
    is_float = bool(flags & 1)
    little = bool(flags & 2)
    bo = "<" if little else ">"
    nbytes = bits // 8
    if is_float:
        if bits not in (32, 64):
            raise ValueError(f"invalid CAF float width {bits}")
        x = np.frombuffer(raw[: len(raw) // nbytes * nbytes],
                          dtype=f"{bo}f{nbytes}").astype(np.float64)
    elif bits == 16:
        x = np.frombuffer(raw[: len(raw) // 2 * 2], dtype=f"{bo}i2"
                          ).astype(np.float64) / 32768.0
    elif bits == 32:
        x = np.frombuffer(raw[: len(raw) // 4 * 4], dtype=f"{bo}i4"
                          ).astype(np.float64) / float(1 << 31)
    elif bits == 24:
        b = np.frombuffer(raw[: len(raw) // 3 * 3], dtype=np.uint8).reshape(-1, 3)
        if little:
            v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
        else:
            v = ((b[:, 0].astype(np.int32) << 16) | (b[:, 1].astype(np.int32) << 8)
                 | b[:, 2].astype(np.int32))
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        x = v.astype(np.float64) / float(1 << 23)
    elif bits == 8:
        x = np.frombuffer(raw, dtype=np.int8).astype(np.float64) / 128.0
    else:
        raise ValueError(f"unsupported CAF PCM width {bits}")
    frames = len(x) // nch
    return x[: frames * nch].reshape(frames, nch), int(round(rate))


def read(path: str) -> Tuple[np.ndarray, int]:
    """-> (audio float64 [frames, channels], sample_rate)."""
    desc, raw = _parse(path, want_data=True)
    return _decode(desc, raw)


def read_info(path: str) -> CafInfo:
    desc, size = _parse(path, want_data=False)
    rate, fmt, flags, bpp, fpp, nch, bits = desc
    enc = ("float" if flags & 1 else "pcm") + str(bits)
    nbytes = max(1, bits // 8) * nch
    return CafInfo(nch, int(round(rate)), int(size) // nbytes, enc)


def write(path: str, audio: np.ndarray, rate: int,
          subtype: str = "float32") -> None:
    """Write [frames, channels] (or [frames]) linear-PCM CAF (test support
    and cache interchange; big-endian samples, matching Apple defaults)."""
    a = np.asarray(audio, dtype=np.float64)
    if a.ndim == 1:
        a = a[:, None]
    frames, ch = a.shape
    if subtype == "float32":
        payload = a.astype(">f4").tobytes()
        flags, bits = 1, 32
    elif subtype == "float64":
        payload = a.astype(">f8").tobytes()
        flags, bits = 1, 64
    elif subtype == "pcm16":
        v = np.clip(np.round(a * 32768.0), -32768, 32767)
        payload = v.astype(">i2").tobytes()
        flags, bits = 0, 16
    else:
        raise ValueError(f"unsupported CAF write subtype {subtype!r}")
    nbytes = bits // 8
    with open(path, "wb") as f:
        f.write(b"caff" + struct.pack(">HH", 1, 0))
        f.write(b"desc" + struct.pack(">q", 32))
        f.write(struct.pack(">d4sIIIII", float(rate), b"lpcm", flags,
                            nbytes * ch, 1, ch, bits))
        f.write(b"data" + struct.pack(">q", 4 + len(payload)))
        f.write(struct.pack(">I", 0))
        f.write(payload)
