"""WAV file IO.

Replaces the reference's binary libsndfile dependency (``libsndfile/sndfile.h``,
used via ``buffer::load_from_snd_file``/``save_to_snd_file``,
``buffer.cpp:37-139``). Pure numpy + stdlib struct: supports PCM u8/s16/s24/s32
and IEEE float32/float64, plain RIFF and WAVE_FORMAT_EXTENSIBLE headers.

All in-memory audio is float ``[frames, channels]``; integer formats are
scaled to [-1, 1) by 2^(bits-1) on read and the inverse on write, matching
the scaling the reference applies when loading coefficients
(``coeff.cpp:153-228``; ``buffer_format_t.sf.scale`` setup brutefir.cpp:435-539).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass(frozen=True)
class WavInfo:
    """File parameters, as returned by the reference's ``buffer::get_snd_file_params``
    (buffer.cpp:152-188)."""

    n_channels: int
    sample_rate: int
    n_frames: int
    bits: int
    is_float: bool

    @property
    def format_name(self) -> str:
        if self.is_float:
            return f"float{self.bits}"
        return f"pcm{self.bits}"


def _parse_chunks(data: bytes):
    """Chunk map for plain RIFF/WAVE, RF64 (EBU 64-bit WAV,
    SF_FORMAT_RF64) and Sonic Foundry W64 (SF_FORMAT_W64) containers —
    the libsndfile majors that are WAV in different framing
    (libsndfile/sndfile.h:58,73)."""
    if len(data) >= 12 and data[0:4] == b"RF64" and data[8:12] == b"WAVE":
        return _parse_chunks_rf64(data)
    if len(data) >= 40 and data[0:4] == b"riff" and data[24:28] == b"wave":
        return _parse_chunks_w64(data)
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    chunks = {}
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid not in chunks:  # keep first occurrence
            chunks[cid] = body
        pos += 8 + size + (size & 1)
    return chunks


def _parse_chunks_rf64(data: bytes):
    """RF64: RIFF chunk layout, but the riff/data sizes live in a mandatory
    ``ds64`` chunk (any 32-bit size field equal to 0xFFFFFFFF defers to
    it). Spec: EBU tech 3306."""
    pos = 12
    chunks = {}
    ds64_data_size = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if cid == b"ds64":
            body = data[pos + 8 : pos + 8 + size]
            if len(body) < 16:
                raise ValueError("truncated RF64 ds64 chunk")
            _riff64, ds64_data_size = struct.unpack_from("<QQ", body, 0)
            pos += 8 + size + (size & 1)
            continue
        if size == 0xFFFFFFFF:
            if cid != b"data" or ds64_data_size is None:
                raise ValueError(
                    "RF64 64-bit size for a chunk the ds64 table does not "
                    f"cover ({cid!r})")
            size = ds64_data_size
        body = data[pos + 8 : pos + 8 + size]
        if cid not in chunks:
            chunks[cid] = body
        pos += 8 + size + (size & 1)
    if b"fmt " not in chunks:
        raise ValueError("RF64 file missing fmt chunk")
    return chunks


def _parse_chunks_w64(data: bytes):
    """W64: 16-byte GUID chunk ids whose first four bytes spell the RIFF
    id, 8-byte little-endian sizes that INCLUDE the 24-byte chunk header,
    8-byte alignment."""
    pos = 40  # riff GUID(16) + size(8) + wave GUID(16)
    chunks = {}
    while pos + 24 <= len(data):
        cid = data[pos : pos + 4]  # leading 4 GUID bytes spell the id
        (size,) = struct.unpack_from("<Q", data, pos + 16)
        if size < 24:
            raise ValueError("invalid W64 chunk size")
        body = data[pos + 24 : pos + size]
        if cid not in chunks:
            chunks[cid] = body
        pos += (size + 7) & ~7  # chunks align to 8 bytes
    if b"fmt " not in chunks:
        raise ValueError("W64 file missing fmt chunk")
    return chunks


def _decode_fmt(body: bytes):
    if len(body) < 16:
        raise ValueError("fmt chunk too short")
    tag, n_ch, rate, _brate, _align, bits = struct.unpack_from("<HHIIHH", body, 0)
    if tag == WAVE_FORMAT_EXTENSIBLE:
        if len(body) < 40:
            raise ValueError("extensible fmt chunk too short")
        # valid bits + channel mask + GUID; first 2 bytes of GUID = format tag
        (tag,) = struct.unpack_from("<H", body, 24)
    return tag, n_ch, rate, bits


def read_info(path: str) -> WavInfo:
    with open(path, "rb") as f:
        data = f.read()
    chunks = _parse_chunks(data)
    tag, n_ch, rate, bits = _decode_fmt(chunks[b"fmt "])
    nbytes = bits // 8
    n_frames = len(chunks[b"data"]) // (nbytes * n_ch) if n_ch else 0
    return WavInfo(n_ch, rate, n_frames, bits, tag == WAVE_FORMAT_IEEE_FLOAT)


def read(path: str, dtype=np.float64):
    """Read a WAV file -> (audio [frames, channels] float, sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    chunks = _parse_chunks(data)
    tag, n_ch, rate, bits = _decode_fmt(chunks[b"fmt "])
    raw = chunks[b"data"]
    nbytes = bits // 8
    n_frames = len(raw) // (nbytes * n_ch)
    raw = raw[: n_frames * nbytes * n_ch]

    if tag == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            audio = np.frombuffer(raw, dtype="<f4").astype(dtype)
        elif bits == 64:
            audio = np.frombuffer(raw, dtype="<f8").astype(dtype)
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    elif tag == WAVE_FORMAT_PCM:
        if bits == 8:
            audio = (np.frombuffer(raw, dtype=np.uint8).astype(dtype) - 128.0) / 128.0
        elif bits == 16:
            audio = np.frombuffer(raw, dtype="<i2").astype(dtype) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            i32 = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            i32 = (i32 << 8) >> 8  # sign-extend
            audio = i32.astype(dtype) / 8388608.0
        elif bits == 32:
            audio = np.frombuffer(raw, dtype="<i4").astype(dtype) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag 0x{tag:04x}")

    return audio.reshape(n_frames, n_ch), rate


def write(path: str, audio: np.ndarray, sample_rate: int, subtype: str = "float32"):
    """Write ``audio`` [frames, channels] (float, full scale 1.0) to a WAV file.

    subtype: pcm16 | pcm24 | pcm32 | float32 | float64. The reference saves its
    derived artifacts as float WAVs of the engine precision
    (buffer.cpp:59-90: SF_FORMAT_FLOAT/DOUBLE).
    """
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    n_frames, n_ch = audio.shape

    if subtype == "float32":
        tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
        payload = audio.astype("<f4").tobytes()
    elif subtype == "float64":
        tag, bits = WAVE_FORMAT_IEEE_FLOAT, 64
        payload = audio.astype("<f8").tobytes()
    elif subtype == "pcm8":
        tag, bits = WAVE_FORMAT_PCM, 8
        q = np.clip(np.round(audio * 128.0) + 128, 0, 255).astype(np.uint8)
        payload = q.tobytes()
    elif subtype == "pcm16":
        tag, bits = WAVE_FORMAT_PCM, 16
        q = np.clip(np.round(audio * 32768.0), -32768, 32767).astype("<i2")
        payload = q.tobytes()
    elif subtype == "pcm24":
        tag, bits = WAVE_FORMAT_PCM, 24
        q = np.clip(np.round(audio * 8388608.0), -8388608, 8388607).astype(np.int32)
        flat = q.reshape(-1)
        b = np.empty((flat.size, 3), dtype=np.uint8)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        payload = b.tobytes()
    elif subtype == "pcm32":
        tag, bits = WAVE_FORMAT_PCM, 32
        q = np.clip(np.round(audio * 2147483648.0), -2147483648, 2147483647).astype("<i4")
        payload = q.tobytes()
    else:
        raise ValueError(f"unsupported subtype {subtype!r}")

    nbytes = bits // 8
    byte_rate = sample_rate * n_ch * nbytes
    block_align = n_ch * nbytes
    fmt = struct.pack("<HHIIHH", tag, n_ch, sample_rate, byte_rate, block_align, bits)
    # float formats conventionally carry a zero-length fact chunk
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        chunks += b"fact" + struct.pack("<II", 4, n_frames)
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)
