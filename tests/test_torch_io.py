"""bfir_tpu_torch's JAX-free copies on the CPU against bfir_tpu: ``core/spec``
(the six cases of tests/test_spec.py, field for field, and JSON across the
packages), the sound-file readers and writers of ``io/*`` (``wavio``,
``sndio``, ``flacio``, ``aiffio``, ``auio``, ``cafio``, ``oggvorbis``;
tests/test_sndio.py and tests/test_wavio.py) and ``utils/profiling.
BlockTimer`` (tests/test_presets_checkpoint.py:88).

Files are made with the reference's writers or from bytes built here, and
read back with both packages. Tolerance: none. Arrays, rates, file info,
written bytes and exception types and messages are equal."""

import dataclasses
import struct
import sys
import types
import zlib

import numpy as np
import pytest

from bfir_tpu.core import spec as JS
from bfir_tpu.io import aiffio as jaiffio
from bfir_tpu.io import auio as jauio
from bfir_tpu.io import cafio as jcafio
from bfir_tpu.io import flacio as jflacio
from bfir_tpu.io import oggvorbis as joggvorbis
from bfir_tpu.io import sndio as jsndio
from bfir_tpu.io import wavio as jwavio
from bfir_tpu.utils.profiling import BlockTimer as JaxBlockTimer
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.io import (aiffio, auio, cafio, flacio, oggvorbis,
                                sndio, wavio)
from bfir_tpu_torch.utils.profiling import BlockTimer

PORT = {"aiffio": aiffio, "auio": auio, "cafio": cafio, "flacio": flacio,
        "oggvorbis": oggvorbis, "sndio": sndio, "wavio": wavio}
REF = {"aiffio": jaiffio, "auio": jauio, "cafio": jcafio, "flacio": jflacio,
       "oggvorbis": joggvorbis, "sndio": jsndio, "wavio": jwavio}


def _equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# -- core/spec ----------------------------------------------------------------


@pytest.mark.parametrize("name", [f.name for f in TS.SampleFormat])
def test_sample_format_properties(name):
    t, j = TS.SampleFormat[name], JS.SampleFormat[name]
    props = ("label", "bytes", "sbytes", "isfloat", "big_endian", "bits",
             "full_scale", "imin", "imax")
    assert ([getattr(t, p) for p in props] == [getattr(j, p) for p in props])
    assert TS.SampleFormat.from_label(t.label) is t
    f = TS.SampleFormat.S16_LE  # tests/test_spec.py's spot values
    assert (f.bytes, f.bits, f.full_scale, f.imin, f.imax) == (
        2, 16, 32768.0, -32768, 32767)
    assert TS.SampleFormat.from_label("s24_le").bits == 24
    assert TS.SampleFormat.FLOAT_LE.full_scale == 1.0


def test_filter_spec_geometry():
    for kw in ({"block_length": 1024, "n_partitions": 64},
               {"block_length": 256, "n_partitions": 3, "dtype": "float64"}):
        t, j = TS.FilterSpec(**kw), JS.FilterSpec(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.n_fft, t.n_freq, t.max_taps) == (j.n_fft, j.n_freq,
                                                   j.max_taps)
    t = TS.FilterSpec(block_length=1024, n_partitions=64)
    assert (t.n_fft, t.n_freq, t.max_taps) == (2048, 1025, 65536)
    for S in (TS, JS):
        with pytest.raises(ValueError):
            S.FilterSpec(block_length=1000)


def test_level_conversion():
    # prefs_eq.cpp:628-631: linear = 10^((steps/10)/20)
    steps = range(-300, 301, 7)
    assert ([TS.level_steps_to_linear(s) for s in steps]
            == [JS.level_steps_to_linear(s) for s in steps])
    assert TS.level_steps_to_linear(0) == 1.0
    np.testing.assert_allclose(TS.level_steps_to_linear(200), 10.0)
    np.testing.assert_allclose(TS.level_steps_to_linear(-200), 0.1)


@pytest.mark.parametrize("kw,ok", [
    ({"enabled": True, "mag_steps": tuple([10] * 31)}, True),
    ({"enabled": True, "level_steps": -30, "mag_steps": tuple(range(31))},
     True),
    ({"mag_steps": tuple([300] * 31)}, False),
    ({"mag_steps": (0,) * 30}, False)])
def test_eq_spec_validation(kw, ok):
    if not ok:
        for S in (TS, JS):
            with pytest.raises(ValueError):
                S.EqSpec(**kw)
        return
    t, j = TS.EqSpec(**kw), JS.EqSpec(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.mag_db, t.level_linear) == (j.mag_db, j.level_linear)


def _engine_config(S):
    return S.EngineConfig(
        filter=S.FilterSpec(block_length=512, n_partitions=8, dtype="float64"),
        stream=S.StreamSpec(n_channels=4, sample_rate=96000,
                            out_format=S.SampleFormat.S24_LE,
                            apply_dither=True),
        chain=S.ChainSpec(
            eq=S.EqSpec(enabled=True, level_steps=-30,
                        mag_steps=tuple(range(31))),
            files=(S.ImpulseFileSpec(enabled=True, filename="/tmp/a.wav",
                                     level_steps=5),
                   S.ImpulseFileSpec(), S.ImpulseFileSpec())),
        delay=S.DelaySpec(enabled=True, samples=(0, 3, 7, 1)),
        overflow_warnings=True)


def test_engine_config_json_round_trip_across_packages():
    t, j = _engine_config(TS), _engine_config(JS)
    assert TS.to_json(t) == JS.to_json(j)
    assert TS.engine_config_from_json(TS.to_json(t)) == t
    assert TS.engine_config_from_json(JS.to_json(j)) == t
    assert JS.engine_config_from_json(TS.to_json(t)) == j


def test_chain_active():
    for S in (TS, JS):
        assert not S.ChainSpec().active
        assert S.ChainSpec(eq=S.EqSpec(enabled=True)).active
        assert S.ChainSpec(files=(S.ImpulseFileSpec(enabled=True,
                                                    filename="x.wav"),)
                           + (S.ImpulseFileSpec(),) * 2).active


# -- io: files the reference writes or the test builds, read by both ----------


def _sine(frames=500, ch=2):
    t = np.arange(frames)[:, None]
    return 0.5 * np.sin(2 * np.pi * t * (np.arange(ch)[None, :] + 1) / 100.0)


def _ext80(rate):
    import math

    m, e = math.frexp(rate)
    return struct.pack(">H", e - 1 + 16383) + int(m * (1 << 64)).to_bytes(
        8, "big")


def _aifc(path, comp, body, ch, frames, bits, rate=44100):
    """An AIFF-C file (``comp`` b"NONE", b"sowt", b"fl32", b"fl64")."""
    comm = (struct.pack(">hIh", ch, frames, bits) + _ext80(rate) + comp
            + b"\x00\x00")
    ssnd = struct.pack(">II", 0, 0) + body
    data = (b"AIFC" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + (b"\x00" if len(comm) & 1 else b"")
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(data)) + data)


def _au_companded(path, code, body, rate=8000):
    with open(path, "wb") as f:
        f.write(b".snd" + struct.pack(">IIIII", 24, len(body), code, rate, 1))
        f.write(body)


_FMT_F32 = struct.pack("<HHIIHH", 0x0003, 2, 44100, 44100 * 8, 8, 32)


def _rf64(path, a):
    payload = a.astype("<f4").tobytes()
    ds64 = struct.pack("<QQQI", 0, len(payload), a.shape[0], 0)
    body = (b"ds64" + struct.pack("<I", len(ds64)) + ds64
            + b"fmt " + struct.pack("<I", len(_FMT_F32)) + _FMT_F32
            + b"data" + struct.pack("<I", 0xFFFFFFFF) + payload)
    with open(path, "wb") as f:
        f.write(b"RF64" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE" + body)


def _w64(path, a):
    tail = b"\x2e\x91\xcf\x11\xa5\xd6\x28\xdb\x04\xc1\x00\x00"

    def chunk(cid, payload):
        size = 24 + len(payload)
        return (cid + tail + struct.pack("<Q", size) + payload
                + b"\x00" * ((-size) % 8))

    chunks = chunk(b"fmt ", _FMT_F32) + chunk(b"data",
                                              a.astype("<f4").tobytes())
    with open(path, "wb") as f:
        f.write(b"riff" + tail + struct.pack("<Q", 40 + len(chunks))
                + b"wave" + tail + chunks)


def _make(case, path):
    """Write the file of ``case``; returns the module whose own reader
    (``read``/``read_flac``/``read_vorbis``) applies."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    a = _sine()
    kind, _, sub = case.partition(":")
    if kind == "wav":
        jwavio.write(path, a, 44100, subtype=sub)
        return "wavio"
    if kind == "flac":
        bps = int(sub)
        x = np.cumsum(rng.integers(-500, 500, size=(5001, 1 + (bps == 16))),
                      axis=0)
        x = np.clip(x, -(1 << (bps - 1)), (1 << (bps - 1)) - 1)
        jflacio.write_flac(path, x.astype(np.int64), 96000, bps=bps)
        return "flacio"
    if kind == "aiff":
        x = rng.integers(-30000, 30000, size=(500, 2))
        body = {"NONE": lambda: x.astype(">i2").tobytes(),
                "sowt": lambda: x.astype("<i2").tobytes(),
                "fl32": lambda: (a * 0.7).astype(">f4").tobytes(),
                "fl64": lambda: (a * 0.7).astype(">f8").tobytes(),
                "NONE24": lambda: rng.integers(0, 256, 1500, dtype=np.uint8)
                .tobytes()}[sub]()
        bits = {"fl32": 32, "fl64": 64, "NONE24": 24}.get(sub, 16)
        ch = 1 if sub == "NONE24" else 2
        _aifc(path, sub[:4].encode(), body, ch, 500, bits)
        return "aiffio"
    if kind == "au":
        if sub in ("mulaw", "alaw"):
            _au_companded(path, {"mulaw": 1, "alaw": 27}[sub],
                          rng.integers(0, 256, 400, dtype=np.uint8).tobytes())
        else:
            jauio.write(path, a, 44100, encoding=sub)
        return "auio"
    if kind == "caf":
        jcafio.write(path, a, 48000, subtype=sub)
        return "cafio"
    if kind == "rf64":
        _rf64(path, a[:48] * 0.6)
        return "wavio"
    if kind == "w64":
        _w64(path, a[:48] * 0.6)
        return "wavio"
    assert kind == "ogg"
    t = np.arange(8192) / 44100
    x = 0.4 * np.sin(2 * np.pi * 440 * t)[:, None] * np.ones((1, int(sub)))
    joggvorbis.write_vorbis(path, x, 44100, quality=0.8)
    return "oggvorbis"


READ_CASES = (
    [f"wav:{s}" for s in ("pcm8", "pcm16", "pcm24", "pcm32", "float32",
                          "float64")]
    + ["flac:16", "flac:24", "flac:8"]
    + [f"aiff:{s}" for s in ("NONE", "sowt", "fl32", "fl64", "NONE24")]
    + [f"au:{s}" for s in ("s16", "s24", "s32", "float32", "float64", "mulaw",
                           "alaw")]
    + [f"caf:{s}" for s in ("float32", "float64", "pcm16")]
    + ["rf64", "w64", "ogg:1", "ogg:2"])


def _reader(mod):
    return {"flacio": "read_flac", "oggvorbis": "read_vorbis"}.get(mod, "read")


@pytest.mark.parametrize("case", READ_CASES)
def test_read_matches_reference(tmp_path, case):
    path = str(tmp_path / "f.bin")
    mod = _make(case, path)
    fn = _reader(mod)
    yt, rt = getattr(PORT[mod], fn)(path)
    yj, rj = getattr(REF[mod], fn)(path)
    _equal(yt, yj)
    assert rt == rj
    ys, rs = sndio.read(path)  # the magic-byte front door
    _equal(ys, yj)
    assert rs == rj
    info = sndio.read_info(path)
    assert tuple(info) == tuple(jsndio.read_info(path))
    assert (info.n_channels, info.sample_rate, info.n_frames) == (
        yt.shape[1], rt, yt.shape[0])
    if hasattr(PORT[mod], "read_info") and mod != "sndio":
        ti, ji = PORT[mod].read_info(path), REF[mod].read_info(path)
        assert (dataclasses.astuple(ti) if dataclasses.is_dataclass(ti)
                else tuple(ti)) == (dataclasses.astuple(ji)
                                    if dataclasses.is_dataclass(ji)
                                    else tuple(ji))


WRITE_CASES = (
    [("wavio", s) for s in ("pcm8", "pcm16", "pcm24", "pcm32", "float32",
                            "float64")]
    + [("auio", s) for s in ("s16", "s24", "s32", "float32", "float64")]
    + [("cafio", s) for s in ("float32", "float64", "pcm16")]
    + [("flacio", b) for b in (8, 16, 24)] + [("oggvorbis", 0.5)])


@pytest.mark.parametrize("mod,sub", WRITE_CASES)
def test_write_matches_reference(tmp_path, mod, sub):
    """The port's writers write the reference's bytes."""
    a = _sine(700, 2) * 1.2  # past full scale: the integer writers clip
    out = []
    for pkg, tag in ((PORT, "t"), (REF, "j")):
        path = str(tmp_path / f"{tag}.bin")
        m = pkg[mod]
        if mod == "wavio":
            m.write(path, a, 44100, subtype=sub)
        elif mod == "auio":
            m.write(path, a, 44100, encoding=sub)
        elif mod == "cafio":
            m.write(path, a, 48000, subtype=sub)
        elif mod == "flacio":
            m.write_flac(path, a / 1.2, 44100, bps=sub)
        else:
            m.write_vorbis(path, a / 1.2, 44100, quality=sub)
        with open(path, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1]


def _no_soundfile(monkeypatch):
    import builtins

    monkeypatch.setitem(sys.modules, "soundfile", None)
    real = builtins.__import__

    def no_soundfile(name, *a, **k):
        if name == "soundfile":
            raise ImportError("not installed")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_soundfile)


def _flac_corrupt(path):
    x = np.cumsum(np.random.default_rng(3).integers(-100, 100, (4096, 1)),
                  axis=0).astype(np.int64)
    jflacio.write_flac(path, x, 44100, bps=16)
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[60] ^= 0xFF  # one byte inside the first frame: the MD5 catches it
    return bytes(raw)


def _caf_desc(codec=b"lpcm", flags=1, bpp=8, ch=2, bits=32, data=True):
    desc = struct.pack(">d4sIIIII", 44100.0, codec, flags, bpp, 1, ch, bits)
    out = b"caff" + struct.pack(">HH", 1, 0) + b"desc" + struct.pack(
        ">q", 32) + desc
    if data:
        out += b"data" + struct.pack(">q", 8) + struct.pack(">I", 0) + bytes(4)
    return out


def _wav_adpcm():
    fmt = struct.pack("<HHIIHH", 0x0002, 2, 44100, 44100 * 4, 4, 16)
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", 64) + bytes(64))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def _aifc_gsm():
    comm = (struct.pack(">hLh", 2, 16, 16) + _ext80(44100) + b"GSM "
            + b"\x04GSM\x00")
    ssnd = struct.pack(">LL", 0, 0) + bytes(64)

    def chunk(tag, payload):
        return (tag + struct.pack(">I", len(payload)) + payload
                + (b"\x00" if len(payload) % 2 else b""))

    body = chunk(b"COMM", comm) + chunk(b"SSND", ssnd)
    return b"FORM" + struct.pack(">I", 4 + len(body)) + b"AIFC" + body


# (name, the file's bytes or a function of its path, modules and readers)
ERROR_CASES = [
    ("PARIS", b" paf" + bytes(20)), ("PARIS_LE", b"fap " + bytes(20)),
    ("SVX", b"FORM\x00\x00\x00\x208SVX" + bytes(12)),
    ("NIST", b"NIST_1A\n   1024\n" + bytes(8)),
    ("VOC", b"Creative Voice File\x1a\x1a\x00"),
    ("IRCAM", b"\x64\xa3\x01\x00" + bytes(20)),
    ("MAT5", b"MATLAB 5.0 MAT-file" + bytes(5)),
    ("PVF", b"PVF1\n1 44100 16\n" + bytes(8)),
    ("XI", b"Extended Instrument: " + bytes(3)),
    ("SDS", b"\xf0\x7e\x00\x01" + bytes(20)),
    ("AVR", b"2BIT" + bytes(20)), ("SD2", b"Sd2f" + bytes(20)),
    ("WVE", b"ALawSoundFile**" + bytes(9)),
    ("OGG_not_vorbis", b"OggS\x00\x02" + bytes(18)),
    ("unknown", b"\x01\x02\x03\x04" + bytes(64)),
    ("wav_adpcm", _wav_adpcm()), ("aifc_gsm", _aifc_gsm()),
    ("au_magic", b"nope" + bytes(30)),
    ("au_encoding", b".snd" + struct.pack(">IIIII", 24, 4, 99, 44100, 1)
     + bytes(4)),
    ("au_truncated", b".snd\x00\x00"),
    ("caf_magic", b"wrong" + bytes(40)),
    ("caf_no_data", _caf_desc(data=False)),
    ("caf_width", _caf_desc(flags=0, bpp=0, bits=12)),
    ("caf_codec", _caf_desc(codec=b"aac ", flags=0, bpp=0, bits=0)),
    ("caf_truncated_desc", b"caff" + struct.pack(">HH", 1, 0) + b"desc"
     + struct.pack(">q", 32) + bytes(12)),
    ("flac_md5", _flac_corrupt),
]


def _outcome(fn, path):
    """What a reader does with a file: its exception's type and message,
    or its result as a tuple."""
    try:
        got = fn(path)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return "raised", type(e).__name__, str(e), isinstance(e, ValueError)
    if dataclasses.is_dataclass(got):
        return "returned", dataclasses.astuple(got)
    return "returned", (tuple(got) if isinstance(got, tuple)
                        else sorted(vars(got).items()))


@pytest.mark.parametrize("name,content", ERROR_CASES,
                         ids=[c[0] for c in ERROR_CASES])
def test_unreadable_files_raise_as_the_reference(tmp_path, monkeypatch, name,
                                                 content):
    """Every file the reference refuses to read, the port refuses with the
    same exception type (a ValueError) and message, from sndio and from the
    format's own reader, with no soundfile fallback installed; where a
    header is whole (an unsupported codec inside a known container), both
    packages' ``read_info`` give the same info."""
    _no_soundfile(monkeypatch)
    path = str(tmp_path / "probe.bin")
    raw = content(path) if callable(content) else content
    with open(path, "wb") as f:
        f.write(raw)
    readers = [("sndio", "read"), ("sndio", "read_info")]
    own = {"au": "auio", "caf": "cafio", "flac": "flacio"}.get(
        name.split("_")[0])
    if own:
        readers += [(own, _reader(own)), (own, "read_info")]
    for mod, fn in readers:
        fn = "read_flac_info" if (mod, fn) == ("flacio", "read_info") else fn
        got, ref = (_outcome(getattr(pkg[mod], fn), path)
                    for pkg in (PORT, REF))
        assert got == ref, (mod, fn)
        if fn.startswith("read") and not fn.endswith("info"):
            assert got[0] == "raised" and got[3], (mod, fn, got)


def test_soundfile_fallback_matches_reference(tmp_path, monkeypatch):
    """With a 'soundfile' module importable, an unsupported format routes
    through it, in both packages."""
    data = np.linspace(-0.5, 0.5, 32).reshape(16, 2)
    stub = types.ModuleType("soundfile")
    stub.read = lambda path, dtype="float64", always_2d=True: (data, 48000)
    stub.info = lambda path: types.SimpleNamespace(
        channels=2, samplerate=48000, frames=16,
        format=types.SimpleNamespace(lower=lambda: "ogg"))
    monkeypatch.setitem(sys.modules, "soundfile", stub)
    p = str(tmp_path / "x.ogg")
    with open(p, "wb") as f:
        f.write(b"OggS\x00\x02" + bytes(100))
    for mod in (sndio, jsndio):
        got, rate = mod.read(p)
        _equal(got, data)
        assert rate == 48000
        assert tuple(mod.read_info(p))[:3] == (2, 48000, 16)
    assert tuple(sndio.read_info(p)) == tuple(jsndio.read_info(p))


def test_vorbis_unavailable_error_message(monkeypatch):
    for OV in (oggvorbis, joggvorbis):
        monkeypatch.setattr(OV, "_libs", None)
        monkeypatch.setattr(OV.ctypes.util, "find_library", lambda n: None)

        def boom(*a, **k):
            raise OSError("no lib")

        monkeypatch.setattr(OV.ctypes, "CDLL", boom)
        with pytest.raises(OV.VorbisUnavailable, match="libogg"):
            OV._load_libs()
        monkeypatch.setattr(OV, "_libs", None)
        assert OV.available() is False
        monkeypatch.setattr(OV, "_libs", None)


# -- utils/profiling ----------------------------------------------------------


def test_block_timer_matches_reference():
    ours, ref = BlockTimer(capacity=5), JaxBlockTimer(capacity=5)
    assert ours.percentiles().keys() == ref.percentiles().keys()
    assert all(np.isnan(v) for v in ours.percentiles().values())
    for v in [0.001, 0.002, 0.003, 0.0025, 0.0001, 0.004, 0.5]:
        ours.add(v)
        ref.add(v)
    assert ours.count == ref.count == 5  # capacity reached
    assert ours.percentiles() == ref.percentiles()
    assert ours.percentiles((10, 90)) == ref.percentiles((10, 90))
    assert ours.summary() == ref.summary()
    assert "5 blocks" in ours.summary()
    ours.reset()
    with ours.measure():
        pass
    assert ours.count == 1 and ours.percentiles()[50] >= 0
    t = BlockTimer()  # tests/test_presets_checkpoint.py:88
    for v in [0.001, 0.002, 0.003]:
        t.add(v)
    assert t.percentiles()[50] == 0.002 and "3 blocks" in t.summary()
