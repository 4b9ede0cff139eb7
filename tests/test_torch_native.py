"""bfir_tpu_torch's native host codec and reblocker (``bfir_tpu_torch.native``)
against the port's numpy codec (``ops.formats.decode_plain``,
``encode_int_plain``, ``encode_float``) and against the reference's native
library (``bfir_tpu.native``), on the same bytes and samples.

Tolerance: none. Bytes and decoded samples are equal bit for bit, float32
round trips equal the float32 rounding of the input."""

import os
import stat
import subprocess
import sys

import numpy as np
import pytest

from bfir_tpu import native as jnative
from bfir_tpu.core import spec as JS
from bfir_tpu_torch import native
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.ops import formats as fm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = [f.name for f in TS.SampleFormat]
INT_FORMATS = [f.name for f in TS.SampleFormat if not f.isfloat]
C = 3  # a ragged channel count


def _bits(a):
    """An array's dtype, shape and bytes: equal only bit for bit."""
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


def _raw(f, frames, seed):
    """Interleaved bytes of ``frames`` frames of C channels: every bit
    pattern for the integer formats (the pad byte of S24_4 included),
    finite floats with zeros, signed zeros, infinities and subnormals for
    the float ones."""
    rng = np.random.default_rng(seed)
    if not f.isfloat:
        return rng.integers(0, 256, frames * C * f.bytes,
                            dtype=np.uint8).tobytes()
    x = rng.uniform(-2.0, 2.0, (C, frames))
    special = [0.0, -0.0, np.inf, -np.inf, 1e-310, -5e-324, 1e-40, 1.0]
    x.flat[:len(special)] = special
    return fm.encode_float(x, f)


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_matches_plain_and_reference(fmt):
    f, jf = TS.SampleFormat[fmt], JS.SampleFormat[fmt]
    raw = _raw(f, 257, seed=1)
    got = native.decode_f64(raw, f, C)
    assert got.shape == (C, 257) and got.dtype == np.float64
    assert _bits(got) == _bits(fm.decode_plain(raw, f, C))
    assert _bits(got) == _bits(jnative.decode_f64(raw, jf, C))
    for dt in (np.float32, np.float64):
        assert (_bits(fm.decode(raw, f, C, dtype=dt))
                == _bits(fm.decode_plain(raw, f, C, dtype=dt)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_short_and_odd_inputs(fmt):
    """Zero frames, a trailing partial frame, every buffer type, and a
    uint8 array that is not contiguous."""
    f = TS.SampleFormat[fmt]
    frame = f.bytes * C
    raw = _raw(f, 40, seed=2)
    for cut in (0, 1, frame - 1, frame, frame + 1, len(raw) - 1):
        part = raw[:cut]
        got = fm.decode(part, f, C)
        assert got.shape == (C, cut // frame)
        assert _bits(got) == _bits(fm.decode_plain(part, f, C))
    ref = fm.decode_plain(raw, f, C)
    arr = np.frombuffer(raw, dtype=np.uint8)
    for buf in (bytearray(raw), memoryview(raw), arr, arr.reshape(-1, frame)):
        assert _bits(fm.decode(buf, f, C)) == _bits(ref)
    strided = np.zeros(2 * len(raw), dtype=np.uint8)
    strided[::2] = arr
    assert _bits(fm.decode(strided[::2], f, C)) == _bits(ref)


@pytest.mark.parametrize("fmt", INT_FORMATS)
def test_encode_int_matches_plain_and_reference(fmt):
    f, jf = TS.SampleFormat[fmt], JS.SampleFormat[fmt]
    rng = np.random.default_rng(3)
    q = rng.integers(f.imin, f.imax + 1, size=(C, 257)).astype(np.int32)
    q[:, :2] = [[f.imin, f.imax]] * C
    got = fm.encode_int(q, f)
    assert len(got) == q.size * f.bytes
    assert got == fm.encode_int_plain(q, f)
    assert got == jnative.encode_int(q, jf)
    # not C-contiguous, not int32: made contiguous int32 before the call
    assert fm.encode_int(np.asfortranarray(q), f) == got
    assert fm.encode_int(q.astype(np.int64), f) == got
    assert fm.encode_int(np.repeat(q, 2, axis=1)[:, ::2], f) == got
    empty = np.zeros((C, 0), dtype=np.int32)
    assert fm.encode_int(empty, f) == fm.encode_int_plain(empty, f) == b""
    # the decode of the encode is the input
    assert _bits(fm.decode(got, f, C) * f.full_scale) == _bits(
        q.astype(np.float64))


@pytest.mark.parametrize("fmt", [n for n in FORMATS if n not in INT_FORMATS])
def test_float_round_trip(fmt):
    f, jf = TS.SampleFormat[fmt], JS.SampleFormat[fmt]
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.5, 1.5, (C, 123))
    raw = native.encode_float(x, f)
    assert raw == fm.encode_float(x, f) == jnative.encode_float(x, jf)
    back = native.decode_f64(raw, f, C)
    want = x.astype(np.float32).astype(np.float64) if f.bytes == 4 else x
    assert _bits(back) == _bits(want)


def test_a_refused_format_or_shape_raises():
    """A C function's non-zero return code raises; nothing falls back."""
    q = np.zeros((2, 8), dtype=np.int32)
    with pytest.raises(RuntimeError, match="refused FLOAT_LE"):
        native.encode_int(q, TS.SampleFormat.FLOAT_LE)
    with pytest.raises(RuntimeError, match="refused S16_LE"):
        native.encode_float(q, TS.SampleFormat.S16_LE)
    with pytest.raises(ValueError, match="integer formats"):
        fm.encode_int(q, TS.SampleFormat.FLOAT_LE)
    with pytest.raises(ValueError, match="shape"):
        native.encode_int(np.zeros(8, dtype=np.int32), TS.SampleFormat.S16_LE)
    with pytest.raises(ValueError, match="n_channels"):
        native.decode_f64(b"\x00" * 8, TS.SampleFormat.S16_LE, 0)


def test_reblocker_matches_reference():
    """The same chunk sequence through the port's and the reference's
    reblocker: the same blocks and fill after every push, across reset."""
    block = 64
    ours, ref = native.Reblocker(block, C), jnative.Reblocker(block, C)
    x = np.random.default_rng(5).standard_normal((C, 1000))
    a, got = 0, []
    for i, n in enumerate((50, 80, 170, 0, 1, 63, 300, 7)):
        chunk = x[:, a:a + n]
        a += n
        if i == 4:  # reset mid-stream drops the partial block
            ours.reset()
            ref.reset()
            assert ours.fill == ref.fill == 0
        b_ours, b_ref = ours.push(chunk), ref.push(chunk)
        assert _bits(b_ours) == _bits(b_ref)
        assert ours.fill == ref.fill
        got.extend(b_ours)
    # before the reset: 300 frames, 4 blocks; after: 371 frames from 300
    flat = np.concatenate(got, axis=1)
    assert flat.shape == (C, 4 * block + 5 * block)
    np.testing.assert_array_equal(flat[:, :256], x[:, :256])
    np.testing.assert_array_equal(flat[:, 256:], x[:, 300:300 + 5 * block])
    assert ours.fill == (671 - 300) - 5 * block
    # a chunk of another channel count never reaches the C loop
    with pytest.raises(ValueError, match="channels"):
        ours.push(x[:2, :10])


def _impulse_file(tmp_path, h):
    path = str(tmp_path / "half.wav")
    wavio.write(path, h.T, 44100, subtype="float64")
    return path


def _raw_config(path, in_fmt, out_fmt):
    """tests/test_engine.py's make_config at its raw-path case: 2 channels,
    block 256, float64, one impulse file, dithered output."""
    files = (() if path is None
             else (TS.ImpulseFileSpec(enabled=True, filename=path),))
    return TS.EngineConfig(
        filter=TS.FilterSpec(block_length=256, n_partitions=1,
                             dtype="float64"),
        stream=TS.StreamSpec(n_channels=2, sample_rate=44100,
                             in_format=in_fmt, out_format=out_fmt,
                             apply_dither=True),
        chain=TS.ChainSpec(files=files + (TS.ImpulseFileSpec(),)
                           * (3 - len(files))))


@pytest.mark.parametrize("in_fmt,out_fmt", [("FLOAT_LE", "S16_LE"),
                                            ("S24_LE", "S24_LE")])
def test_process_raw_matches_the_plain_codec(tmp_path, monkeypatch, in_fmt,
                                             out_fmt):
    """process_raw's bytes with the native codec equal the same session's
    with its decode and encode done by the plain versions (the dither's
    generator is seeded, so the bytes are deterministic); a call that
    completes no block gives b"", a passthrough stream is still quantized."""
    fin, fout = TS.SampleFormat[in_fmt], TS.SampleFormat[out_fmt]
    h = np.zeros((2, 4))
    h[:, 0] = 0.5
    path = _impulse_file(tmp_path, h)
    x = np.random.default_rng(5).uniform(-0.5, 0.5, (2, 1100))
    raw = (fm.encode_float(x, fin) if fin.isfloat
           else fm.encode_int_plain(np.round(x * fin.full_scale), fin))
    cuts = [2 * fin.bytes * t for t in (0, 100, 101, 700, 1100)]

    def run(tag, cfg_path):
        sp = StreamProcessor(_raw_config(cfg_path, fin, fout),
                             ArtifactCache(str(tmp_path / tag)), device="cpu")
        return [sp.process_raw(raw[a:b]) for a, b in zip(cuts, cuts[1:])]

    native_out = run("native", path)
    passthrough = run("pass", None)
    assert native_out[0] == b""  # 100 frames: no block completed
    monkeypatch.setattr(fm, "decode", fm.decode_plain)
    monkeypatch.setattr(fm, "encode_int", fm.encode_int_plain)
    assert run("plain", path) == native_out
    assert run("plain_pass", None) == passthrough
    y = fm.decode_plain(b"".join(native_out), fout, 2)
    assert y.shape == (2, 4 * 256)
    xin = fm.decode_plain(raw, fin, 2)[:, :y.shape[1]]
    # tests/test_engine.py:238's bound: the dithered 0.5 x within 5 LSB
    np.testing.assert_allclose(y, 0.5 * xin, atol=5 / fout.full_scale)
    yp = fm.decode_plain(b"".join(passthrough), fout, 2)  # not reblocked
    np.testing.assert_allclose(yp, fm.decode_plain(raw, fin, 2),
                               atol=5 / fout.full_scale)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that is missing or fails raises RuntimeError with its
    output; decode then raises too, and nothing falls back to numpy."""
    missing = str(tmp_path / "no-such-g++")
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.library_path(str(tmp_path / "b1"), cxx=missing)
    failing = tmp_path / "failing-g++"
    failing.write_text("#!/bin/sh\necho 'codec.cpp:1: error: broken' >&2\n"
                       "exit 1\n")
    failing.chmod(failing.stat().st_mode | stat.S_IEXEC)
    with pytest.raises(RuntimeError, match="exit 1.*\n.*error: broken"):
        native.library_path(str(tmp_path / "b2"), cxx=str(failing))
    assert os.listdir(tmp_path / "b2") == []  # the temp directory went

    build = native.library_path
    monkeypatch.setattr(native, "library_path",
                        lambda: build(str(tmp_path / "b3"), cxx=missing))
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="building the native codec"):
            fm.decode(b"\x00" * 8, TS.SampleFormat.S16_LE, 2)
    finally:
        native.load.cache_clear()


def test_parallel_builds_leave_one_whole_library(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library and decodes, and one library is left, no temp files."""
    build_dir = str(tmp_path / "build")
    code = ("import sys, ctypes\n"
            "from bfir_tpu_torch import native\n"
            "so = native.library_path(sys.argv[1])\n"
            "ctypes.CDLL(so).bfir_reblocker_fill\n"
            "print(so)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, build_dir],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    sos = {o.strip() for o, _ in outs}
    assert len(sos) == 1
    assert os.listdir(build_dir) == [os.path.basename(sos.pop())]
