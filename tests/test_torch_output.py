"""The output stage of bfir_tpu_torch on CPU against bfir_tpu: the hp-TPDF
quantizer (K9's plain version) against the reference's scan path and its
Pallas kernel in interpret mode on the same dither values, mid-tread
rounding, the byte codecs for every sample format, ``output_stage``,
``StreamProcessor.process_raw`` and the render CLI's ``--dither`` and
``--delay``.

Tolerance: the quantizers, codecs and float64 sessions agree bit for bit
(byte for byte); float32 sessions differ from the reference by float32
rounding, so their 16-bit outputs may straddle a rounding boundary by one
LSB in a few samples (counted and bounded below). The dithered outputs
come from another random generator than the reference's, so they are held
to the statistics: within 5 LSB of the undithered signal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bfir_tpu.cli import render as JCLI
from bfir_tpu.core import spec as JS
from bfir_tpu.engine.cache import ArtifactCache as JaxArtifactCache
from bfir_tpu.engine.session import StreamProcessor as JaxStreamProcessor
from bfir_tpu.kernels import dither_kernel as JDK
from bfir_tpu.ops import dither as JD
from bfir_tpu.ops import formats as JF
from bfir_tpu_torch import convert
from bfir_tpu_torch.cli import render as CLI
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.kernels import dither_kernel as DK
from bfir_tpu_torch.ops import dither as D
from bfir_tpu_torch.ops import formats as F

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends: XLA's CPU
    compiler has aborted xdist workers late in full runs once many
    executables had accumulated in one process (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


def _equal(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _ref_dither_values(st, n, dtype):
    """The reference's dither values for its next block, rebuilt from its
    state's key exactly as ops/dither.py:122-126 draws them."""
    c = st.e0.shape[0]
    kb, _ = jax.random.split(st.key)
    b = jax.random.randint(kb, (c, n), -128, 128, dtype=jnp.int32)
    allb = jnp.concatenate([st.prev_byte[:, None], b], axis=1)
    diff = allb[:, 1:] - allb[:, :-1]
    return np.array(0.5 + (diff.astype(dtype) + 1.0) / 255.0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bits", [24, 16], ids=["int24", "int16"])
def test_quantizer_matches_reference_bit_for_bit(dtype, bits):
    """Two chained [8, 256] blocks at integer limits with clipping input:
    the port's plain quantizer, the reference's scan path and the
    reference's Pallas kernel (interpret mode) agree in q, e0, e1 and all
    three statistics, bit for bit."""
    c, n = 8, 256
    imin, imax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    rng = np.random.default_rng(bits)
    x = (rng.uniform(-1.2, 1.2, (2, c, n)) * (imax + 1)).astype(dtype)
    jst = JD.init_dither_state(c, seed=3, dtype=np.dtype(dtype))
    jof = JD.init_overflow_stats(c, dtype=np.dtype(dtype))
    tst = convert.dither_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    tof = D.init_overflow_stats(c, dtype=getattr(torch, dtype), device="cpu")
    for blk in x:
        dv = _ref_dither_values(jst, n, np.dtype(dtype))
        pal = JDK.quantize_hp_tpdf_pallas(
            jnp.asarray(blk), jnp.asarray(dv), jst.e0, jst.e1, float(imin),
            float(imax), jof.n_overflows, jof.largest, jof.intlargest,
            interpret=True)
        jq, jst, jof = JD.quantize_hp_tpdf(jnp.asarray(blk), imin, imax, jst,
                                           jof)
        tq, tst, tof = D.quantize_hp_tpdf_values(
            torch.from_numpy(blk), torch.from_numpy(dv), imin, imax, tst, tof)
        ref = (jq, jst.e0, jst.e1, *jof)
        got = (tq, tst.e0, tst.e1, *tof)
        for g, r, p in zip(got, ref, pal):
            assert g.dtype == torch.int32 or str(g.dtype) == f"torch.{dtype}"
            _equal(g, r)
            _equal(g, p)
    assert int(tof.n_overflows.sum()) > 100  # the input clips
    assert DK.quantize_hp_tpdf.launches == 0  # CPU tensors: the plain loop
    # the states convert field for field (a fresh generator on the way in)
    for g, r in zip(convert.overflow_stats_from_numpy(
            convert.overflow_stats_to_numpy(tof), "cpu"), jof):
        _equal(g, r)
    back = convert.dither_state_to_numpy(tst)
    for f in ("e0", "e1", "prev_byte"):
        _equal(getattr(back, f), getattr(tst, f))


@pytest.mark.parametrize("fmt", ["S8", "S16_LE", "S24_LE", "S32_LE"])
def test_quantize_no_dither_matches_reference(fmt):
    f = TS.SampleFormat[fmt]
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.1, 1.1, (3, 200)) * f.full_scale
    x[0, :6] = [0.4, -0.4, -2.5, 2.5, -3.0, 7.5]  # the rounding quirk
    tof = D.init_overflow_stats(3, dtype=torch.float64, device="cpu")
    jof = JD.init_overflow_stats(3, dtype=np.float64)
    tq, tof = D.quantize_no_dither(torch.from_numpy(x), f.imin, f.imax, tof)
    jq, jof = JD.quantize_no_dither(x, f.imin, f.imax, jof)
    _equal(tq, jq)
    for g, r in zip(tof, jof):
        _equal(g, r)
    assert int(tof.n_overflows.sum()) > 0


def test_dither_values_carry_the_byte_stream():
    """The dither values are 0.5 + (b[t] - b[t-1] + 1)/255 over random
    bytes in [-128, 128), the last byte carried into the next block."""
    st = D.init_dither_state(4, seed=9, dtype=torch.float64, device="cpu")
    prev = st.prev_byte.clone()
    dvs = []
    for n in (100, 57):
        dv, st = D.dither_values(st, n, torch.float64)
        dvs.append(dv)
    diff = torch.round((torch.cat(dvs, 1) - 0.5) * 255.0 - 1.0).to(torch.int64)
    b = prev[:, None].to(torch.int64) + torch.cumsum(diff, dim=1)
    assert int(b.min()) >= -128 and int(b.max()) <= 127
    _equal(b[:, -1], st.prev_byte)
    assert len(torch.unique(b)) > 200  # the whole byte range is drawn


def test_hp_tpdf_statistics():
    """tests/test_dither_formats.py's statistics on the port's generator:
    unbiased, within 5 LSB, and high-pass shaped; the state threads over
    blocks; the same seed gives the same output."""
    c, n = 2, 8192
    val = 1000.3
    outs = []
    for _ in range(2):
        st = D.init_dither_state(c, seed=7, dtype=torch.float64, device="cpu")
        of = D.init_overflow_stats(c, dtype=torch.float64, device="cpu")
        x = torch.full((c, n), val, dtype=torch.float64)
        q1, st, of = D.quantize_hp_tpdf(x[:, :5000], -32768, 32767, st, of)
        q2, st, of = D.quantize_hp_tpdf(x[:, 5000:], -32768, 32767, st, of)
        outs.append(torch.cat([q1, q2], 1).numpy().astype(np.float64))
    _equal(outs[0], outs[1])
    q = outs[0]
    assert int(of.n_overflows.sum()) == 0
    np.testing.assert_allclose(q.mean(axis=1), val, atol=0.02)
    err = q - val
    assert np.max(np.abs(err)) <= 5.0
    spec = np.abs(np.fft.rfft(err[0]))
    lo = np.mean(spec[1: n // 64] ** 2)
    hi = np.mean(spec[n // 4:] ** 2)
    assert hi > 10 * lo, f"not HP shaped: lo={lo:.3g} hi={hi:.3g}"


@pytest.mark.parametrize("fmt", [f.name for f in TS.SampleFormat])
def test_codecs_match_reference_byte_for_byte(fmt):
    f, jf = TS.SampleFormat[fmt], JS.SampleFormat[fmt]
    rng = np.random.default_rng(3)
    if f.isfloat:
        x = rng.uniform(-1.5, 1.5, (3, 64))
        raw = F.encode_float(x, f)
        assert raw == JF.encode_float(x, jf)
    else:
        q = rng.integers(f.imin, f.imax + 1, size=(3, 64)).astype(np.int32)
        raw = F.encode_int(q, f)
        assert raw == JF.encode_int(q, jf)
        assert len(raw) == 3 * 64 * f.bytes
        with pytest.raises(ValueError):
            F.encode_float(q, f)
    raw += b"\x01" * (f.bytes * 3 - 1)  # a partial frame is dropped
    for dt in (np.float32, np.float64):
        got = F.decode(raw, f, 3, dtype=dt)
        _equal(got, JF.decode(raw, jf, 3, dtype=dt))
        assert got.dtype == dt and got.shape == (3, 64)
    _equal(F.input_stage(raw, f, 3), JF.input_stage(raw, jf, 3))


@pytest.mark.parametrize("fmt", ["FLOAT_LE", "S16_LE", "S24_4BE"])
def test_output_stage_matches_reference(fmt):
    f, jf = TS.SampleFormat[fmt], JS.SampleFormat[fmt]
    y = np.random.default_rng(4).uniform(-1.3, 1.3, (2, 300))
    tof = D.init_overflow_stats(2, dtype=torch.float64, device="cpu")
    jof = JD.init_overflow_stats(2, dtype=np.float64)
    tq, tof, _ = F.output_stage(torch.from_numpy(y), f, tof)
    jq, jof, _ = JF.output_stage(jnp.asarray(y), jf, jof)
    _equal(tq, jq)
    for g, r in zip(tof, jof):
        _equal(g, r)
    assert int(tof.n_overflows.sum()) > 0


def _impulse_wav(tmp_path, seed, taps=300):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((2, taps)) * np.exp(-np.arange(taps) / 60.0)
         * 0.3).astype(np.float32)
    path = str(tmp_path / f"h{seed}.wav")
    wavio.write(path, h.T, 44100, subtype="float32")
    return path, h.astype(np.float64)


def _config(path, spec=TS, dtype="float64", in_fmt="FLOAT_LE",
            out_fmt="S16_LE", dither=False):
    files = ((spec.ImpulseFileSpec(enabled=True, filename=path),)
             if path else ()) + (spec.ImpulseFileSpec(),) * (3 - bool(path))
    return spec.EngineConfig(
        filter=spec.FilterSpec(block_length=256, dtype=dtype),
        stream=spec.StreamSpec(n_channels=2, sample_rate=44100,
                               in_format=spec.SampleFormat[in_fmt],
                               out_format=spec.SampleFormat[out_fmt],
                               apply_dither=dither),
        chain=spec.ChainSpec(files=files))


@pytest.mark.parametrize("dtype,in_fmt", [("float64", "FLOAT_LE"),
                                          ("float64", "S24_LE"),
                                          ("float32", "FLOAT_LE")])
def test_process_raw_s16_matches_reference(tmp_path, dtype, in_fmt):
    """S16 without dither, raw bytes in uneven frame counts: byte-equal to
    the reference at float64; at float32 a few samples straddle a rounding
    boundary and differ by one LSB."""
    path, h = _impulse_wav(tmp_path, 20)
    jsp = JaxStreamProcessor(_config(path, JS, dtype, in_fmt),
                             JaxArtifactCache(str(tmp_path / "j")))
    tsp = StreamProcessor(_config(path, TS, dtype, in_fmt),
                          ArtifactCache(str(tmp_path / "t")), device="cpu")
    fi = TS.SampleFormat[in_fmt]
    x = np.random.default_rng(21).uniform(-0.2, 0.2, (2, 9 * 256 + 17))
    raw = (F.encode_float(x, fi) if fi.isfloat
           else F.encode_int(np.round(x * fi.full_scale).astype(np.int32), fi))
    frame = 2 * fi.bytes
    cuts = [0, 300 * frame, 1000 * frame, len(raw)]
    outs_t = [tsp.process_raw(raw[a:b]) for a, b in zip(cuts, cuts[1:])]
    outs_j = [jsp.process_raw(raw[a:b]) for a, b in zip(cuts, cuts[1:])]
    # a call that completes no block returns no bytes (the reference's
    # output stage refuses an empty block)
    assert tsp.process_raw(raw[:frame - 1]) == b""
    assert [len(o) for o in outs_t] == [len(o) for o in outs_j]
    bt, bj = b"".join(outs_t), b"".join(outs_j)
    assert len(bt) == 2 * 2 * 9 * 256
    qt = np.frombuffer(bt, "<i2").astype(np.int64)
    qj = np.frombuffer(bj, "<i2").astype(np.int64)
    if dtype == "float64":
        assert bt == bj
    else:
        assert np.abs(qt - qj).max() <= 1
        assert np.count_nonzero(qt != qj) <= qt.size // 200
    assert tsp.raw_seconds["engine"] > 0
    y = F.decode(bt, TS.SampleFormat.S16_LE, 2)
    xd = F.decode(raw, fi, 2)
    ref = np.stack([np.convolve(xd[c], h[c])[: y.shape[1]] for c in range(2)])
    assert np.abs(y - ref).max() <= 1.0 / 32768 + 1e-6
    for g, r in zip(tsp.overflow_stats(), jsp.overflow_stats()):
        _equal(g, r)


def test_process_raw_s16_dither(tmp_path):
    """As tests/test_engine.py:228-241: dithered S16 output within 5 LSB of
    the exact result (a 0.5 gain), on the port's own generator."""
    h = np.zeros((2, 4))
    h[:, 0] = 0.5
    path = str(tmp_path / "half.wav")
    wavio.write(path, h.T, 44100, subtype="float32")
    sp = StreamProcessor(_config(path, dither=True),
                         ArtifactCache(str(tmp_path / "c")), device="cpu")
    x = np.random.default_rng(5).uniform(-0.5, 0.5, (2, 512))
    raw_out = sp.process_raw(F.encode_float(x, TS.SampleFormat.FLOAT_LE))
    y = F.decode(raw_out, TS.SampleFormat.S16_LE, 2)
    np.testing.assert_allclose(y, 0.5 * x, atol=5 / 32768.0)
    assert sp._dither_state is not None
    assert np.abs(y - 0.5 * x).std() * 32768 > 0.5  # dither, not rounding


def test_process_raw_passthrough_int_format(tmp_path):
    """As tests/test_engine.py:443: with no chain the stream passes through,
    still quantized (and dithered) to the output format."""
    cfg = _config(None, dither=True)
    sp = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "pc")),
                         device="cpu")
    jsp = JaxStreamProcessor(_config(None, JS, dither=True),
                             JaxArtifactCache(str(tmp_path / "pj")))
    x = np.random.default_rng(14).uniform(-0.4, 0.4, (2, 256))
    raw_in = F.encode_float(x, TS.SampleFormat.FLOAT_LE)
    y = F.decode(sp.process_raw(raw_in), TS.SampleFormat.S16_LE, 2)
    np.testing.assert_allclose(y, x, atol=5 / 32768.0)
    yj = F.decode(jsp.process_raw(raw_in), TS.SampleFormat.S16_LE, 2)
    np.testing.assert_allclose(y, yj, atol=10 / 32768.0)
    # without dither the passthrough bytes equal the reference's
    cfg_nd = dataclasses.replace(cfg, stream=dataclasses.replace(
        cfg.stream, apply_dither=False))
    sp2 = StreamProcessor(cfg_nd, ArtifactCache(str(tmp_path / "pc")),
                          device="cpu")
    jsp2 = JaxStreamProcessor(_config(None, JS),
                              JaxArtifactCache(str(tmp_path / "pj")))
    assert sp2.process_raw(raw_in) == jsp2.process_raw(raw_in)


def test_render_cli_dither_and_delay_match_reference(tmp_path, monkeypatch):
    """``--out-format pcm16 --delay 0,3`` writes the reference CLI's WAV
    sample for sample (float64, no dither); ``--dither`` stays within 5 LSB
    of it; ``--subdelay`` takes the fractional line."""
    monkeypatch.setenv("HOME", str(tmp_path))  # the sessions' default cache
    rng = np.random.default_rng(30)
    ir, _ = _impulse_wav(tmp_path, 31, taps=700)
    x = (0.05 * rng.standard_normal((3000, 2))).astype(np.float32)
    inp = str(tmp_path / "in.wav")
    wavio.write(inp, x, 44100, subtype="float32")
    common = ["--impulse", ir, "--dtype", "float64", "--block", "256",
              "--out-format", "pcm16", "--delay", "0,3", "--cpu"]
    paths = {k: str(tmp_path / f"{k}.wav") for k in ("j", "t", "td", "js",
                                                     "ts")}
    assert JCLI.main([inp, paths["j"], *common]) == 0
    assert CLI.main([inp, paths["t"], *common]) == 0
    assert CLI.main([inp, paths["td"], *common, "--dither"]) == 0
    yj, _ = wavio.read(paths["j"])
    yt, _ = wavio.read(paths["t"])
    yd, _ = wavio.read(paths["td"])
    assert yt.shape == yj.shape == yd.shape == x.shape
    _equal(yt, yj)
    assert np.abs(yd - yt).max() <= 5 / 32768.0
    assert np.abs(yd - yt).max() > 0
    # the delay shifted channel 1 by three samples
    assert np.abs(yt[:3, 1]).max() == 0 and np.abs(yt[3:10, 1]).max() > 0
    sub = ["--subdelay", "8"]
    assert JCLI.main([inp, paths["js"], *common, *sub]) == 0
    assert CLI.main([inp, paths["ts"], *common, *sub]) == 0
    _equal(wavio.read(paths["ts"])[0], wavio.read(paths["js"])[0])


def test_quantizer_refuses_other_devices():
    """A tensor off the CPU never takes the plain loop: the wrapper checks
    it for the kernel and raises (here on the meta device)."""
    x = torch.zeros((2, 8), device="meta")
    v = torch.zeros(2, device="meta")
    n = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        DK.quantize_hp_tpdf(x, x, v, v, -128.0, 127.0, n, v, n)
