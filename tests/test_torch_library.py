"""bfir_tpu_torch's small library pieces on CPU against bfir_tpu: EQ presets,
the coefficient loaders, the stream checkpoint, ``spectra_to_impulse``,
``render_eq_spec`` and ``resample_to``, each on the same inputs as the
reference.

Tolerances: files and integers byte for byte; float64 arithmetic within
1e-12 x max|reference| (FFTs summed in other orders); a checkpoint resumed
in the same package bit for bit."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bfir_tpu.core import convolver as jcv
from bfir_tpu.core import spec as JS
from bfir_tpu.engine import checkpoint as jck
from bfir_tpu.engine import presets as jpresets
from bfir_tpu.io import coeffio as jcoeffio
from bfir_tpu.io.flacio import write_flac
from bfir_tpu.ops import dither as jdth
from bfir_tpu.ops import equalizer as jeq
from bfir_tpu.ops import resample as jrs
from bfir_tpu_torch.core import convolver as cv
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine import checkpoint as ck
from bfir_tpu_torch.engine import presets
from bfir_tpu_torch.io import coeffio, wavio
from bfir_tpu_torch.ops import dither as dth
from bfir_tpu_torch.ops import equalizer as eq
from bfir_tpu_torch.ops import formats as fm
from bfir_tpu_torch.ops import resample as rs
from bfir_tpu_torch.utils.logging import set_print_callback

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


def _close(got, ref, rel=1e-12):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


# -- presets ------------------------------------------------------------------


def test_preset_round_trip_and_reference_files(tmp_path):
    mags = tuple(range(-15, 16))
    teq = TS.EqSpec(enabled=True, level_steps=-35, mag_steps=mags)
    jeqs = JS.EqSpec(enabled=True, level_steps=-35, mag_steps=mags)
    assert presets.eq_to_preset_json(teq) == jpresets.eq_to_preset_json(jeqs)
    p = str(tmp_path / "port.json")
    presets.save_preset(p, teq)
    data = json.load(open(p))
    assert set(data) == {"cfg_eq_level", "cfg_eq_mag"}
    assert presets.load_preset(p) == teq
    back = jpresets.load_preset(p)  # the port's file in the reference
    assert (back.level_steps, back.mag_steps) == (-35, mags)
    q = str(tmp_path / "ref.json")
    jpresets.save_preset(q, jeqs)
    assert open(q).read() == open(p).read()
    assert presets.load_preset(q, enabled=False) == TS.EqSpec(
        enabled=False, level_steps=-35, mag_steps=mags)
    flat = '{"cfg_eq_level": 0, "cfg_eq_mag": "' + ",".join(["0"] * 31) + '"}'
    assert presets.eq_from_preset_json(flat).mag_steps == (0,) * 31
    with pytest.raises(ValueError, match="bands"):
        presets.eq_from_preset_json('{"cfg_eq_mag": "1,2,3"}')


# -- coefficient loaders ------------------------------------------------------


def test_coeffio_loaders_match_reference(tmp_path):
    np.testing.assert_array_equal(coeffio.load_dirac(3, 64),
                                  jcoeffio.load_dirac(3, 64))
    txt = tmp_path / "c.txt"
    txt.write_text("# comment\n0.5\n-0.25\n0.125 0.0625\n\n; also\n1e-3\n")
    np.testing.assert_array_equal(coeffio.load_text(str(txt)),
                                  jcoeffio.load_text(str(txt)))
    (tmp_path / "empty.txt").write_text("# nothing\n")
    with pytest.raises(ValueError, match="no coefficients"):
        coeffio.load_text(str(tmp_path / "empty.txt"))

    rng = np.random.default_rng(0)
    q = rng.integers(-2 ** 23, 2 ** 23, size=(2, 100)).astype(np.int32)
    raw = tmp_path / "c.raw"
    raw.write_bytes(fm.encode_int(q, TS.SampleFormat.S24_LE))
    got = coeffio.load_raw(str(raw), TS.SampleFormat.S24_LE, n_channels=2)
    np.testing.assert_array_equal(
        got, jcoeffio.load_raw(str(raw), JS.SampleFormat.S24_LE, 2))
    np.testing.assert_array_equal(got * 2.0 ** 23, q)

    imp = rng.standard_normal((2, 50)) * 0.1
    wav = str(tmp_path / "c.wav")
    wavio.write(wav, imp.T, 44100, subtype="float64")
    flac = str(tmp_path / "c.flac")
    write_flac(flac, imp.T, 44100, bps=24)
    for path in (wav, flac):
        for taps in (None, 20):
            np.testing.assert_array_equal(
                coeffio.load_sound(path, max_taps=taps),
                jcoeffio.load_sound(path, max_taps=taps))
    np.testing.assert_allclose(coeffio.load_sound(wav), imp, atol=1e-12)

    # dump_text writes the reference's bytes
    for h in (imp, imp[0]):
        coeffio.dump_text(str(tmp_path / "t.txt"), h)
        jcoeffio.dump_text(str(tmp_path / "j.txt"), h)
        assert ((tmp_path / "t.txt").read_bytes()
                == (tmp_path / "j.txt").read_bytes())
    np.testing.assert_array_equal(coeffio.load_text(str(tmp_path / "t.txt")),
                                  imp[:1])


# -- checkpoint ---------------------------------------------------------------

N, P = 64, 4


def _setup(seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, 200))
    x = rng.standard_normal((2, 10 * N))
    return h, x


def _port_run(st, co, x, b0, b1):
    outs = []
    for b in range(b0, b1):
        st, y = cv.step(st, co, torch.from_numpy(x[:, b * N:(b + 1) * N]))
        outs.append(y.numpy())
    return st, np.concatenate(outs, 1)


def _ref_run(st, co, x, b0, b1):
    outs = []
    for b in range(b0, b1):
        st, y = jcv.step(st, co, jnp.asarray(x[:, b * N:(b + 1) * N]))
        outs.append(np.asarray(y))
    return st, np.concatenate(outs, 1)


def _dither_bytes(st, n=300):
    """The next n dither values of each channel."""
    dv, _ = dth.dither_values(st, n, torch.float64)
    return dv.numpy()


def test_checkpoint_resume_bit_exact(tmp_path):
    """Save after 5 blocks, load, resume: outputs, dither values and
    overflow counters equal the uninterrupted run's bit for bit."""
    h, x = _setup(0)
    spec = TS.FilterSpec(block_length=N, n_partitions=P, dtype="float64")
    co = cv.coeffs_to_spectra(h, spec, device="cpu")
    st, _ = _port_run(cv.init_state(spec, 2, device="cpu"), co, x, 0, 5)
    dst = dth.init_dither_state(2, seed=7, dtype=torch.float64, device="cpu")
    _, dst = dth.dither_values(dst, 123, torch.float64)  # an advanced stream
    of = dth.OverflowStats(torch.tensor([3, 0], dtype=torch.int32),
                           torch.tensor([1.5, 0.25], dtype=torch.float64),
                           torch.tensor([8388607, 12], dtype=torch.int32))
    path = str(tmp_path / "ck.npz")
    ck.save_state(path, st, dst, of)
    z = np.load(path)
    assert set(z.files) == {
        "ring_re", "ring_im", "prev_block", "blockcounter", "d_e0", "d_e1",
        "d_prev_byte", "d_key", "d_generator", "d_generator_device", "of_n",
        "of_largest", "of_intlargest"}
    assert str(z["d_generator_device"]) == "cpu"
    np.testing.assert_array_equal(z["d_key"], np.array([0, 7], np.uint32))
    st_b, dst_b, of_b = ck.load_state(path, device="cpu")
    assert st_b.blockcounter == 5
    _, ya = _port_run(st, co, x, 5, 10)
    _, yb = _port_run(st_b, co, x, 5, 10)
    np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(_dither_bytes(dst_b), _dither_bytes(dst))
    for a, b in zip(of_b, of):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ck.load_state(path, device="cuda")


def test_checkpoint_generator_of_other_device_reseeds(tmp_path):
    """A generator state written by the other kind of device is dropped,
    with a log line: the dither reseeds from d_key, the error feedback
    carried over."""
    h, x = _setup(2)
    spec = TS.FilterSpec(block_length=N, n_partitions=P, dtype="float64")
    st = cv.init_state(spec, 2, device="cpu")
    dst = dth.init_dither_state(2, seed=9, dtype=torch.float64, device="cpu")
    _, dst = dth.dither_values(dst, 50, torch.float64)
    path = str(tmp_path / "ck.npz")
    ck.save_state(path, st, dst)
    with np.load(path) as z:
        data = dict(z)
    data["d_generator_device"] = np.array("cuda")
    np.savez(path, **data)
    said = []
    set_print_callback(said.append)
    try:
        _, dst_b, of_b = ck.load_state(path, device="cpu")
    finally:
        set_print_callback(None)
    assert of_b is None
    assert len(said) == 1 and "saved on cuda" in said[0]
    fresh = dth.init_dither_state(2, seed=9, dtype=torch.float64,
                                  device="cpu")
    fresh = fresh._replace(prev_byte=dst_b.prev_byte)
    np.testing.assert_array_equal(_dither_bytes(dst_b), _dither_bytes(fresh))
    np.testing.assert_array_equal(dst_b.e0.numpy(), dst.e0.numpy())


def test_checkpoint_files_cross_between_packages(tmp_path):
    """A reference checkpoint resumes in the port equal to the reference's
    own continuation, and a port checkpoint in the reference."""
    h, x = _setup(1)
    jspec = JS.FilterSpec(block_length=N, n_partitions=P, dtype="float64")
    tspec = TS.FilterSpec(block_length=N, n_partitions=P, dtype="float64")
    jco = jcv.coeffs_to_spectra(h, jspec)
    tco = cv.coeffs_to_spectra(h, tspec, device="cpu")
    jst, _ = _ref_run(jcv.init_state(jspec, 2), jco, x, 0, 5)
    tst, _ = _port_run(cv.init_state(tspec, 2, device="cpu"), tco, x, 0, 5)
    _, jy = _ref_run(jst, jco, x, 5, 10)

    jpath = str(tmp_path / "ref.npz")
    jdst = jdth.init_dither_state(2, seed=3, dtype=jnp.float64)
    jof = jdth.init_overflow_stats(2, dtype=jnp.float64)
    jck.save_state(jpath, jst, jdst, jof)
    st, dst, of = ck.load_state(jpath, device="cpu")
    assert st.blockcounter == 5 and st.spectra_ring.dtype == torch.complex128
    _, ty = _port_run(st, tco, x, 5, 10)
    _close(ty, jy)
    np.testing.assert_array_equal(dst.prev_byte.numpy(),
                                  np.asarray(jdst.prev_byte))
    np.testing.assert_array_equal(dst.e0.numpy(), np.asarray(jdst.e0))
    # no generator state in the file: a generator seeded from d_key
    seed = int(np.asarray(jdst.key)[-1])
    fresh = dth.init_dither_state(2, seed=seed, dtype=torch.float64,
                                  device="cpu")
    fresh = fresh._replace(prev_byte=dst.prev_byte)
    np.testing.assert_array_equal(_dither_bytes(dst), _dither_bytes(fresh))
    for a, b in zip(of, jof):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    tpath = str(tmp_path / "port.npz")
    tdst = dth.init_dither_state(2, seed=5, dtype=torch.float64, device="cpu")
    ck.save_state(tpath, tst, tdst, dth.init_overflow_stats(
        2, torch.float64, device="cpu"))
    jst2, jdst2, jof2 = jck.load_state(tpath)
    assert int(jst2.blockcounter) == 5
    _, jy2 = _ref_run(jst2, jco, x, 5, 10)
    _close(jy2, jy)
    np.testing.assert_array_equal(np.asarray(jdst2.key), [0, 5])
    # the key drives the reference's RNG
    q, jdst3, _ = jdth.quantize_hp_tpdf(jnp.zeros((2, 16), jnp.float64),
                                        -2.0 ** 23, 2.0 ** 23 - 1, jdst2, jof2)
    assert q.shape == (2, 16) and not np.array_equal(jdst3.key, jdst2.key)
    assert jof2.n_overflows.shape == (2,)


# -- spectra_to_impulse, render_eq_spec, resample_to --------------------------


def test_spectra_to_impulse_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 150))
    tspec = TS.FilterSpec(block_length=64, n_partitions=3, dtype="float64")
    jspec = JS.FilterSpec(block_length=64, n_partitions=3, dtype="float64")
    co = cv.coeffs_to_spectra(h, tspec, device="cpu")
    back = cv.spectra_to_impulse(co, tspec)
    assert back.shape == (2, 192) and back.dtype == torch.float64
    _close(back, jcv.spectra_to_impulse(jcv.coeffs_to_spectra(h, jspec),
                                        jspec))
    np.testing.assert_allclose(back[:, :150].numpy(), h, atol=1e-12)
    np.testing.assert_allclose(back[:, 150:].numpy(), 0.0, atol=1e-12)
    p = str(tmp_path / "dump.txt")
    coeffio.dump_text(p, back.numpy())
    np.testing.assert_allclose(coeffio.load_text(p)[0], back[0].numpy(),
                               atol=1e-15)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_render_eq_spec_matches_reference(dtype):
    mags = tuple(int(v) for v in np.linspace(-60, 60, 31))
    fir = eq.render_eq_spec(TS.EqSpec(enabled=True, mag_steps=mags),
                            TS.FilterSpec(block_length=256, n_partitions=4,
                                          dtype=dtype),
                            eq_filter_blocks=8, sample_rate=48000,
                            device="cpu")
    ref = jeq.render_eq_spec(JS.EqSpec(enabled=True, mag_steps=mags),
                             JS.FilterSpec(block_length=256, n_partitions=4,
                                           dtype=dtype),
                             eq_filter_blocks=8, sample_rate=48000)
    assert fir.shape == (256 * 8 // 2,) and fir.dtype == getattr(torch, dtype)
    _close(fir, ref, 1e-12 if dtype == "float64" else 1e-5)


@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 44100),
                                   (44100, 44100)])
def test_resample_to_matches_reference(rates):
    x = np.random.default_rng(5).standard_normal((2, 1000))
    y = rs.resample_to(x, *rates, device="cpu")
    ref = jrs.resample_to(x, *rates)
    assert y.device.type == "cpu"
    _close(y, ref)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rs.resample_to(x, *rates, device="cuda")
