"""bfir_tpu_torch ops, convolver and coefficient builds against bfir_tpu on
the same numpy inputs (CPU).

Tolerances, relative to max|reference|: float64 paths 1e-12 (FFT
round-off); float32 coefficient planes 1e-6 (one float32 FFT each, in
different libraries); integer planes 1 LSB (their float32 inputs differ by
round-off)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bfir_tpu.core import convolver as JCV
from bfir_tpu.core import nonuniform as JNU
from bfir_tpu.core.spec import FilterSpec
from bfir_tpu_torch.core.spec import FilterSpec as TFilterSpec
from bfir_tpu.kernels import spectrum_mac as JK
from bfir_tpu.ops import equalizer as JEQ
from bfir_tpu.ops import fft as JF
from bfir_tpu.ops import firwindow as JFW
from bfir_tpu.ops import formats as JFM
from bfir_tpu.ops import dither as JDT
from bfir_tpu.ops import resample as JRS
from bfir_tpu_torch import convert
from bfir_tpu_torch.core import convolver as CV
from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.ops import dither as DT
from bfir_tpu_torch.ops import equalizer as EQ
from bfir_tpu_torch.ops import fft as F
from bfir_tpu_torch.ops import firwindow as FW
from bfir_tpu_torch.ops import formats as FM
from bfir_tpu_torch.ops import resample as RS

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends: XLA's CPU
    compiler has aborted xdist workers late in full runs once many
    executables had accumulated in one process (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


def _close(got, ref, rel):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("n", [64, 2048])
def test_fft_layouts_match_reference(n):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, n))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for jo, to in zip(JF.rfft_split(jx), F.rfft_split(tx)):
        _close(to, jo, 1e-12)
    jhr, jhi = JF.rfft_split_hc(jx)
    thr, thi = F.rfft_split_hc(tx)
    _close(thr, jhr, 1e-12)
    _close(thi, jhi, 1e-12)
    yr, yi = JF.rfft_split(jx)
    _close(F.irfft_split(torch.tensor(np.asarray(yr)),
                         torch.tensor(np.asarray(yi))),
           JF.irfft_split(yr, yi), 1e-12)
    # lane-padded halfcomplex planes: extra lanes are ignored
    pad = np.full((3, 128), 3.0)
    phr = torch.from_numpy(np.concatenate([np.asarray(jhr), pad], 1))
    phi = torch.from_numpy(np.concatenate([np.asarray(jhi), pad], 1))
    _close(F.irfft_split_hc(phr, phi, n), JF.irfft_split_hc(jhr, jhi, n), 1e-12)
    _close(F.irfft_hc_tail(phr, phi, n), JF.irfft_hc_tail(jhr, jhi, n), 1e-12)
    _close(F.irfft_hc_tail(thr, thi, n), x[:, n // 2:], 1e-12)


def test_fir_design_ops_match_reference():
    x = np.linspace(-1.2, 1.2, 41)
    _close(FW.kaiser_window(x, 7.5), JFW.kaiser_window(x, 7.5), 1e-12)
    for length, off in [(33, 0.0), (32, 0.0), (31, 0.3)]:
        np.testing.assert_array_equal(FW.window_positions(length, off),
                                      JFW.window_positions(length, off))
    _close(FW.apply_kaiser(np.ones(31), 6.0, 0.3),
           JFW.apply_kaiser(np.ones(31), 6.0, 0.3), 1e-12)
    _close(FW.design_lowpass(63, 0.2), JFW.design_lowpass(63, 0.2), 1e-15)
    assert FW.kaiser_beta_for_attenuation(120.0) == \
        JFW.kaiser_beta_for_attenuation(120.0)
    mags = np.linspace(-6.0, 6.0, 31)
    fir = EQ.render_fir(1024, mags, 44100)
    _close(fir, JEQ.render_fir(1024, mags, 44100), 1e-12)
    # "accurate" is the full linear-phase impulse whose upper half is "reference"
    full = EQ.render_fir(1024, mags, 44100, mode="accurate")
    np.testing.assert_array_equal(full[512:].numpy(), fir.numpy())
    sig = np.random.default_rng(11).standard_normal((2, 300))
    _close(RS.resample(sig, 44100, 48000, dtype=torch.float64),
           JRS.resample(sig, 44100, 48000, dtype=jnp.float64), 1e-12)


def test_count_float_overflow_matches_reference():
    x = np.random.default_rng(12).standard_normal((3, 256)).astype(np.float32)
    jo = JFM.count_float_overflow(jnp.asarray(x), JDT.init_overflow_stats(3))
    to = FM.count_float_overflow(torch.from_numpy(x),
                                 DT.init_overflow_stats(3, device="cpu"))
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("split", [None, 37])
def test_count_float_overflow_host_matches_reference(dtype, split):
    """The host count, one call or two split at a column, against the
    reference's count of the whole: a NaN, an Inf and a -Inf past the
    first sample, exact full scale (no count), and a quiet channel."""
    x = (1.5 * np.random.default_rng(14).standard_normal((4, 256))
         ).astype(dtype)
    x[0, 5], x[0, 90] = np.nan, np.inf
    x[1, 60], x[1, 200] = -np.inf, 1.0
    x[2] = np.where(np.arange(256) % 2, 1.0, -1.0)
    x[3] *= 0.1
    jo = JFM.count_float_overflow(
        jnp.asarray(x), JDT.init_overflow_stats(4, dtype=dtype))
    of = DT.OverflowStats(*(
        np.asarray(t) for t in JDT.init_overflow_stats(4, dtype=dtype)))
    for part in ([x] if split is None else [x[:, :split], x[:, split:]]):
        of = FM.count_float_overflow_host(part, of)
    # the reference's int32 sum widens to int64 under x64; the port's
    # count stays int32, as its device count does
    assert of.n_overflows.dtype == np.int32
    for name, a, b in zip(of._fields, of, jo):
        b = np.asarray(b)
        if name == "n_overflows":
            b = b.astype(np.int32)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert of.largest.dtype == dtype
    assert np.isnan(of.largest[0]) and np.isposinf(of.largest[1])
    assert of.largest[2] == 1.0 and of.n_overflows[2] == 0
    assert of.n_overflows[3] == 0 and of.n_overflows[1] > 1


def test_complex_convolver_matches_reference():
    rng = np.random.default_rng(13)
    spec = FilterSpec(block_length=64, n_partitions=4, dtype="float64")
    tspec = TFilterSpec(block_length=64, n_partitions=4, dtype="float64")
    h = rng.standard_normal((2, 230))
    h2 = rng.standard_normal((2, 256))
    x = rng.standard_normal((7, 2, 64))
    jco = JCV.coeffs_to_spectra(h, spec, scale=0.5)
    tco = CV.coeffs_to_spectra(h, tspec, scale=0.5, device="cpu")
    _close(torch.view_as_real(tco), np.stack([np.real(jco), np.imag(jco)], -1),
           1e-12)
    jst, jy = JCV.process_blocks(JCV.init_state(spec, 2), jco, jnp.asarray(x))
    tst, ty = CV.process_blocks(CV.init_state(tspec, 2, device="cpu"), tco,
                                torch.from_numpy(x))
    _close(ty, jy, 1e-12)
    assert tst.blockcounter == int(jst.blockcounter) == 7
    jco2 = JCV.coeffs_to_spectra(h2, spec)
    tco2 = CV.coeffs_to_spectra(h2, tspec, device="cpu")
    jst, jy = JCV.step_crossfade(jst, jco, jco2, jnp.asarray(x[0]))
    tst, ty = CV.step_crossfade(tst, tco, tco2, torch.from_numpy(x[0]))
    _close(ty, jy, 1e-12)
    _close(CV.direct_convolve_spectra(h, h2, max_taps=300),
           JCV.direct_convolve_spectra(h, h2, max_taps=300), 1e-12)


@pytest.mark.parametrize("precise,shared,store", [
    (False, False, "int24"), (True, False, "float32"), (False, True, "int16")])
def test_hc_and_nu_coeffs_match_reference(precise, shared, store):
    rng = np.random.default_rng(14)
    rows = 1 if shared else 3
    spec = FilterSpec(block_length=64, n_partitions=5, dtype="float32")
    tspec = TFilterSpec(block_length=64, n_partitions=5, dtype="float32")
    h = rng.standard_normal((rows, 300)).astype(np.float32)
    _close(K.hc_coeffs(h, tspec, 3, scale=0.7, precise=precise, shared=shared,
                       device="cpu"),
           JK.hc_coeffs(h, spec, 3, scale=0.7, precise=precise, shared=shared),
           1e-6)
    jspec = JNU.NuSpec(block_length=32, ratio=2, p_head=4, p_tail=3,
                       tail_store=store)
    tspec = NU.NuSpec(block_length=32, ratio=2, p_head=4, p_tail=3,
                      tail_store=store)
    hn = rng.standard_normal((rows, jspec.max_taps - 5)).astype(np.float32)
    jco = jax.tree_util.tree_map(
        np.asarray, JNU.nu_coeffs(hn, jspec, 3, precise=precise,
                                  shared=shared))
    tco = convert.nu_coeffs_to_numpy(
        NU.nu_coeffs(hn, tspec, 3, precise=precise, shared=shared,
                     device="cpu"))
    _close(tco.head, jco.head, 1e-6)
    if store == "float32":
        _close(tco.tail, jco.tail, 1e-6)
    else:
        assert isinstance(tco.tail, K.IntPlanes)
        assert (tco.tail.lo is None) == (store == "int16")
        dq = K.dequantize_planes(
            convert.planes_from_numpy(tco.tail, "cpu")).numpy()
        jdq = np.asarray(JK.dequantize_planes(jco.tail))
        # the f32 planes differ by round-off, so q may differ by 1 LSB
        lsb = jco.tail.scale[..., :1]
        assert np.all(np.abs(dq - jdq) <= 1.001 * lsb + 1e-6 * np.abs(jdq).max())
    with pytest.raises(ValueError, match="max_taps"):
        NU.nu_coeffs(np.zeros((1, tspec.max_taps + 1)), tspec, 3, device="cpu")
