"""The last of the reference's public API in bfir_tpu_torch, on CPU against
bfir_tpu: the generic and leading-axis transforms of ``ops/fft`` (the
reference's own ``tests/test_fft.py`` cases, run on both packages and held
to numpy), the host helpers, ``utils/profiling``'s ``BlockTimer.measure``
and ``trace``, and ``step_nu``'s pinned ``phase``.

The reference's transforms run on its matmul route, as its tests force
them. Tolerances are the reference tests': 1e-9 to 1e-11 relative at
complex128, 5e-6 at complex64; the step at f32 rounding (1e-5 of the
peak)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bfir_tpu.core import nonuniform as JNU
from bfir_tpu.ops import fft as JF
from bfir_tpu.utils import profiling as JP
from bfir_tpu_torch import convert
from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.ops import fft as F
from bfir_tpu_torch.utils import profiling as P

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends (see
    tests/test_torch_kernels.py)."""
    yield
    jax.clear_caches()


@pytest.fixture
def matmul():
    """The reference on its matmul route, as tests/test_fft.py runs it."""
    JF.set_mode("matmul")
    yield
    JF.set_mode("auto")


def _t(x):
    return F.from_numpy_complex(x, device="cpu")


def _rel(got, ref):
    return np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-30)


def _cplx(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def test_cfft_axis0_matches_numpy(matmul):
    # tests/test_fft.py:49
    rng = np.random.default_rng(3)
    y = _cplx(rng, (16, 4, 9))
    ref = np.fft.fft(y, n=32, axis=0)
    ref_i = np.fft.ifft(ref, axis=0)
    for fft, ifft, conv in ((JF.fft, JF.ifft, np.asarray),
                            (F.fft, F.ifft, F.to_numpy)):
        src = y if fft is JF.fft else _t(y)
        got = fft(src, n=32, axis=0)
        np.testing.assert_allclose(conv(got), ref, atol=1e-9)
        np.testing.assert_allclose(conv(ifft(got, axis=0)), ref_i, atol=1e-10)


@pytest.mark.parametrize("m,n", [(512, None), (1024, None), (255, 512),
                                 (700, 128)])
@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-11),
                                       (np.complex64, 5e-6)])
def test_cfft_axis0_forms_match_numpy(matmul, m, n, dtype, tol):
    # tests/test_fft.py:62: fft/ifft along axis 0 and the leading-axis
    # forms, padded and truncated
    rng = np.random.default_rng(7)
    y = _cplx(rng, (m, 3, 17), dtype)
    for inverse in (False, True):
        ref = (np.fft.ifft if inverse else np.fft.fft)(y, n=n, axis=0)
        for mod, src in ((JF, JF.from_numpy_complex(y)), (F, _t(y))):
            fn = mod.ifft if inverse else mod.fft
            fn0 = mod.ifft0 if inverse else mod.fft0
            assert _rel(mod.to_numpy(fn(src, n=n, axis=0)), ref) < tol
            assert _rel(mod.to_numpy(fn0(src, n=n)), ref) < tol
        assert F.fft0(_t(y), n=n).dtype == _t(y).dtype


@pytest.mark.parametrize("m,start,count", [(512, 127, 128), (512, 0, 512),
                                           (512, 500, 12), (100, 7, 50)])
def test_ifft0_slice_matches_numpy(matmul, m, start, count):
    # tests/test_fft.py:81
    rng = np.random.default_rng(8)
    y = _cplx(rng, (m, 5, 9))
    ref = np.fft.ifft(y, axis=0)[start:start + count]
    for mod, src in ((JF, JF.from_numpy_complex(y)), (F, _t(y))):
        got = mod.to_numpy(mod.ifft0_slice(src, start, count))
        assert _rel(got, ref) < 1e-11


@pytest.mark.parametrize("start,count", [(-1, 4), (10, 0), (500, 13)])
def test_ifft0_slice_out_of_range(matmul, start, count):
    y = _cplx(np.random.default_rng(9), (512, 2))
    for mod, src in ((JF, JF.from_numpy_complex(y)), (F, _t(y))):
        with pytest.raises(ValueError, match="out of range"):
            mod.ifft0_slice(src, start, count)


@pytest.mark.parametrize("m", [64, 256, 512, 2048])
def test_irfft_tail_matches_full(matmul, m):
    # tests/test_fft.py:104: the upper half only, split and complex forms
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, m))
    y = np.fft.rfft(x, axis=-1)
    for mod, yr, yi, yc in (
            (JF, jnp.asarray(y.real), jnp.asarray(y.imag),
             JF.from_numpy_complex(y)),
            (F, torch.from_numpy(y.real.copy()),
             torch.from_numpy(y.imag.copy()), _t(y))):
        got = mod.to_numpy(mod.irfft_split_tail(yr, yi, n=m))
        np.testing.assert_allclose(got, x[..., m // 2:], atol=1e-10)
        got_c = mod.to_numpy(mod.irfft_tail(yc, n=m))
        np.testing.assert_allclose(got_c, x[..., m // 2:], atol=1e-10)


@pytest.mark.parametrize("m,n", [(64, None), (64, 128), (100, 64)])
def test_irfft_tail_padded(m, n):
    # n pads or truncates the half spectrum as irfft does
    rng = np.random.default_rng(10)
    y = _cplx(rng, (2, m // 2 + 1))
    k = n or m
    ref = np.fft.irfft(y, n=k, axis=-1)[..., k // 2:]
    np.testing.assert_allclose(F.to_numpy(F.irfft_tail(_t(y), n=n)), ref,
                               atol=1e-12)
    got = F.irfft_split_tail(_t(y.real.copy()), _t(y.imag.copy()), n=n)
    np.testing.assert_allclose(F.to_numpy(got), ref, atol=1e-12)


@pytest.mark.parametrize("m,n,cols", [(512, None, None), (512, None, (3, 100)),
                                      (100, 128, (64, 64)), (300, 256, None),
                                      (1024, None, (1000, 24))])
@pytest.mark.parametrize("inverse", [False, True])
def test_cfft_split_cols(matmul, m, n, cols, inverse):
    rng = np.random.default_rng(11)
    y = _cplx(rng, (3, m))
    ref = (np.fft.ifft if inverse else np.fft.fft)(y, n=n, axis=-1)
    if cols is not None:
        ref = ref[..., cols[0]:cols[0] + cols[1]]
    for mod, yr, yi in ((JF, jnp.asarray(y.real), jnp.asarray(y.imag)),
                        (F, _t(y.real.copy()), _t(y.imag.copy()))):
        gr, gi = mod.cfft_split(yr, yi, n=n, inverse=inverse, cols=cols)
        got = mod.to_numpy(gr) + 1j * mod.to_numpy(gi)
        assert got.shape == ref.shape
        assert _rel(got, ref) < 1e-11


@pytest.mark.parametrize("m,n,rows", [(512, None, None), (512, None, (127, 128)),
                                      (255, 512, (0, 300)), (700, 128, (1, 9))])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-11),
                                       (np.complex64, 5e-6)])
def test_fft0_split_rows(matmul, m, n, rows, inverse, dtype, tol):
    rng = np.random.default_rng(12)
    y = _cplx(rng, (m, 3, 5), dtype)
    ref = (np.fft.ifft if inverse else np.fft.fft)(y, n=n, axis=0)
    if rows is not None:
        ref = ref[rows[0]:rows[0] + rows[1]]
    for mod, yr, yi in ((JF, jnp.asarray(y.real), jnp.asarray(y.imag)),
                        (F, _t(y.real.copy()), _t(y.imag.copy()))):
        gr, gi = mod.fft0_split(yr, yi, n=n, inverse=inverse, rows=rows)
        got = mod.to_numpy(gr) + 1j * mod.to_numpy(gi)
        assert got.shape == ref.shape
        assert _rel(got, ref) < tol


@pytest.mark.parametrize("sel", [(-1, 4), (0, 0), (510, 3)])
def test_split_selections_out_of_range(matmul, sel):
    # cols raise in both packages; rows as the reference's matmul route
    # raises (through cfft_split)
    y = np.random.default_rng(13).standard_normal((512, 512))
    for mod, yr in ((JF, jnp.asarray(y)), (F, _t(y))):
        with pytest.raises(ValueError, match="out of range"):
            mod.cfft_split(yr, yr, cols=sel)
        with pytest.raises(ValueError, match="out of range"):
            mod.fft0_split(yr, yr, rows=sel)


@pytest.mark.parametrize("m,n", [(64, None), (100, 128), (256, 200)])
def test_rfft_irfft_axis0(m, n):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((m, 3, 4))
    ref = np.fft.rfft(x, n=n, axis=0)
    got = F.rfft(torch.from_numpy(x), n=n, axis=0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)
    np.testing.assert_allclose(np.asarray(JF.rfft(jnp.asarray(x), n=n, axis=0)),
                               ref, atol=1e-10)
    k = n or m
    back = F.irfft(got, n=k, axis=0)
    np.testing.assert_allclose(back.numpy(), np.fft.irfft(ref, n=k, axis=0),
                               atol=1e-12)


def test_host_helpers():
    z = F.czeros((3, 4), device="cpu")
    assert z.dtype == torch.complex64 and z.device.type == "cpu"
    assert not z.abs().any()
    assert F.czeros((2,), torch.complex128, device="cpu").dtype == \
        torch.complex128
    rng = np.random.default_rng(15)
    for x in (_cplx(rng, (5, 7)), _cplx(rng, (5, 7), np.complex64),
              rng.standard_normal((4, 3)).astype(np.float32),
              _cplx(rng, (6, 8))[:, ::-2]):  # a negative-stride view
        t = F.from_numpy_complex(x, device="cpu")
        assert t.device.type == "cpu"
        back = F.to_numpy(t)
        assert back.dtype == x.dtype
        np.testing.assert_array_equal(back, x)
        np.testing.assert_array_equal(
            back, JF.to_numpy(JF.from_numpy_complex(x)))
    assert F.to_numpy(np.arange(3)).tolist() == [0, 1, 2]


def test_block_timer_measure_result():
    for mod in (JP, P):
        timer = mod.BlockTimer()
        x = torch.ones(8) if mod is P else jnp.ones(8)
        for _ in range(3):
            with timer.measure(x * 2):
                pass
        with timer.measure():
            pass
        with timer.measure({"a": (torch.ones(2), [torch.zeros(1)])}
                           if mod is P else None):
            pass
        assert timer.count == 5
        p = timer.percentiles()
        assert 0 <= p[50] <= p[95] <= p[99]


def test_trace_writes_a_file(tmp_path):
    with P.trace(str(tmp_path / "log")) as prof:
        F.rfft(torch.ones(4, 64))
    assert prof is not None
    files = os.listdir(tmp_path / "log")
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(tmp_path / "log" / files[0]) > 0
    # a body that raises still leaves its trace
    with pytest.raises(RuntimeError, match="body"):
        with P.trace(str(tmp_path / "log")):
            raise RuntimeError("body")
    assert len(os.listdir(tmp_path / "log")) == 2


GEOM = dict(block_length=32, ratio=4, p_head=8, p_tail=3)
C = 2


def _close(got, ref, rel=1e-5):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def test_step_nu_pinned_phase_matches_reference():
    """From one mid-cycle state (phase 1), every pinned phase k through both
    packages' ``step_nu``: the block lands in ``inbuf`` at k * N and the
    tail fires only at k = R - 1, whatever the counter says."""
    jspec, tspec = JNU.NuSpec(**GEOM), NU.NuSpec(**GEOM)
    rng = np.random.default_rng(16)
    h = (rng.standard_normal((C, jspec.max_taps - 10))
         * np.exp(-np.arange(jspec.max_taps - 10) / 200.0)).astype(np.float32)
    x = rng.standard_normal((14, C, GEOM["block_length"])).astype(np.float32)
    jco = JNU.nu_coeffs(h, jspec, C)
    tco = NU.nu_coeffs(h, tspec, C, device="cpu")
    jst, _ = JNU.process_blocks_nu(JNU.init_nu_state(jspec, C), jco,
                                   jnp.asarray(x[:13]), use_pallas=False)
    host = jax.tree_util.tree_map(np.asarray, jst)
    assert int(host.head.blockcounter) % GEOM["ratio"] == 1
    blk = x[13]
    for k in range(GEOM["ratio"]):
        jend, jy = JNU.step_nu(jst, jco, jnp.asarray(blk), use_pallas=False,
                               phase=k)
        tend, ty = NU.step_nu(convert.nu_state_from_numpy(host, "cpu"), tco,
                              torch.from_numpy(blk), phase=k)
        _close(ty, jy)
        j = jax.tree_util.tree_map(np.asarray, jend)
        t = convert.nu_state_to_numpy(tend)
        _close(t.inbuf, j.inbuf, 0)
        _close(t.pending, j.pending)
        _close(t.tail.ring, j.tail.ring)
        assert int(t.tail.blockcounter) == int(j.tail.blockcounter)
        fired = int(t.tail.blockcounter) > int(host.tail.blockcounter)
        assert fired == (k == GEOM["ratio"] - 1)
    # None takes the counter's phase: the same as pinning phase 1
    _, y_none = NU.step_nu(convert.nu_state_from_numpy(host, "cpu"), tco,
                           torch.from_numpy(blk))
    _, y_one = NU.step_nu(convert.nu_state_from_numpy(host, "cpu"), tco,
                          torch.from_numpy(blk), phase=1)
    assert torch.equal(y_none, y_one)
    for bad in (-1, GEOM["ratio"]):
        with pytest.raises(ValueError, match="phase"):
            NU.step_nu(convert.nu_state_from_numpy(host, "cpu"), tco,
                       torch.from_numpy(blk), phase=bad)
