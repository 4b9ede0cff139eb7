"""bfir_tpu_torch FFT family, K14-K18: each wrapper on CPU tensors (its plain
PyTorch version) against the bfir_tpu Pallas kernel in interpret mode, on
the same numpy inputs, at the reference tests' sizes; float64 against
numpy; the overlap-save law of each forward/inverse pair against scipy.

Tolerance: 2e-5 x max|reference|, the reference's own bound against numpy
(tests/test_fft.py), because the two sides round float32 butterflies in
different orders; float64: 1e-12 x max."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import signal

from bfir_tpu.kernels import fft_fused as JFF
from bfir_tpu.kernels import fft_pallas as JFP
from bfir_tpu_torch.kernels import fft_fused as FF
from bfir_tpu_torch.kernels import fft_pallas as FP
from bfir_tpu_torch.kernels import spectrum_mac as K

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends (see
    tests/test_torch_kernels.py)."""
    yield
    jax.clear_caches()


def _close(got, ref, rel=2e-5):
    """Each pair (got, ref) agrees within rel x the largest |ref| of all."""
    got = [np.asarray(g, dtype=np.float64) for g in got]
    ref = [np.asarray(r, dtype=np.float64) for r in ref]
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * scale)


def _hc(x):
    """numpy float64 halfcomplex planes of rfft(x)."""
    h = x.shape[-1] // 2
    y = np.fft.rfft(x.astype(np.float64), axis=-1)
    return y.real[..., :h], np.concatenate([y.real[..., h:h + 1],
                                            y.imag[..., 1:h]], axis=-1)


FORWARD = {  # port wrapper, reference wrapper
    "rfft_hc_fused": (FF.rfft_hc_fused, JFF.rfft_hc_fused),
    "rfft_hc_pallas": (FP.rfft_hc_pallas, JFP.rfft_hc_pallas),
    "rfft_split_hc_balanced": (FF.rfft_split_hc_balanced,
                               JFF.rfft_split_hc_balanced),
}
INVERSE = {
    "irfft_hc_tail_fused": (FF.irfft_hc_tail_fused, JFF.irfft_hc_tail_fused),
    "irfft_hc_tail_pallas": (FP.irfft_hc_tail_pallas,
                             JFP.irfft_hc_tail_pallas),
}


@pytest.mark.parametrize("name, shape", [
    ("rfft_hc_fused", (64, 2048)), ("rfft_hc_fused", (8, 4096)),
    ("rfft_hc_pallas", (64, 2048)), ("rfft_hc_pallas", (129, 2048)),
    ("rfft_hc_pallas", (4, 4096)),
    ("rfft_split_hc_balanced", (64, 2048)),
    ("rfft_split_hc_balanced", (4, 16384)),
])
def test_forward_matches_pallas(name, shape):
    """K15, K18 and K14 under rfft_split_hc_balanced: halfcomplex planes,
    lane 0 = (DC.re, Nyquist.re)."""
    port, ref = FORWARD[name]
    x = np.random.default_rng(41).standard_normal(shape).astype(np.float32)
    jr, ji = ref(jnp.asarray(x), interpret=True)
    tr, ti = port(torch.from_numpy(x))
    assert tr.dtype == torch.float32
    _close((tr, ti), (jr, ji))
    _close((tr, ti), _hc(x))
    assert getattr(port, "launches", 0) == 0
    assert FF.cfft_balanced_fused.launches == 0


@pytest.mark.parametrize("name, rows, n", [
    ("irfft_hc_tail_fused", 16, 2048), ("irfft_hc_tail_fused", 16, 4096),
    ("irfft_hc_tail_pallas", 64, 2048), ("irfft_hc_tail_pallas", 130, 2048),
    ("irfft_hc_tail_pallas", 8, 4096), ("irfft_hc_tail_pallas", 16, 1024),
])
def test_inverse_tail_matches_pallas(name, rows, n):
    """K16 and K17: samples [n/2, n) of the inverse of halfcomplex
    planes; K17 also at its smallest n, 1024 (h = 512)."""
    port, ref = INVERSE[name]
    rng = np.random.default_rng(42)
    hr = rng.standard_normal((rows, n // 2)).astype(np.float32)
    hi = rng.standard_normal((rows, n // 2)).astype(np.float32)
    jy = ref(jnp.asarray(hr), jnp.asarray(hi), n, interpret=True)
    ty = port(torch.from_numpy(hr), torch.from_numpy(hi), n)
    assert tuple(ty.shape) == (rows, n // 2)
    _close((ty,), (jy,))
    spec = np.concatenate([hr, hi[:, :1]], 1) + 1j * np.concatenate(
        [np.zeros((rows, 1)), hi[:, 1:], np.zeros((rows, 1))], 1)
    _close((ty,), (np.fft.irfft(spec, n)[:, n // 2:],))
    assert port.launches == 0


@pytest.mark.parametrize("inverse, tail_only", [
    (False, False), (True, False), (True, True), (False, True)],
    ids=["forward", "inverse", "inverse_tail", "forward_tail"])
def test_cfft_balanced_fused_matches_pallas(inverse, tail_only):
    """K14 at h = 1024 (n1 = 8), natural order; ``tail_only`` returns
    exactly outputs [h/2, h)."""
    h = 1024
    rng = np.random.default_rng(43)
    zr = rng.standard_normal((6, h)).astype(np.float32)
    zi = rng.standard_normal((6, h)).astype(np.float32)
    jr, ji = JFF.cfft_balanced_fused(jnp.asarray(zr), jnp.asarray(zi), h,
                                     inverse=inverse, tail_only=tail_only,
                                     interpret=True)
    tr, ti = FF.cfft_balanced_fused(torch.from_numpy(zr), torch.from_numpy(zi),
                                    h, inverse=inverse, tail_only=tail_only)
    assert tuple(tr.shape) == (6, h // 2 if tail_only else h)
    _close((tr, ti), (jr, ji))
    z = zr.astype(np.float64) + 1j * zi
    y = np.fft.ifft(z) if inverse else np.fft.fft(z)
    y = y[:, h // 2:] if tail_only else y
    _close((tr, ti), (y.real, y.imag))
    assert FF.cfft_balanced_fused.launches == 0


def _float64_case(name, x, spec):
    """(port output, numpy float64 reference) of one port function."""
    n = x.shape[-1]
    if name in FORWARD:
        return FORWARD[name][0](torch.from_numpy(x)), _hc(x)
    if name in INVERSE:
        hr, hi = spec
        y = INVERSE[name][0](torch.from_numpy(hr), torch.from_numpy(hi), n)
        return (y,), (x[..., n // 2:],)
    h = n // 2
    z = x[..., 0::2] + 1j * x[..., 1::2]
    out = FF.cfft_balanced_fused(torch.from_numpy(z.real.copy()),
                                 torch.from_numpy(z.imag.copy()), h,
                                 inverse=False)
    y = np.fft.fft(z)
    return out, (y.real, y.imag)


@pytest.mark.parametrize("name", [*FORWARD, *INVERSE, "cfft_balanced_fused"])
def test_float64_matches_numpy(name):
    """Every port function on float64 CPU tensors, batch shape [2, 3, n],
    against numpy in float64."""
    x = np.random.default_rng(44).standard_normal((2, 3, 2048))
    got, ref = _float64_case(name, x, _hc(x))
    assert all(g.dtype == torch.float64 for g in got)
    _close(got, ref, rel=1e-12)


PAIRS = {
    "b_fused": (FF.rfft_hc_fused, FF.irfft_hc_tail_fused),
    "c_pallas": (FP.rfft_hc_pallas, FP.irfft_hc_tail_pallas),
    "d_balanced": (FF.rfft_split_hc_balanced,
                   FF.irfft_split_hc_tail_balanced),
}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_roundtrip_convolution_law(pair):
    """The step_hc data path with both transforms swapped for a pair:
    forward of the frame and of the padded filter -> hc MAC -> inverse
    tail == the valid block of a linear convolution (scipy;
    tests/test_kernels.py::test_fused_roundtrip_convolution_law)."""
    fwd, inv = PAIRS[pair]
    rng = np.random.default_rng(92)
    n, c = 2048, 4
    h = rng.standard_normal((c, n)).astype(np.float32) * 0.1
    frame = rng.standard_normal((c, 2 * n)).astype(np.float32)
    hr, hi = fwd(torch.from_numpy(frame))
    cr, ci = fwd(torch.from_numpy(np.pad(h, ((0, 0), (0, n)))))
    yr, yi = K.mac_hc_plain(torch.cat([hr, hi])[None],
                            torch.cat([cr, ci])[None], 0)
    out = inv(yr, yi, 2 * n).numpy()
    ref = np.stack([signal.fftconvolve(frame[ch].astype(np.float64),
                                       h[ch].astype(np.float64))[n:2 * n]
                    for ch in range(c)])
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max())


REFUSED = {  # port call, reference call, on sizes the reference refuses
    "rfft_hc_fused": (lambda: FF.rfft_hc_fused(torch.zeros(4, 512)),
                      lambda: JFF.rfft_hc_fused(jnp.zeros((4, 512)),
                                                interpret=True)),
    "rfft_hc_pallas": (lambda: FP.rfft_hc_pallas(torch.zeros(4, 256), 256),
                       lambda: JFP.rfft_hc_pallas(jnp.zeros((4, 256)), 256,
                                                  interpret=True)),
    "irfft_hc_tail_fused": (
        lambda: FF.irfft_hc_tail_fused(torch.zeros(4, 512),
                                       torch.zeros(4, 512), 1024),
        lambda: JFF.irfft_hc_tail_fused(jnp.zeros((4, 512)),
                                        jnp.zeros((4, 512)), 1024,
                                        interpret=True)),
    "irfft_hc_tail_pallas": (
        lambda: FP.irfft_hc_tail_pallas(torch.zeros(4, 256),
                                        torch.zeros(4, 256), 512),
        lambda: JFP.irfft_hc_tail_pallas(jnp.zeros((4, 256)),
                                         jnp.zeros((4, 256)), 512,
                                         interpret=True)),
    "cfft_balanced_fused": (
        lambda: FF.cfft_balanced_fused(torch.zeros(4, 512),
                                       torch.zeros(4, 512), 512,
                                       inverse=False),
        lambda: JFF.cfft_balanced_fused(jnp.zeros((4, 512)),
                                        jnp.zeros((4, 512)), 512,
                                        inverse=False, interpret=True)),
    "rfft_split_hc_balanced": (
        lambda: FF.rfft_split_hc_balanced(torch.zeros(4, 1024)),
        lambda: JFF.rfft_split_hc_balanced(jnp.zeros((4, 1024)),
                                           interpret=True)),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refuses_what_the_reference_refuses(name):
    port, ref = REFUSED[name]
    with pytest.raises(ValueError, match="pow2"):
        ref()
    with pytest.raises(ValueError, match="pow2"):
        port()


@pytest.mark.parametrize("name", list(INVERSE))
def test_inverse_reads_only_the_first_h_lanes(name):
    """Lane-padded planes [..., h + 128] give the unpadded result bit for
    bit."""
    port = INVERSE[name][0]
    rng = np.random.default_rng(45)
    n, h = 2048, 1024
    hr = rng.standard_normal((3, h)).astype(np.float32)
    hi = rng.standard_normal((3, h)).astype(np.float32)
    pad = np.full((3, 128), 7.0, np.float32)
    y = port(torch.from_numpy(hr), torch.from_numpy(hi), n)
    yp = port(torch.from_numpy(np.concatenate([hr, pad], 1)),
              torch.from_numpy(np.concatenate([hi, pad], 1)), n)
    np.testing.assert_array_equal(yp.numpy(), y.numpy())


OFF_CPU = {  # wrapper called on [4, n] (or planes [4, n/2]) of a dtype
    "rfft_hc_fused": lambda n, t: FF.rfft_hc_fused(t(4, n)),
    "rfft_hc_pallas": lambda n, t: FP.rfft_hc_pallas(t(4, n)),
    "irfft_hc_tail_fused": lambda n, t: FF.irfft_hc_tail_fused(
        t(4, n // 2), t(4, n // 2), n),
    "irfft_hc_tail_pallas": lambda n, t: FP.irfft_hc_tail_pallas(
        t(4, n // 2), t(4, n // 2), n),
    "cfft_balanced_fused": lambda n, t: FF.cfft_balanced_fused(
        t(4, n // 2), t(4, n // 2), n // 2, inverse=True, tail_only=True),
}


@pytest.mark.parametrize("name", list(OFF_CPU))
def test_refusals_off_the_cpu(name):
    """A tensor off the CPU never takes the plain version: float32 goes to
    the kernel (here on the meta device it raises for want of CUDA),
    float64 raises NotImplementedError naming engine_mode="extended", other
    dtypes TypeError, and h above 16384 ValueError."""
    call = OFF_CPU[name]

    def meta(dtype):
        return lambda *shape: torch.zeros(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="CUDA tensor"):
        call(2048, meta(torch.float32))
    with pytest.raises(NotImplementedError, match='engine_mode="extended"'):
        call(2048, meta(torch.float64))
    with pytest.raises(TypeError, match="float32"):
        call(2048, meta(torch.float16))
    with pytest.raises(ValueError, match="shared-memory limit"):
        call(65536, meta(torch.float32))
