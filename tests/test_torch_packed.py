"""The packed engine of bfir_tpu_torch (K8's plain version, ``step_packed``,
``step_packed_crossfade``, ``engine_mode="packed"`` sessions) on CPU
against bfir_tpu, whose ``mac_pallas_packed`` runs in interpret mode, on
the same numpy inputs; a packed stream handed over between the packages.

Tolerance: 1e-5 x max|reference| at float32 (FFTs and partition sums in
other orders); 1e-9 against scipy at float64."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import signal

from bfir_tpu.core import spec as JS
from bfir_tpu.engine.cache import ArtifactCache as JaxArtifactCache
from bfir_tpu.engine.session import StreamProcessor as JaxStreamProcessor
from bfir_tpu.kernels import spectrum_mac as JK
from bfir_tpu_torch import convert
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.kernels import spectrum_mac as K

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends: XLA's CPU
    compiler has aborted xdist workers late in full runs once many
    executables had accumulated in one process (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


P, C, N = 4, 2, 64


def _close(got, ref, rel=1e-5):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("pos, n_freq", [(0, 128), (3, N + 1)])
def test_mac_packed_matches_pallas(pos, n_freq):
    """All Fp lanes, or the engine's N + 1 live bins (rounded up to 4)."""
    rng = np.random.default_rng(1)
    fp = 128
    ring = rng.standard_normal((P, 2 * C, fp)).astype(np.float32)
    coeff = rng.standard_normal((P, 2 * C, fp)).astype(np.float32)
    jr, ji = JK.mac_pallas_packed(jnp.asarray(ring), jnp.asarray(coeff),
                                  jnp.int32(pos), interpret=True)
    tr, ti = K.mac_packed(torch.from_numpy(ring), torch.from_numpy(coeff),
                          pos, n_freq)
    lanes = -(-n_freq // 4) * 4  # 128, or 68 for the 65 live bins
    assert tuple(tr.shape) == tuple(ti.shape) == (C, lanes)
    _close(tr, np.asarray(jr)[:, :lanes])
    _close(ti, np.asarray(ji)[:, :lanes])
    # mac_reference on split planes, against the reference's (lane 0 is a
    # full complex product: no halfcomplex law)
    planes = (ring[:, :C], ring[:, C:], coeff[:, :C], coeff[:, C:])
    rr, ri = JK.mac_reference(*map(jnp.asarray, planes), jnp.int32(pos))
    mr, mi = K.mac_reference(*map(torch.from_numpy, planes), pos)
    _close(mr, rr)
    _close(mi, ri)
    _close(tr, mr[:, :lanes])
    assert K.mac_packed.launches == 0  # CPU tensors never reach the kernel


def _impulse(seed, rows, taps):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, taps))
            * np.exp(-np.arange(taps) / 80.0) * 0.2).astype(np.float32)


def test_step_packed_and_crossfade_match_reference():
    spec_j = JS.FilterSpec(block_length=N, n_partitions=P, dtype="float32")
    spec_t = TS.FilterSpec(block_length=N, n_partitions=P, dtype="float32")
    h1, h2 = _impulse(2, C, 230), _impulse(3, 1, 200)
    x = np.random.default_rng(4).standard_normal((9, C, N)).astype(np.float32)
    gj1 = JK.pack_coeffs(h1, spec_j, C, scale=0.7)
    gj2 = JK.pack_coeffs(h2, spec_j, C)
    gt1 = K.pack_coeffs(h1, spec_t, C, scale=0.7, device="cpu")
    gt2 = K.pack_coeffs(h2, spec_t, C, device="cpu")
    assert tuple(gt1.shape) == tuple(gj1.shape) == (P, 2 * C, 128)
    _close(gt1, gj1)
    _close(gt2, gj2)
    js = JK.init_packed_state(spec_j, C)
    ts = K.init_packed_state(spec_t, C, device="cpu")
    for i, blk in enumerate(x):
        if i == 5:  # the filter change block
            js, yj = JK.step_packed_crossfade(js, gj1, gj2, jnp.asarray(blk),
                                              interpret=True)
            ts, yt = K.step_packed_crossfade(ts, gt1, gt2,
                                             torch.from_numpy(blk))
        else:
            g = (gj1, gt1) if i < 5 else (gj2, gt2)
            js, yj = JK.step_packed(js, g[0], jnp.asarray(blk), interpret=True)
            ts, yt = K.step_packed(ts, g[1], torch.from_numpy(blk))
        _close(yt, yj)
    _close(ts.ring, js.ring)
    _close(ts.prev_block, js.prev_block)
    assert ts.blockcounter == int(js.blockcounter) == 9


def test_packed_stream_resumes_across_packages():
    """A packed stream started in bfir_tpu continues in the port from the
    converted state and matches the uninterrupted reference stream."""
    spec_j = JS.FilterSpec(block_length=N, n_partitions=P, dtype="float32")
    h = _impulse(5, C, 250)
    x = np.random.default_rng(6).standard_normal((10, C, N)).astype(np.float32)
    g = JK.pack_coeffs(h, spec_j, C)
    js = JK.init_packed_state(spec_j, C)
    ref = []
    for i, blk in enumerate(x):
        js, y = JK.step_packed(js, g, jnp.asarray(blk), interpret=True)
        ref.append(np.asarray(y))
        if i == 5:
            handed = jax.tree_util.tree_map(np.asarray, js)
    ts = convert.packed_state_from_numpy(handed, "cpu")
    gt = convert.tensor_from_numpy(np.asarray(g), "cpu")
    for i in range(6, 10):
        ts, y = K.step_packed(ts, gt, torch.from_numpy(x[i]))
        _close(y, ref[i])
    back = convert.packed_state_to_numpy(ts)
    assert ([np.shape(a) for a in jax.tree_util.tree_leaves(back)]
            == [np.shape(a) for a in jax.tree_util.tree_leaves(js)])
    _close(back.ring, js.ring)
    assert int(back.blockcounter) == int(js.blockcounter)


def _config(path, spec=TS, dtype="float32", block=256):
    return spec.EngineConfig(
        filter=spec.FilterSpec(block_length=block, dtype=dtype),
        stream=spec.StreamSpec(n_channels=2, sample_rate=44100),
        chain=spec.ChainSpec(files=(
            spec.ImpulseFileSpec(enabled=True, filename=path),
            spec.ImpulseFileSpec(), spec.ImpulseFileSpec())),
        engine_mode="packed")


def _wav(tmp_path, name, h):
    path = str(tmp_path / name)
    wavio.write(path, np.asarray(h).T, 44100, subtype="float32")
    return path


def _scipy(x, h):
    return np.stack([signal.fftconvolve(x[c].astype(np.float64),
                                        h[c].astype(np.float64))
                     for c in range(x.shape[0])])


def test_session_packed_matches_reference_and_scipy(tmp_path):
    h = _impulse(7, 2, 900)
    path = _wav(tmp_path, "h.wav", h)
    jsp = JaxStreamProcessor(_config(path, spec=JS),
                             JaxArtifactCache(str(tmp_path / "jax")))
    tsp = StreamProcessor(_config(path), ArtifactCache(str(tmp_path / "t")),
                          device="cpu")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12 * 256 + 40)).astype(np.float32)
    yj = np.concatenate([jsp.process(x[:, :700]), jsp.process(x[:, 700:])], 1)
    yt = np.concatenate([tsp.process(x[:, :300]), tsp.process(x[:, 300:])], 1)
    assert tsp._impl == jsp._impl == "packed"
    assert tuple(tsp._coeffs.shape) == (4, 4, 384)  # [P, 2C, Fp]
    _close(yt, yj)
    _close(yt, _scipy(x, h)[:, :yt.shape[1]])
    # process_buffer continues the same stream
    x2 = rng.standard_normal((2, 4 * 256)).astype(np.float32)
    yb = tsp.process_buffer(x2)
    _close(yb, jsp.process_buffer(x2))
    full = np.concatenate([x[:, :12 * 256], x[:, 12 * 256:], x2], axis=1)
    _close(yb, _scipy(full, h)[:, yt.shape[1]:yt.shape[1] + yb.shape[1]])


def test_session_packed_reconfigure_crossfades(tmp_path):
    """As tests/test_crossfade_coeffio.py's packed case: the filter change
    is a glitch-free crossfade, not a rebuild."""
    h1 = np.zeros((2, 8))
    h1[:, 0] = 1.0
    h2 = np.zeros((2, 8))
    h2[:, 0] = 0.25
    cache = ArtifactCache(str(tmp_path / "c"))
    sp = StreamProcessor(_config(_wav(tmp_path, "a.wav", h1)), cache,
                         device="cpu")
    x = np.ones((2, 256), dtype=np.float32)
    np.testing.assert_allclose(sp.process(x), 1.0, atol=1e-5)
    assert sp._impl == "packed"
    state = sp._state
    sp.reconfigure(_config(_wav(tmp_path, "b.wav", h2)))
    assert sp._pending_swap is not None, "packed must crossfade, not rebuild"
    y2 = sp.process(x)
    assert sp._state.ring is state.ring  # the same stream went on
    assert abs(y2[0, 0] - 1.0) < 1e-4
    y3 = sp.process(x)
    np.testing.assert_allclose(y3, 0.25, atol=1e-5)
    assert np.all(np.diff(np.concatenate([y2[0], y3[0]])) <= 1e-4)


def test_process_buffer_first_call_on_packed_engine(tmp_path):
    """As tests/test_engine.py:425: process_buffer as the first call builds
    the packed engine and matches scipy."""
    rng = np.random.default_rng(13)
    h = rng.standard_normal((2, 100)) * 0.05
    sp = StreamProcessor(_config(_wav(tmp_path, "pk.wav", h),
                                 dtype="float64"),
                         ArtifactCache(str(tmp_path / "c")), device="cpu")
    x = rng.standard_normal((2, 512))
    y = sp.process_buffer(x)
    assert sp._impl == "packed"
    h32 = h.astype(np.float32)  # the impulse WAV is float32
    np.testing.assert_allclose(y, _scipy(x, h32)[:, :512], atol=1e-9)


def test_packed_wrappers_refuse_other_devices():
    ring = torch.zeros((P, 2 * C, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.mac_packed(ring, ring, 0, 128)
