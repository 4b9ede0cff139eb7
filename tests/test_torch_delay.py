"""Delay lines of bfir_tpu_torch on CPU against bfir_tpu on the same numpy
inputs: ``apply_delay`` (exact, with a runtime delay change), the sinc bank
and ``FractionalDelayLine`` (within 1e-6 of the reference's), the delay
state's conversion, and sessions with per-channel integer and fractional
delays, a live delay change and ``render``'s fallback to ``process_buffer``.

Tolerance: exact for the integer gather; 1e-6 x max|reference| for the
fractional line (float64 sums in another order); sessions at float64 within
1e-10 of the reference session and of scipy shifted by the delay."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from scipy import signal

from bfir_tpu.core import spec as JS
from bfir_tpu.engine.cache import ArtifactCache as JaxArtifactCache
from bfir_tpu.engine.session import StreamProcessor as JaxStreamProcessor
from bfir_tpu.ops import delay as JDL
from bfir_tpu_torch import convert
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.ops import delay as DL

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends: XLA's CPU
    compiler has aborted xdist workers late in full runs once many
    executables had accumulated in one process (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


def _close(got, ref, rel=1e-6):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def test_apply_delay_matches_reference_with_runtime_change():
    rng = np.random.default_rng(1)
    c, n = 3, 64
    x = rng.standard_normal((7, c, n))
    tst = DL.init_delay_state(c, 40, torch.float64, device="cpu")
    jst = JDL.init_delay_state(c, 40, dtype=np.float64)
    outs = []
    for b, blk in enumerate(x):
        d = np.array([5, 17, 0]) if b < 4 else np.array([40, 2, 9])
        jst, yj = JDL.apply_delay(jst, blk, d)
        tst, yt = DL.apply_delay(tst, torch.from_numpy(blk),
                                 torch.from_numpy(d))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        outs.append(yt.numpy())
    np.testing.assert_array_equal(tst.history.numpy(), np.asarray(jst.history))
    y = np.concatenate(outs, axis=1)
    flat = x.transpose(1, 0, 2).reshape(c, -1)
    np.testing.assert_array_equal(y[1, 17:4 * n], flat[1, :4 * n - 17])
    np.testing.assert_array_equal(y[0, 4 * n:], flat[0, 4 * n - 40:-40])
    back = convert.delay_state_from_numpy(
        convert.delay_state_to_numpy(tst), "cpu")
    np.testing.assert_array_equal(back.history.numpy(), tst.history.numpy())


@pytest.mark.parametrize("steps,half", [(16, 16), (4, 24)])
def test_sinc_bank_and_fractional_line_match_reference(steps, half):
    tb = DL.sinc_interp_bank(steps, half)
    _close(tb, JDL.sinc_interp_bank(steps, half))
    assert tb.shape == (2 * steps - 1, 2 * half + 1)
    c, n = 3, 128
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((4, c, n))
    ints = np.array([0, 3, 7])
    subs = np.array([-(steps - 1), 0, steps // 2])
    jl = JDL.FractionalDelayLine(c, 8, steps, half, dtype=np.float64)
    tl = DL.FractionalDelayLine(c, 8, steps, half, dtype=torch.float64,
                                device="cpu")
    jst, tst = jl.init_state(), tl.init_state()
    for blk in x:
        jst, yj = jl(jst, blk, ints, subs)
        tst, yt = tl(tst, torch.from_numpy(blk), torch.from_numpy(ints),
                     torch.from_numpy(subs))
        _close(yt, yj)
    _close(tst.history, jst.history)


@pytest.mark.parametrize("fractional", [False, True])
def test_delay_lines_take_a_whole_stream_in_one_call(fractional):
    """One call on [C, B * N] gives the block-by-block outputs and state
    bit for bit (process_buffer delays its whole output at once); the
    fractional line gathers its windows in chunks, here of 100 samples."""
    c, n = 3, 128
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((c, 5 * n)))
    ints = torch.tensor([0, 3, 7])
    if fractional:
        line = DL.FractionalDelayLine(c, 8, 16, 16, dtype=torch.float64,
                                      device="cpu")
        line.CHUNK = 100
        args, st = (ints, torch.tensor([-15, 0, 8])), line.init_state()
    else:
        line = DL.apply_delay
        args, st = (ints,), DL.init_delay_state(c, 8, torch.float64,
                                                device="cpu")
    st_whole, whole = line(st, x, *args)
    outs = []
    for blk in x.split(n, dim=1):
        st, y = line(st, blk, *args)
        outs.append(y)
    assert torch.equal(whole, torch.cat(outs, dim=1))
    assert torch.equal(st_whole.history, st.history)


def _wav(tmp_path, name, h):
    path = str(tmp_path / name)
    wavio.write(path, np.asarray(h).T, 44100, subtype="float32")
    return path


def _config(path, delay, spec=TS, mode="auto"):
    return spec.EngineConfig(
        filter=spec.FilterSpec(block_length=256, dtype="float64"),
        stream=spec.StreamSpec(n_channels=2, sample_rate=44100),
        chain=spec.ChainSpec(files=(
            spec.ImpulseFileSpec(enabled=True, filename=path),
            spec.ImpulseFileSpec(), spec.ImpulseFileSpec())),
        delay=spec.DelaySpec(**delay), engine_mode=mode)


@pytest.mark.parametrize("mode", ["complex", "packed"])
def test_session_integer_delay_matches_reference(tmp_path, mode):
    """As tests/test_engine.py:703: per-channel delays (7, 130) on the
    engine's output, streamed and bulk, against the reference session and
    scipy shifted by each delay."""
    rng = np.random.default_rng(70)
    h = (rng.standard_normal((2, 300)) * 0.05).astype(np.float32)
    path = _wav(tmp_path, "h.wav", h)
    delay = dict(enabled=True, samples=(7, 130))
    jsp = JaxStreamProcessor(_config(path, delay, JS, mode),
                             JaxArtifactCache(str(tmp_path / "j")))
    tsp = StreamProcessor(_config(path, delay, TS, mode),
                          ArtifactCache(str(tmp_path / "t")), device="cpu")
    x = rng.standard_normal((2, 8 * 256))
    yt = np.concatenate([tsp.process(x[:, :500]), tsp.process(x[:, 500:])], 1)
    yj = jsp.process(x)
    assert tsp._impl == mode
    _close(yt, yj, 1e-10)
    base = np.stack([signal.fftconvolve(x[c], h[c].astype(np.float64))
                     [: yt.shape[1]] for c in range(2)])
    for c, d in enumerate((7, 130)):
        ref = np.concatenate([np.zeros(d), base[c][:-d]])
        np.testing.assert_allclose(yt[c], ref, atol=1e-10)
    # the bulk path equals the streamed one
    sp2 = StreamProcessor(_config(path, delay, TS, mode),
                          ArtifactCache(str(tmp_path / "t2")), device="cpu")
    np.testing.assert_allclose(sp2.process_buffer(x), yt, atol=1e-12)


def test_session_fractional_delay_matches_reference(tmp_path):
    """As tests/test_engine.py:735: a sine through a dirac and a half-sample
    delay, against the reference session and the shifted sine."""
    h = np.zeros((2, 16))
    h[:, 0] = 1.0
    path = _wav(tmp_path, "dirac.wav", h)
    delay = dict(enabled=True, samples=(4,), subsample_steps=(8,))
    jsp = JaxStreamProcessor(_config(path, delay, JS),
                             JaxArtifactCache(str(tmp_path / "j")))
    tsp = StreamProcessor(_config(path, delay, TS),
                          ArtifactCache(str(tmp_path / "t")), device="cpu")
    t = np.arange(16 * 256)
    x = np.stack([np.sin(2 * np.pi * 0.03 * t)] * 2)
    yt, yj = tsp.process(x), jsp.process(x)
    _close(yt, yj)
    ref = np.sin(2 * np.pi * 0.03 * (t - (4 + 8 / 16 + 16)))
    assert np.abs(yt[0, 2048:] - ref[2048:]).max() < 1e-3


def test_session_live_delay_change_and_render_fallback(tmp_path):
    """A delay-value change applies without a rebuild (change_delay,
    delay.cpp:552-600); a delay beyond the built history or a fractional
    switch rebuilds. ``render`` under a delay line takes ``process_buffer``
    and returns exactly T frames."""
    h = np.zeros((2, 8))
    h[:, 0] = 1.0
    path = _wav(tmp_path, "dirac.wav", h)
    cfg = _config(path, dict(enabled=True, samples=(64, 64)))
    jcfg = _config(path, dict(enabled=True, samples=(64, 64)), JS)
    sp = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "t")),
                         device="cpu")
    jsp = JaxStreamProcessor(jcfg, JaxArtifactCache(str(tmp_path / "j")))
    x = np.arange(1.0, 2 * 256 + 1.0).reshape(1, -1).repeat(2, axis=0)
    y1 = sp.process(x)
    np.testing.assert_allclose(y1[:, 64:], x[:, :-64], atol=1e-10)
    jsp.process(x)
    state = sp._state
    new = dict(enabled=True, samples=(16, 40))
    sp.reconfigure(dataclasses.replace(cfg, delay=TS.DelaySpec(**new)))
    jsp.reconfigure(dataclasses.replace(jcfg, delay=JS.DelaySpec(**new)))
    assert sp._state is state, "a delay value change must not rebuild"
    x2 = x + 2 * 256
    y2, yj2 = sp.process(x2), jsp.process(x2)
    _close(y2, yj2, 1e-10)
    np.testing.assert_allclose(y2[1, 40:], x2[1, :-40], atol=1e-10)
    sp.reconfigure(dataclasses.replace(
        cfg, delay=TS.DelaySpec(enabled=True, samples=(65, 0))))
    assert sp._channels == 0  # beyond the built history: rebuild
    # render under a delay line: the streaming engine, T frames out
    sp3 = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "t3")),
                          device="cpu")
    xr = np.random.default_rng(3).standard_normal((2, 1000))
    yr = sp3.render(xr)
    assert yr.shape == xr.shape and sp3._bulk is None
    np.testing.assert_allclose(yr[:, 64:], xr[:, :-64], atol=1e-10)
