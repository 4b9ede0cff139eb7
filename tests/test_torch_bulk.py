"""bfir_tpu_torch's offline render on CPU against bfir_tpu: the G-cycle
batched scan (``core.nubatch``), the batched block-axis-FFT engine
(``core.convolver.process_batch``), ``BulkRenderer`` on each engine,
``StreamProcessor.render`` and the render CLI, each against the reference
on the same numpy inputs and against scipy.

Geometry: C = 4, N = 128, R = 8 (M = 1024), a few thousand taps, G = 2;
the renderers' long-filter threshold is lowered to 4000 taps on both sides
so the two-stage engines run at this size. Tolerance: 1e-5 x
max|reference| between the packages; 110 dB against scipy float64."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import signal

from bfir_tpu.cli import render as JCLI
from bfir_tpu.core import bulk as JBK
from bfir_tpu.core import convolver as JCV
from bfir_tpu.core import nonuniform as JNU
from bfir_tpu.core import nubatch as JNB
from bfir_tpu.core.spec import ChainSpec as JChainSpec
from bfir_tpu.core.spec import EngineConfig as JEngineConfig
from bfir_tpu.core.spec import FilterSpec as JFilterSpec
from bfir_tpu.core.spec import ImpulseFileSpec as JImpulseFileSpec
from bfir_tpu.engine.cache import ArtifactCache as JArtifactCache
from bfir_tpu.engine.session import StreamProcessor as JStreamProcessor
from bfir_tpu_torch.cli import render as CLI
from bfir_tpu_torch.core import bulk as BK
from bfir_tpu_torch.core import convolver as CV
from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.core import nubatch as NB
from bfir_tpu_torch.core.spec import (ChainSpec, EngineConfig, FilterSpec,
                                      ImpulseFileSpec)
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends (see
    tests/test_torch_kernels.py)."""
    yield
    jax.clear_caches()


GEOM = dict(block_length=128, ratio=8, p_head=16, p_tail=2)
C = 4


def _close(got, ref, rel=1e-5):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _oracle(x, h):
    hh = np.broadcast_to(np.atleast_2d(h), (x.shape[0], h.shape[-1]))
    return np.stack([signal.fftconvolve(x[i].astype(np.float64),
                                        hh[i].astype(np.float64))[:x.shape[1]]
                     for i in range(x.shape[0])])


def _snr_db(y, ref):
    return 10 * np.log10(float((ref ** 2).sum())
                         / max(float(((y - ref) ** 2).sum()), 1e-300))


def _impulse(seed, rows, taps):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, taps))
            * np.exp(-np.arange(taps) / 1500.0) * 0.1).astype(np.float32)


@pytest.mark.parametrize("rows", [C, 1], ids=["per_channel", "shared"])
def test_gbatch_matches_reference_and_macro_scan(rows):
    spec = JNU.NuSpec(**GEOM)
    tspec = NU.NuSpec(**GEOM)
    h = _impulse(40, rows, spec.max_taps - 50)
    x = np.random.default_rng(41).standard_normal(
        (48, C, 128)).astype(np.float32)  # 3 iterations of G = 2 cycles
    shared = rows == 1
    jco = JNU.nu_coeffs(h, spec, C, shared=shared)
    _, jy = JNB.process_blocks_nu_gbatch(JNU.init_nu_state(spec, C), jco,
                                         jnp.asarray(x), cycles_per_step=2,
                                         use_pallas=False)
    tco = NU.nu_coeffs(h, tspec, C, shared=shared, device="cpu")
    assert tco.head.shape[1] == (2 if shared else 2 * C)
    tst, ty = NB.process_blocks_nu_gbatch(
        NU.init_nu_state(tspec, C, device="cpu"), tco, torch.from_numpy(x),
        cycles_per_step=2)
    _close(ty, jy)
    _, tf = NU.process_blocks_nu_fast(NU.init_nu_state(tspec, C, device="cpu"),
                                      tco, torch.from_numpy(x))
    _close(ty, tf)
    flat = x.transpose(1, 0, 2).reshape(C, -1)
    assert _snr_db(ty.numpy().transpose(1, 0, 2).reshape(C, -1),
                   _oracle(flat, h)) > 110
    # the state resumes in the per-block engine
    more = np.random.default_rng(42).standard_normal((5, C, 128)).astype(
        np.float32)
    _, ty2 = NU.process_blocks_nu(tst, tco, torch.from_numpy(more))
    full = np.concatenate([x, more]).transpose(1, 0, 2).reshape(C, -1)
    _close(ty2.numpy().transpose(1, 0, 2).reshape(C, -1),
           _oracle(full, h)[:, -5 * 128:])
    with pytest.raises(ValueError, match="multiple of G\\*R"):
        NB.process_blocks_nu_gbatch(tst, tco, torch.from_numpy(x[:8]),
                                    cycles_per_step=2)


def test_gbatch_state_round_trip():
    """nu_to_gbatch / gbatch_to_nu at an M-cycle boundary mid-stream: the
    histories match the reference's, and the rings come back with every
    slot the per-block step reads."""
    spec = JNU.NuSpec(**GEOM)
    tspec = NU.NuSpec(**GEOM)
    h = _impulse(43, C, spec.max_taps)
    x = np.random.default_rng(44).standard_normal(
        (24, C, 128)).astype(np.float32)
    jst, _ = JNU.process_blocks_nu_fast(JNU.init_nu_state(spec, C),
                                        JNU.nu_coeffs(h, spec, C),
                                        jnp.asarray(x), use_pallas=False)
    tst, _ = NU.process_blocks_nu_fast(NU.init_nu_state(tspec, C, device="cpu"),
                                       NU.nu_coeffs(h, tspec, C, device="cpu"),
                                       torch.from_numpy(x))
    jgb, tgb = JNB.nu_to_gbatch(jst), NB.nu_to_gbatch(tst)
    assert tgb.counter == int(jgb.counter) == 24
    _close(tgb.head_hist, jgb.head_hist)
    _close(tgb.tail_hist, jgb.tail_hist)
    back = NB.gbatch_to_nu(tgb)
    p_h = back.head.ring.shape[0]
    keep = [(24 - 1 - k) % p_h for k in range(p_h - 1)]  # all but the next slot
    _close(back.head.ring[keep], tst.head.ring[keep], 0)
    _close(back.inbuf, tst.inbuf, 0)
    assert back.tail.blockcounter == tst.tail.blockcounter == 3


def test_process_batch_matches_reference():
    rng = np.random.default_rng(45)
    spec = JFilterSpec(block_length=256, n_partitions=5, dtype="float32")
    tspec = FilterSpec(block_length=256, n_partitions=5, dtype="float32")
    h = rng.standard_normal((2, 1200)).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 7, 2, 256)).astype(np.float32)
    jco = JCV.coeffs_to_spectra(h, spec)
    jhs = JCV.prepare_batch_coeffs(jco, 7)
    tco = CV.coeffs_to_spectra(h, tspec, device="cpu")
    ths = CV.prepare_batch_coeffs(tco, 7)
    jst, tst = JCV.init_state(spec, 2), CV.init_state(tspec, 2, device="cpu")
    for blocks in x:  # two batches: the ring threads between them
        jst, jy = JCV.process_batch(jst, jco, jnp.asarray(blocks),
                                    coeff_batch_fft=jhs)
        tst, ty = CV.process_batch(tst, tco, torch.from_numpy(blocks),
                                   coeff_batch_fft=ths)
        _close(ty, jy)
    _close(torch.view_as_real(tst.spectra_ring),
           np.stack([np.real(jst.spectra_ring), np.imag(jst.spectra_ring)],
                    axis=-1))
    assert tst.blockcounter == 14


@pytest.mark.parametrize("engine", ["gbatch", "split", "batch"])
def test_bulk_renderer_matches_reference(engine, monkeypatch):
    monkeypatch.setattr(JBK, "NU_BULK_MIN_TAPS", 4000)
    monkeypatch.setattr(BK, "NU_BULK_MIN_TAPS", 4000)
    rows = 1 if engine == "gbatch" else C  # gbatch: shared planes
    h = _impulse(46, rows, 4600)
    kw = dict(dtype="float32", block_length=128)
    if engine == "batch":
        kw["spec"] = BK.bulk_geometry(4600)
        jkw = dict(kw, spec=JBK.bulk_geometry(4600))
    else:
        kw["nu_engine"] = engine
        jkw = kw
    jr = JBK.BulkRenderer(h, C, scale=0.5, **jkw)
    tr = BK.BulkRenderer(h, C, scale=0.5, **kw, device="cpu")
    assert tr.engine == jr.engine
    if engine != "batch":
        assert tr.samples_per_dispatch == 24 * 8 * 128
        assert tr._co.head.shape[1] == (2 if engine == "gbatch" else 2 * C)
    x = np.random.default_rng(47).standard_normal(
        (C, tr.samples_per_dispatch + 999)).astype(np.float32)
    ty, jy = tr.render(x), jr.render(x)
    assert ty.shape == x.shape
    _close(ty, jy)
    assert _snr_db(ty, _oracle(x, 0.5 * h)) > 110


def test_bulk_renderer_auto_engine():
    h = np.zeros((2, 70000), np.float32)
    h[:, 0] = 1.0
    r = BK.BulkRenderer(h, 2, device="cpu")
    assert (r.engine, r.nu_engine, r.nuspec.tail_store) == (
        "nonuniform", "split", "float32")  # the CPU pick, float32 store
    with pytest.raises(ValueError, match="float-plane only"):
        BK.BulkRenderer(h, 2, store="int24", nu_engine="gbatch", device="cpu")
    assert BK.BulkRenderer(h[:, :5000], 2, device="cpu").engine == "batch"
    assert BK.bulk_geometry(131072) == BK.BulkSpec(8192, 16, 30)


def _configs(path, **kw):
    """The reference's and the port's EngineConfig from the same kwargs."""
    out = []
    for Eng, Chain, Filt, Imp in (
            (JEngineConfig, JChainSpec, JFilterSpec, JImpulseFileSpec),
            (EngineConfig, ChainSpec, FilterSpec, ImpulseFileSpec)):
        out.append(Eng(
            filter=Filt(block_length=128, dtype="float32"),
            chain=Chain(files=(Imp(enabled=True, filename=path), Imp(),
                               Imp())), **kw))
    return out


@pytest.mark.parametrize("taps", [4600, 2000], ids=["nonuniform", "batch"])
def test_session_render_matches_reference(tmp_path, monkeypatch, taps):
    monkeypatch.setattr(JBK, "NU_BULK_MIN_TAPS", 4000)
    monkeypatch.setattr(BK, "NU_BULK_MIN_TAPS", 4000)
    h = _impulse(48, 2, taps)
    path = str(tmp_path / "h.wav")
    wavio.write(path, h.T, 44100, subtype="float32")
    jcfg, tcfg = _configs(path)
    jsp = JStreamProcessor(jcfg, JArtifactCache(str(tmp_path / "jax")))
    tsp = StreamProcessor(tcfg, ArtifactCache(str(tmp_path / "torch")),
                          device="cpu")
    rng = np.random.default_rng(49)
    x = rng.standard_normal((2, 30000)).astype(np.float32)
    a1 = tsp.process(x[:, :512])
    ty, jy = tsp.render(x), jsp.render(x)
    assert tsp._bulk.engine == jsp._bulk.engine
    _close(ty, jy)
    assert _snr_db(ty, _oracle(x, h)) > 110
    assert tsp.overflow_stats().largest.max() > 0
    # render neither reads nor advances the streaming state
    a2 = tsp.process(x[:, 512:1024])
    ref = _oracle(x[:, :1024], h)
    _close(np.concatenate([a1, a2], 1), ref)
    # a queued crossfade renders through process_buffer, T frames out
    tsp.reconfigure(tcfg)
    assert tsp._pending_swap is not None
    yq = tsp.render(x[:, :3000])
    assert yq.shape == (2, 3000) and tsp._bulk is None


def test_render_cli_matches_reference(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(50)
    h = _impulse(51, 2, 3000)
    x = (0.3 * rng.standard_normal((12000, 2))).astype(np.float32)
    ir, inp = str(tmp_path / "ir.wav"), str(tmp_path / "in.wav")
    wavio.write(ir, h.T, 44100, subtype="float32")
    wavio.write(inp, x, 44100, subtype="float32")
    monkeypatch.setenv("HOME", str(tmp_path))  # the sessions' default cache
    common = [inp, "--impulse", ir, "--impulse-level", "-3", "--dtype",
              "float32", "--block", "256"]
    out_j, out_t = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert JCLI.main([common[0], out_j, *common[1:], "--cpu"]) == 0
    assert CLI.main([common[0], out_t, *common[1:], "--cpu"]) == 0
    yj, rj = wavio.read(out_j)
    yt, rt = wavio.read(out_t)
    assert rt == rj == 44100 and yt.shape == yj.shape == x.shape
    _close(yt, yj)
    ref = _oracle(x.T, h * 10 ** (-3 / 20)).T
    assert _snr_db(yt, ref) > 110
    # --serve runs the control server during the render: the same output
    assert CLI.main([common[0], out_t, *common[1:], "--cpu", "--serve",
                     "0"]) == 0
    _close(wavio.read(out_t)[0], yj)
    # --auto-attenuate lowers the level by the probe's printed steps
    capsys.readouterr()
    assert CLI.main([common[0], out_t, *common[1:], "--cpu",
                     "--auto-attenuate"]) == 0
    steps = int(capsys.readouterr().out.split(" dB, level ")[1].split()[0])
    assert steps < 0
    _close(wavio.read(out_t)[0], yj * 10 ** (steps / 200))
