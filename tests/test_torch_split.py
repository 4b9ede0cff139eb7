"""bfir_tpu_torch's split-tail schedule (``nonuniform_split``) on CPU
against bfir_tpu: the step and the M-cycle scan against the reference
scan and the port's own ``step_nu``, a reference-started stream finished
in the port, and the session mode against the reference session and scipy.

Geometry: C = 4, N = 128, R = 8, so M = Hp_t = 1024 splits into eight
128-lane bands (K5, or K6 on an int24 tail, one band per phase).
Tolerance: 1e-5 x max|reference| (float32 transforms and MACs summed in
other orders); int24 rings compare decoded, to 1 LSB."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import signal

from bfir_tpu.core import nonuniform as JNU
from bfir_tpu.core.spec import ChainSpec as JChainSpec
from bfir_tpu.core.spec import EngineConfig as JEngineConfig
from bfir_tpu.core.spec import FilterSpec as JFilterSpec
from bfir_tpu.core.spec import ImpulseFileSpec as JImpulseFileSpec
from bfir_tpu.engine.cache import ArtifactCache as JArtifactCache
from bfir_tpu.engine.session import StreamProcessor as JStreamProcessor
from bfir_tpu.kernels import spectrum_mac as JK
from bfir_tpu_torch import convert
from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.core.spec import (ChainSpec, EngineConfig, FilterSpec,
                                      ImpulseFileSpec)
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.kernels import spectrum_mac as K

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends (see
    tests/test_torch_kernels.py)."""
    yield
    jax.clear_caches()


GEOM = dict(block_length=128, ratio=8, p_head=16, p_tail=2)
C = 4
N_BLOCKS = 32  # four M-cycles: the tail output lands from block 24 on


def _close(got, ref, rel=1e-5):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _inputs(seed, n_taps, n_blocks=N_BLOCKS):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((C, n_taps))
         * np.exp(-np.arange(n_taps) / 1500.0)).astype(np.float32) * 0.1
    x = rng.standard_normal((n_blocks, C, 128)).astype(np.float32)
    return h, x


def _compare_rings(tt, jj):
    if isinstance(tt.ring, K.IntPlanes):
        dq = K.dequantize_planes(
            convert.planes_from_numpy(tt.ring, "cpu")).numpy()
        jdq = np.asarray(JK.dequantize_planes(jj.ring))
        lsb = np.asarray(jj.ring.scale)[..., :1]
        assert np.all(np.abs(dq - jdq) <= 1.001 * lsb + 1e-5 * np.abs(jdq).max())
    else:
        _close(tt.ring, jj.ring)


def _compare_split_states(tstate, jstate):
    t = convert.nu_split_state_to_numpy(tstate)
    j = jax.tree_util.tree_map(np.asarray, jstate)
    for tt, jj in ((t.head, j.head), (t.tail, j.tail)):
        assert int(tt.blockcounter) == int(jj.blockcounter)
        _close(tt.prev_block, jj.prev_block, 0)
        _compare_rings(tt, jj)
    for name in ("acc_r", "acc_i", "xstage", "pending"):
        _close(getattr(t, name), getattr(j, name))
    _close(t.inbuf, j.inbuf, 0)


@pytest.mark.parametrize("store", ["float32", "int24"])
def test_split_step_and_scan_match_reference(store):
    jspec = JNU.NuSpec(**GEOM, tail_store=store)
    tspec = NU.NuSpec(**GEOM, tail_store=store)
    assert NU.split_band_len(tspec) == JNU.split_band_len(jspec) == 128
    h, x = _inputs(30, jspec.max_taps - 100)
    jco = JNU.nu_coeffs(h, jspec, C)
    jst, jy = jax.jit(lambda s, b: JNU.process_blocks_nu_split(
        s, jco, b, use_pallas=False))(JNU.init_nu_split_state(jspec, C),
                                      jnp.asarray(x))
    tco = NU.nu_coeffs(h, tspec, C, device="cpu")
    st = NU.init_nu_split_state(tspec, C, device="cpu")
    ys = []
    for blk in x:
        st, y = NU.step_nu_split(st, tco, torch.from_numpy(blk))
        ys.append(y)
    _close(torch.stack(ys), jy)
    _compare_split_states(st, jst)
    st2, y2 = NU.process_blocks_nu_split(
        NU.init_nu_split_state(tspec, C, device="cpu"), tco,
        torch.from_numpy(x))
    _close(y2, jy)
    # the same stream through the port's one-fire-per-cycle step
    _, y3 = NU.process_blocks_nu(NU.init_nu_state(tspec, C, device="cpu"),
                                 tco, torch.from_numpy(x))
    _close(y2, y3)
    assert np.abs(np.asarray(jy)[-8:]).max() > 0  # the tail reached the output
    with pytest.raises(ValueError, match="multiple of R"):
        NU.process_blocks_nu_split(st2, tco, torch.from_numpy(x[:5]))
    assert st2.pending.shape[0] == tspec.delay_blocks - 1


def test_split_hand_over_from_reference():
    """Stream k blocks through bfir_tpu's split schedule, convert the state
    at phase k mod R = 5 (not 1), finish in the port: the outputs equal the
    reference's own run, and the port's state converts back."""
    spec = JNU.NuSpec(**GEOM, tail_store="int24")
    tspec = NU.NuSpec(**GEOM, tail_store="int24")
    h, x = _inputs(31, spec.max_taps)
    jco = JNU.nu_coeffs(h, spec, C)
    jst_end, jy = JNU.process_blocks_nu_split(
        JNU.init_nu_split_state(spec, C), jco, jnp.asarray(x),
        use_pallas=False)
    k = 13
    jst = JNU.init_nu_split_state(spec, C)
    for i in range(k):
        jst, _ = JNU._split_phase(jst, jco, jnp.asarray(x[i]), i % 8, False,
                                  False)
    tst = convert.nu_split_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    tco = convert.nu_coeffs_from_numpy(
        jax.tree_util.tree_map(np.asarray, jco), "cpu")
    ys = []
    for blk in x[k:]:
        tst, y = NU.step_nu_split(tst, tco, torch.from_numpy(blk))
        ys.append(y)
    _close(torch.stack(ys), np.asarray(jy)[k:])
    _compare_split_states(tst, jst_end)
    back = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jst_end),
        [jnp.asarray(a) for a in jax.tree_util.tree_leaves(
            convert.nu_split_state_to_numpy(tst))])
    assert int(back.head.blockcounter) == N_BLOCKS


def _write_impulse(tmp_path, name, taps, seed):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((2, taps))
         * np.exp(-np.arange(taps) / 2000.0) * 0.05).astype(np.float32)
    path = str(tmp_path / name)
    wavio.write(path, h.T, 44100, subtype="float32")
    return path, h.astype(np.float64)


def _configs(path, mode="nonuniform_split", block_length=128,
             dtype="float32", **kw):
    """The reference's and the port's EngineConfig from the same kwargs."""
    out = []
    for Eng, Chain, Filt, Imp in (
            (JEngineConfig, JChainSpec, JFilterSpec, JImpulseFileSpec),
            (EngineConfig, ChainSpec, FilterSpec, ImpulseFileSpec)):
        out.append(Eng(
            filter=Filt(block_length=block_length, dtype=dtype),
            chain=Chain(files=(Imp(enabled=True, filename=path), Imp(),
                               Imp())),
            engine_mode=mode, **kw))
    return out


def _scipy(x, h):
    return np.stack([signal.fftconvolve(x[c], h[c]) for c in range(2)])


def test_session_nonuniform_split_matches_reference(tmp_path):
    path, h = _write_impulse(tmp_path, "h.wav", 4000, 32)
    jcfg, tcfg = _configs(path)
    jsp = JStreamProcessor(jcfg, JArtifactCache(str(tmp_path / "jax")))
    tsp = StreamProcessor(tcfg, ArtifactCache(str(tmp_path / "torch")),
                          device="cpu")
    rng = np.random.default_rng(33)
    x = rng.standard_normal((2, 40 * 128 + 50)).astype(np.float32)
    chunks = [(0, 300), (300, 2100), (2100, x.shape[1])]
    yj = np.concatenate([jsp.process(x[:, a:b]) for a, b in chunks], 1)
    yt = np.concatenate([tsp.process(x[:, a:b]) for a, b in chunks], 1)
    assert tsp._impl == jsp._impl == "nonuniform_split"
    assert tsp._nuspec.tail_store == "float32"  # auto on the CPU
    _close(yt, yj)
    _close(yt, _scipy(x, h)[:, :yt.shape[1]])
    # process_buffer: two unaligned calls (the block scan), back to phase
    # 0, then an M-cycle-aligned one (the cycle scan)
    xs = [rng.standard_normal((2, w)).astype(np.float32)
          for w in (3 * 128 - 50, 5 * 128, 16 * 128)]
    yts, yjs = [], []
    for xi in xs:
        yts.append(tsp.process_buffer(xi))
        yjs.append(jsp.process_buffer(xi))
    assert tsp._nu_phase() == 0
    _close(np.concatenate(yts, 1), np.concatenate(yjs, 1))
    full = np.concatenate([x, *xs], axis=1)
    t0, t1 = yt.shape[1], yt.shape[1] + sum(y.shape[1] for y in yts)
    _close(np.concatenate(yts, 1), _scipy(full, h)[:, t0:t1])
    # reconfigure rebuilds (no crossfade on the split schedule)
    path2, h2 = _write_impulse(tmp_path, "h2.wav", 4000, 34)
    tsp.reconfigure(_configs(path2)[1])
    assert tsp._pending_swap is None and tsp._channels == 0
    x4 = rng.standard_normal((2, 30 * 128)).astype(np.float32)
    _close(tsp.process(x4), _scipy(x4, h2)[:, :x4.shape[1]])


def test_session_nonuniform_split_guards(tmp_path):
    path, _ = _write_impulse(tmp_path, "s.wav", 1500, 35)  # head covers it
    _, tcfg = _configs(path)
    sp = StreamProcessor(tcfg, ArtifactCache(str(tmp_path / "c")),
                         device="cpu")
    with pytest.raises(ValueError, match="too short for the split-tail"):
        sp.process(np.zeros((2, 256), np.float32))
    path, _ = _write_impulse(tmp_path, "l.wav", 4000, 36)
    _, tcfg = _configs(path, nu_head_store="int24")
    sp = StreamProcessor(tcfg, ArtifactCache(str(tmp_path / "c")),
                         device="cpu")
    sp.process(np.zeros((2, 256), np.float32))
    assert sp._nuspec.head_store == "float32"  # the split head is float32
    with pytest.raises(ValueError, match="TAIL only"):
        NU.init_nu_split_state(dataclasses.replace(sp._nuspec,
                                                   head_store="int24"), 2,
                               device="cpu")


def _both_sessions(tmp_path, path, n, dtype, chunks_of):
    """The reference's and the port's session on one config, fed the same
    seeded input in uneven chunks. Returns (reference, port, y_ref,
    y_port, x)."""
    jcfg, tcfg = _configs(path, block_length=n, dtype=dtype)
    jsp = JStreamProcessor(jcfg, JArtifactCache(str(tmp_path / "jax")))
    tsp = StreamProcessor(tcfg, ArtifactCache(str(tmp_path / "torch")),
                          device="cpu")
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, chunks_of[-1])).astype(dtype)
    bounds = list(zip([0, *chunks_of[:-1]], chunks_of))
    yj = np.concatenate([jsp.process(x[:, a:b]) for a, b in bounds], 1)
    yt = np.concatenate([tsp.process(x[:, a:b]) for a, b in bounds], 1)
    return jsp, tsp, yj, yt, x


@pytest.mark.parametrize("n", [16, 32, 64])
def test_split_small_block_runs_two_stage(tmp_path, n):
    # N <= 64: the tail planes (Hp = 8N rounded up to 128) do not split into
    # 8 bands of 128 lanes; both packages stream on the two-stage engine
    path, h = _write_impulse(tmp_path, "h.wav", 40 * n + 7, 60 + n)
    t = 130 * n + 11
    jsp, tsp, yj, yt, x = _both_sessions(
        tmp_path, path, n, "float32", [3 * n + 5, 17 * n, 60 * n + 1, t])
    assert tsp._impl == jsp._impl == "nonuniform"
    assert tsp._nuspec.block_length == n and tsp._nuspec.p_tail >= 2
    _close(yt, yj)
    _close(yt, _scipy(x, h)[:, :yt.shape[1]])


def test_split_small_block_float64(tmp_path):
    path, h = _write_impulse(tmp_path, "h.wav", 40 * 64 + 7, 70)
    jsp, tsp, yj, yt, x = _both_sessions(
        tmp_path, path, 64, "float64", [200, 1000, 64 * 64 + 9])
    assert tsp._impl == jsp._impl == "nonuniform"
    assert yt.dtype == np.float64
    _close(yt, yj, rel=1e-9)
    _close(yt, _scipy(x, h)[:, :yt.shape[1]], rel=1e-9)


def test_split_small_block_head_covers(tmp_path):
    # 900 taps at N = 64: the head (16 x 64) covers the filter, so both
    # packages' chains end on the uniform hc engine
    path, h = _write_impulse(tmp_path, "h.wav", 900, 71)
    jsp, tsp, yj, yt, x = _both_sessions(
        tmp_path, path, 64, "float32", [100, 1300, 40 * 64 + 3])
    assert tsp._impl == jsp._impl == "hc"
    _close(yt, yj)
    _close(yt, _scipy(x, h)[:, :yt.shape[1]])


def test_split_small_block_render_cli(tmp_path, monkeypatch):
    from bfir_tpu.cli import render as JCLI
    from bfir_tpu_torch.cli import render as CLI

    path, h = _write_impulse(tmp_path, "ir.wav", 40 * 64 + 7, 72)
    rng = np.random.default_rng(73)
    x = (0.3 * rng.standard_normal((6000, 2))).astype(np.float32)
    inp = str(tmp_path / "in.wav")
    wavio.write(inp, x, 44100, subtype="float32")
    monkeypatch.setenv("HOME", str(tmp_path))  # the sessions' default cache
    flags = ["--impulse", path, "--dtype", "float32", "--block", "64",
             "--engine-mode", "nonuniform_split", "--cpu"]
    out_j, out_t = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert JCLI.main([inp, out_j, *flags]) == 0
    assert CLI.main([inp, out_t, *flags]) == 0
    yj, _ = wavio.read(out_j)
    yt, _ = wavio.read(out_t)
    assert yt.shape == yj.shape == x.shape
    _close(yt, yj)
    _close(yt.T, _scipy(x.T, h)[:, :x.shape[0]])
