"""bfir_tpu_torch's three-stage engine on CPU against bfir_tpu: the steps,
the bulk form, the transition's stage machine, the geometry and its byte
counts, state hand-over between the packages, and the session's
``nonuniform3`` mode.

Geometries are the reference tests' own: ``nu3_geometry(150,
block_length=128, ratio1=2, ratio2=2)`` (with the impulse at its full
``max_taps``, so the far stage carries taps), ``Nu3Spec(8, 2, 4,
NuSpec(16, 2, 4, 2))`` for the transition and block 64 for the sessions.

Tolerances: 1e-5 x max|reference| in float32 (FFTs and MACs summed in
other orders; bf16 and int24 far stages compute in float32 too), 1e-10 in
float64; integer rings compare decoded, to one step."""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import signal

import jax
import jax.numpy as jnp

from bfir_tpu.core import nonuniform as JNU
from bfir_tpu.core import spec as JS
from bfir_tpu.engine.cache import ArtifactCache as JaxArtifactCache
from bfir_tpu.engine.session import StreamProcessor as JaxStreamProcessor
from bfir_tpu.kernels import spectrum_mac as JK
from bfir_tpu_torch import convert
from bfir_tpu_torch.core import nonuniform as NU
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


C = 2
GEOM = dict(taps=150, block_length=128, ratio1=2, ratio2=2)


def _close(got, ref, rel):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _inputs(seed, taps, n_blocks, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((C, taps)) * 0.1).astype(dtype)
    x = rng.standard_normal((n_blocks, C, n)).astype(dtype)
    return h, x


def _scipy(h, x):
    """Per-channel linear convolution of blocks x [B, C, N] -> [B, C, N]."""
    b, c, n = x.shape
    flat = x.transpose(1, 0, 2).reshape(c, -1).astype(np.float64)
    y = np.stack([signal.fftconvolve(flat[ch], h[ch].astype(np.float64))
                  [: b * n] for ch in range(c)])
    return y.reshape(c, b, n).transpose(1, 0, 2)


def _jnp_leaves(st):
    return jax.tree_util.tree_map(np.asarray, st)


def _compare_hc(t, j, rel):
    assert int(t.blockcounter) == int(j.blockcounter)
    _close(t.prev_block, j.prev_block, 0)
    if isinstance(t.ring, K.IntPlanes):
        dq = K.dequantize_planes(convert.planes_from_numpy(t.ring, "cpu"))
        jdq = np.asarray(JK.dequantize_planes(j.ring))
        lsb = np.asarray(j.ring.scale)[..., :1]
        assert np.all(np.abs(dq.numpy() - jdq)
                      <= 1.001 * lsb + 1e-5 * np.abs(jdq).max())
    else:
        _close(t.ring, j.ring, rel)


def _compare_states(tstate, jstate, rel):
    """Port Nu3State against the reference's, leaf by leaf (integer rings
    decoded, within one step)."""
    t = convert.nu3_state_to_numpy(tstate)
    j = _jnp_leaves(jstate)
    _compare_hc(t.head, j.head, rel)
    _compare_hc(t.tail.head, j.tail.head, rel)
    _compare_hc(t.tail.tail, j.tail.tail, rel)
    for a, b in ((t.inbuf, j.inbuf), (t.tail.inbuf, j.tail.inbuf)):
        _close(a, b, 0)
    _close(t.pending, j.pending, rel)
    _close(t.tail.pending, j.tail.pending, rel)


@pytest.mark.parametrize("store", ["float32", "bfloat16", "int24"])
def test_nu3_steps_match_reference(store):
    """step_nu3 and process_blocks_nu3 against the reference's
    process_blocks_nu3 (its plain path), state included, with the far stage
    at each tier."""
    jspec = JNU.nu3_geometry(**GEOM, tail_store=store)
    tspec = NU.nu3_geometry(**GEOM, tail_store=store)
    assert tspec.inner.tail_store == store
    n = tspec.block_length
    sup = tspec.ratio1 * tspec.inner.ratio
    h, x = _inputs(30, tspec.max_taps, 8 * sup, n)
    jco = JNU.nu3_coeffs(h, jspec, C)
    jst, jy = JNU.process_blocks_nu3(JNU.init_nu3_state(jspec, C), jco,
                                     jnp.asarray(x), use_pallas=False)
    tco = NU.nu3_coeffs(h, tspec, C, device="cpu")
    st = NU.init_nu3_state(tspec, C, device="cpu")
    ys = []
    for blk in x:
        st, y = NU.step_nu3(st, tco, torch.from_numpy(blk))
        ys.append(y)
    rel = 1e-5
    _close(torch.stack(ys), jy, rel)
    _compare_states(st, jst, rel)
    st2, y2 = NU.process_blocks_nu3(
        NU.init_nu3_state(tspec, C, device="cpu"), tco, torch.from_numpy(x))
    _close(y2, jy, rel)
    _compare_states(st2, jst, rel)
    if store == "float32":  # every stage carries taps: scipy agrees
        _close(y2, _scipy(h, x), 1e-5)


def test_nu3_matches_reference_interpret():
    """The reference with its Pallas kernels in interpret mode."""
    jspec = JNU.nu3_geometry(**GEOM)
    tspec = NU.nu3_geometry(**GEOM)
    n = tspec.block_length
    h, x = _inputs(31, tspec.max_taps, 24, n)
    _, jy = JNU.process_blocks_nu3(JNU.init_nu3_state(jspec, C),
                                   JNU.nu3_coeffs(h, jspec, C),
                                   jnp.asarray(x), use_pallas=True,
                                   interpret=True)
    _, ty = NU.process_blocks_nu3(NU.init_nu3_state(tspec, C, device="cpu"),
                                  NU.nu3_coeffs(h, tspec, C, device="cpu"),
                                  torch.from_numpy(x))
    _close(ty, jy, 1e-5)
    assert np.abs(np.asarray(jy)[-4:]).max() > 0


def test_nu3_float64_matches_reference():
    spec_kw = dict(taps=70, block_length=4, ratio1=2, ratio2=2,
                   dtype="float64")
    jspec, tspec = JNU.nu3_geometry(**spec_kw), NU.nu3_geometry(**spec_kw)
    h, x = _inputs(32, tspec.max_taps, 64, 4, np.float64)
    jco = JNU.nu3_coeffs(h, jspec, C, precise=True)
    _, jy = JNU.process_blocks_nu3(JNU.init_nu3_state(jspec, C), jco,
                                   jnp.asarray(x), use_pallas=False)
    tco = NU.nu3_coeffs(h, tspec, C, precise=True, device="cpu")
    _, ty = NU.process_blocks_nu3(
        NU.init_nu3_state(tspec, C, device="cpu"), tco, torch.from_numpy(x))
    assert ty.dtype == torch.float64
    _close(ty, jy, 1e-10)
    _close(ty, _scipy(h, x), 1e-10)


def test_nu3_bulk_chunks_from_any_phase_match_reference_super_cycles():
    """process_blocks_nu3 over uneven chunks, each starting at another
    phase of the super-cycle, equals the reference's super-cycle form
    (process_blocks_nu3_fast) over the whole input."""
    jspec = JNU.nu3_geometry(**GEOM)
    tspec = NU.nu3_geometry(**GEOM)
    n = tspec.block_length
    sup = tspec.ratio1 * tspec.inner.ratio
    h, x = _inputs(33, tspec.max_taps, 6 * sup, n)
    _, jy = JNU.process_blocks_nu3_fast(JNU.init_nu3_state(jspec, C),
                                        JNU.nu3_coeffs(h, jspec, C),
                                        jnp.asarray(x), use_pallas=False)
    tco = NU.nu3_coeffs(h, tspec, C, device="cpu")
    xs = torch.from_numpy(x)
    st, ys, a = NU.init_nu3_state(tspec, C, device="cpu"), [], 0
    for b in (1, sup, 3 * sup + 1, 4 * sup, 6 * sup):
        st, y = NU.process_blocks_nu3(st, tco, xs[a:b])
        ys.append(y)
        a = b
    assert st.head.blockcounter == 6 * sup
    _close(torch.cat(ys), jy, 1e-5)


def test_nu3_state_hand_over_between_packages():
    """A reference Nu3State taken mid-super-cycle resumes in the port equal
    to the reference's own continuation, and back."""
    jspec = JNU.nu3_geometry(**GEOM, tail_store="int24")
    tspec = NU.nu3_geometry(**GEOM, tail_store="int24")
    n = tspec.block_length
    h, x = _inputs(34, tspec.max_taps, 40, n)
    jco = JNU.nu3_coeffs(h, jspec, C)
    k = 13  # not a multiple of r1 * r2 = 4
    jst, _ = JNU.process_blocks_nu3(JNU.init_nu3_state(jspec, C), jco,
                                    jnp.asarray(x[:k]), use_pallas=False)
    jend, jy = JNU.process_blocks_nu3(jst, jco, jnp.asarray(x[k:]),
                                      use_pallas=False)
    tst = convert.nu3_state_from_numpy(_jnp_leaves(jst), "cpu")
    tco = convert.nu3_coeffs_from_numpy(_jnp_leaves(jco), "cpu")
    tst, ty = NU.process_blocks_nu3(tst, tco, torch.from_numpy(x[k:]))
    _close(ty, jy, 1e-5)
    _compare_states(tst, jend, 1e-5)
    back = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jend),
        [jnp.asarray(a) for a in
         jax.tree_util.tree_leaves(convert.nu3_state_to_numpy(tst))])
    more = np.random.default_rng(35).standard_normal((5, C, n)).astype(
        np.float32)
    _, jy2 = JNU.process_blocks_nu3(back, jco, jnp.asarray(more),
                                    use_pallas=False)
    _, ty2 = NU.process_blocks_nu3(tst, tco, torch.from_numpy(more))
    _close(ty2, jy2, 1e-5)
    co_back = convert.nu3_coeffs_to_numpy(tco)
    np.testing.assert_array_equal(co_back.head, np.asarray(jco.head))
    np.testing.assert_array_equal(co_back.tail.tail.hi,
                                  np.asarray(jco.tail.tail.hi))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("tail", ["float32", "bfloat16", "int16", "int24"])
def test_traffic_bytes_per_block_match_reference(tail, dtype):
    """NuSpec at every (head, tail) tier and Nu3Spec at every far tier."""
    for head in ("float32", "int16", "int24"):
        kw = dict(block_length=8, ratio=2, p_head=4, p_tail=3, dtype=dtype,
                  tail_store=tail, head_store=head)
        assert (NU.NuSpec(**kw).traffic_bytes_per_block
                == JNU.NuSpec(**kw).traffic_bytes_per_block)
    kw3 = dict(taps=524288, block_length=1024, ratio1=8, ratio2=8,
               dtype=dtype, tail_store=tail)
    assert (NU.nu3_geometry(**kw3).traffic_bytes_per_block
            == JNU.nu3_geometry(**kw3).traffic_bytes_per_block)


def test_nu3_geometry_and_validation():
    spec = NU.nu3_geometry(524288, 1024, 8, 8)
    jspec = JNU.nu3_geometry(524288, 1024, 8, 8)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert (spec.m1, spec.delay_blocks, spec.max_taps) == (
        jspec.m1, jspec.delay_blocks, jspec.max_taps)
    assert spec.max_taps >= 524288 and spec.inner.block_length == 8192
    two = NU.nu_geometry(524288, 1024, 8)
    assert two.traffic_bytes_per_block / spec.traffic_bytes_per_block > 1.5
    # the flagship three-stage geometry (64 ch x 655 360 taps)
    flag = NU.nu3_geometry(655360)
    assert (flag.p_head, flag.inner.p_head, flag.inner.m,
            flag.inner.p_tail) == (16, 16, 65536, 8)
    with pytest.raises(ValueError):
        NU.Nu3Spec(4, 3, 6, NU.NuSpec(8, 2, 4, 1))  # ratio1 not pow2
    with pytest.raises(ValueError):
        NU.Nu3Spec(4, 2, 2, NU.NuSpec(8, 2, 4, 1))  # D1 < 2
    with pytest.raises(ValueError):  # inner block mismatch
        NU.Nu3Spec(4, 2, 4, NU.NuSpec(16, 2, 4, 1))
    with pytest.raises(ValueError, match="max_taps"):
        NU.nu3_coeffs(np.zeros((1, spec.max_taps + 1)), spec, 1,
                      device="cpu")


# -- the transition's stage machine (tests/test_nonuniform.py:536-649) ------


def _small(mod):
    return mod.Nu3Spec(block_length=8, ratio1=2, p_head=4,
                       inner=mod.NuSpec(block_length=16, ratio=2, p_head=4,
                                        p_tail=2))


_JSTEP = jax.jit(lambda s, c, b: JNU.step_nu3(s, c, b, use_pallas=False))
_JXFADE = jax.jit(
    lambda s, o, nw, b, ramp, mode: JNU.step_nu3_crossfade(
        s, o, nw, b, head_ramp=ramp, inner_mode=mode, use_pallas=False),
    static_argnums=(4, 5))


def _transition(spec, h1, h2, x, swap, port):
    """Stream x [C, T] with h1, start the three-stage transition at block
    ``swap``, continue with h2: the host-side stage machine the session
    drives, on the port (``port``) or the reference."""
    n, r1, r2 = spec.block_length, spec.ratio1, spec.inner.ratio
    if port:
        c1, c2 = (NU.nu3_coeffs(h, spec, C, device="cpu") for h in (h1, h2))
        st = NU.init_nu3_state(spec, C, device="cpu")
        step, xfade = NU.step_nu3, NU.step_nu3_crossfade
        wrap = torch.from_numpy
    else:
        c1, c2 = JNU.nu3_coeffs(h1, spec, C), JNU.nu3_coeffs(h2, spec, C)
        st = JNU.init_nu3_state(spec, C)
        step = _JSTEP

        def xfade(s, o, nw, b, head_ramp, inner_mode):
            return _JXFADE(s, o, nw, b, head_ramp, inner_mode)
        wrap = jnp.asarray
    outs, stage = [], None
    for b, blk in enumerate(x.reshape(C, -1, n).transpose(1, 0, 2)):
        blk = wrap(np.ascontiguousarray(blk))
        cnt = int(st.head.blockcounter)
        fires = cnt % r1 == r1 - 1
        inner_fires = (cnt // r1) % r2 == r2 - 1
        if b == swap:
            st, y = xfade(st, c1, c2, blk, head_ramp=True, inner_mode="ramp")
            stage = None if (fires and inner_fires) else (
                "inner" if fires else "outer")
        elif stage == "outer":
            st, y = xfade(st, c1, c2, blk, head_ramp=False, inner_mode="ramp")
            if fires:
                stage = None if inner_fires else "inner"
        elif stage == "inner":
            st, y = xfade(st, c1, c2, blk, head_ramp=False, inner_mode="hold")
            if fires and inner_fires:
                stage = None
        else:
            st, y = step(st, c1 if b < swap else c2, blk)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


def _plain(spec, h, x):
    _, y = NU.process_blocks_nu3(
        NU.init_nu3_state(spec, C, device="cpu"),
        NU.nu3_coeffs(h, spec, C, device="cpu"),
        torch.from_numpy(np.ascontiguousarray(
            x.reshape(C, -1, spec.block_length).transpose(1, 0, 2))))
    return y.numpy().transpose(1, 0, 2).reshape(C, -1)


@pytest.mark.parametrize("swap", [9, 10, 11, 13])
def test_nu3_transition_matches_reference(swap):
    """Every (outer, inner) phase of the change block: the port's
    transition equals the reference's; old == new collapses it to the
    plain engine."""
    spec = _small(NU)
    rng = np.random.default_rng(60 + swap)
    h1 = rng.standard_normal((C, spec.max_taps)).astype(np.float32)
    h2 = rng.standard_normal((C, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((C, 48 * spec.block_length)).astype(np.float32)
    yt = _transition(spec, h1, h2, x, swap, port=True)
    _close(yt, _transition(_small(JNU), h1, h2, x, swap, port=False), 1e-5)
    _close(_transition(spec, h1, h1, x, swap, port=True), _plain(spec, h1, x),
           2e-5)


def test_nu3_transition_converges_and_is_continuous():
    """After every stage has bridged and the queues have flushed the stream
    is the new filter's; no sample-level glitch across the change
    (tests/test_nonuniform.py:597-647 on the port)."""
    spec = _small(NU)
    n, r1, r2 = spec.block_length, spec.ratio1, spec.inner.ratio
    rng = np.random.default_rng(61)
    h1 = rng.standard_normal((C, spec.max_taps)).astype(np.float32)
    h2 = rng.standard_normal((C, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((C, 96 * n)).astype(np.float32)
    swap = 11
    y = _transition(spec, h1, h2, x, swap, port=True)
    settle = (swap + r1 * r2 * (spec.inner.delay_blocks + spec.delay_blocks
                                + 3) + spec.p_head + spec.inner.p_head * r1)
    assert settle < 96
    ref2 = _plain(spec, h2, x)
    _close(y[:, settle * n:], ref2[:, settle * n:], 2e-5)

    taps = spec.max_taps

    def smooth(seed):
        hh = (np.random.default_rng(seed).standard_normal((C, taps))
              * np.exp(-np.arange(taps) / 6.0))
        return (hh / np.abs(hh).sum(axis=1, keepdims=True)).astype(np.float32)

    s1, s2 = smooth(1), smooth(2)
    sig = np.sin(2 * np.pi * np.arange(90 * n) / 37.0)
    xs = np.stack([sig, sig]).astype(np.float32)
    yc = _transition(spec, s1, s2, xs, 20, port=True)
    steady = np.abs(np.diff(_plain(spec, s1, xs)[:, 5 * n:], axis=1)).max()
    assert np.abs(np.diff(yc[:, 5 * n:], axis=1)).max() < 3 * steady


# -- the session's nonuniform3 mode (tests/test_engine.py:553-700) ----------

BLOCK = 64


def _config(path, spec, mode="nonuniform3", dtype="float32"):
    return spec.EngineConfig(
        filter=spec.FilterSpec(block_length=BLOCK, dtype=dtype),
        stream=spec.StreamSpec(n_channels=2, sample_rate=44100),
        chain=spec.ChainSpec(files=(
            spec.ImpulseFileSpec(enabled=True, filename=path),
            spec.ImpulseFileSpec(), spec.ImpulseFileSpec())),
        engine_mode=mode)


def _impulse(tmp_path, name, seed, taps):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((C, taps))
         * np.exp(-np.arange(taps) / 3000.0) * 0.05).astype(np.float32)
    path = str(tmp_path / name)
    wavio.write(path, h.T, 44100, subtype="float32")
    return path, h.astype(np.float64)


def _snr(y, x, h):
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]]
                    for c in range(C)])
    return 10 * np.log10(float((ref ** 2).sum())
                         / float(((y - ref) ** 2).sum()))


def _sessions(tmp_path, path):
    jsp = JaxStreamProcessor(_config(path, JS),
                             JaxArtifactCache(str(tmp_path / "jax")))
    tsp = StreamProcessor(_config(path, TS),
                          ArtifactCache(str(tmp_path / "torch")), device="cpu")
    return jsp, tsp


def test_session_nonuniform3_matches_reference(tmp_path):
    """engine_mode="nonuniform3" behind the session: streaming in uneven
    chunks, the super-cycle-aligned process_buffer and the unaligned one,
    against the reference session and scipy."""
    # two stages cover 16 x 64 + 16 x 512 = 9216 taps
    path, h = _impulse(tmp_path, "h.wav", 70, 12000)
    jsp, tsp = _sessions(tmp_path, path)
    rng = np.random.default_rng(71)
    x = rng.standard_normal((C, 260 * BLOCK + 30)).astype(np.float32)
    yj = np.concatenate([jsp.process(x[:, a:b]) for a, b in
                         [(0, 5000), (5000, x.shape[1])]], axis=1)
    yt = np.concatenate([tsp.process(x[:, a:b]) for a, b in
                         [(0, 333), (333, 9000), (9000, x.shape[1])]], axis=1)
    assert tsp._impl == jsp._impl == "nonuniform3"
    assert dataclasses.asdict(tsp._nuspec) == dataclasses.asdict(jsp._nuspec)
    assert tsp._nuspec.inner.block_length == 8 * BLOCK
    assert tsp._nuspec.inner.tail_store == "float32"
    _close(yt, yj, 1e-5)
    assert _snr(yt, x, h) > 100

    for sp in (jsp, tsp):
        sp.reset()
    x2 = rng.standard_normal((C, 128 * BLOCK)).astype(np.float32)  # 2 supers
    yj2, yt2 = jsp.process_buffer(x2), tsp.process_buffer(x2)
    _close(yt2, yj2, 1e-5)
    assert _snr(yt2, x2, h) > 100
    x3 = rng.standard_normal((C, 70 * BLOCK + 5)).astype(np.float32)
    yj3, yt3 = jsp.process_buffer(x3), tsp.process_buffer(x3)  # unaligned
    _close(yt3, yj3, 1e-5)
    assert tsp._state.head.blockcounter == 198


def test_session_nonuniform3_short_filters(tmp_path):
    """A filter two stages cover builds nonuniform, one the head covers hc,
    decided from the geometry (the reference falls through to them)."""
    for name, taps, impl in (("a.wav", 9000, "nonuniform"),
                             ("b.wav", 900, "hc")):
        path, h = _impulse(tmp_path, name, 72, taps)
        jsp, tsp = _sessions(tmp_path, path)
        x = np.random.default_rng(73).standard_normal(
            (C, 40 * BLOCK)).astype(np.float32)
        yt, yj = tsp.process(x), jsp.process(x)
        assert tsp._impl == jsp._impl == impl
        _close(yt, yj, 1e-5)
        assert _snr(yt, x, h) > 100


def test_auto_prefers_nonuniform3_on_cuda(tmp_path, monkeypatch):
    """auto on a CUDA device: nonuniform3 from 640 partitions, nonuniform
    from 32, hc below, extended at float64; the three-stage far stage
    resolves auto to float32, the two-stage tail to int24."""
    sp = StreamProcessor(_config("x.wav", TS, mode="auto"),
                         ArtifactCache(str(tmp_path / "c")), device="cpu")
    sp.n_partitions = 640
    assert sp._resolve_engine_mode() == "complex"
    monkeypatch.setattr(sp, "device", torch.device("cuda"))
    for parts, mode in ((640, "nonuniform3"), (639, "nonuniform"),
                        (32, "nonuniform"), (31, "hc")):
        sp.n_partitions = parts
        assert sp._resolve_engine_mode() == mode
    assert sp._resolve_nu_tail_store("nonuniform3") == "float32"
    assert sp._resolve_nu_tail_store("nonuniform") == "int24"
    sp.config = dataclasses.replace(sp.config, nu_tail_store="int24")
    assert sp._resolve_nu_tail_store("nonuniform3") == "int24"
    sp.config = dataclasses.replace(
        sp.config, filter=TS.FilterSpec(block_length=BLOCK, dtype="float64"))
    assert sp._resolve_engine_mode() == "extended"
    # nonuniform3 at float64 on CUDA names the extended engine
    path, _ = _impulse(tmp_path, "h64.wav", 74, 12000)
    sp64 = StreamProcessor(_config(path, TS, dtype="float64"),
                           ArtifactCache(str(tmp_path / "c")), device="cpu")
    monkeypatch.setattr(sp64, "device", torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="extended"):
        sp64.process(np.zeros((C, BLOCK)))


def test_session_nonuniform3_reconfigure(tmp_path):
    """A live reconfigure runs the staged transition in place (no rebuild)
    and converges to the new filter; ``render`` during the transition goes
    through process_buffer; a second change mid-way rebuilds. The port
    against the reference session throughout."""
    taps = 16 * BLOCK + 16 * 8 * BLOCK + 4 * 64 * BLOCK + 100
    p1, h1 = _impulse(tmp_path, "a.wav", 80, taps)
    p2, h2 = _impulse(tmp_path, "b.wav", 81, taps)
    p3, h3 = _impulse(tmp_path, "c.wav", 82, taps)
    jsp, tsp = _sessions(tmp_path, p1)
    rng = np.random.default_rng(83)
    x1 = rng.standard_normal((C, 80 * BLOCK)).astype(np.float32)
    y1 = tsp.process(x1)
    _close(y1, jsp.process(x1), 1e-5)
    state = tsp._state
    for sp, spec in ((jsp, JS), (tsp, TS)):
        sp.reconfigure(_config(p2, spec))
    assert tsp._pending_swap is not None and tsp._state is state
    # 13 blocks: the change block, then the transition under way
    x2 = rng.standard_normal((C, 13 * BLOCK)).astype(np.float32)
    y2 = tsp.process(x2)
    _close(y2, jsp.process(x2), 1e-5)
    assert tsp._nu3_stage is not None
    xr = rng.standard_normal((C, 3 * BLOCK + 7)).astype(np.float32)
    yr = tsp.render(xr)
    assert yr.shape == xr.shape and tsp._bulk is None
    _close(yr, jsp.render(xr), 1e-5)
    x3 = rng.standard_normal((C, 560 * BLOCK)).astype(np.float32)
    y3 = tsp.process(x3)
    _close(y3, jsp.process(x3), 1e-5)
    assert tsp._nu_old is None and tsp._nu3_stage is None
    assert tsp._state.tail.tail.ring is state.tail.tail.ring  # in place
    # the last 32 blocks are the new filter's; render padded its last
    # block with a block of zeros, and 97 blocks preceded x3's output
    x = np.concatenate([x1, x2, xr, np.zeros((C, BLOCK), np.float32), x3],
                       axis=1)
    end = 97 * BLOCK + y3.shape[1]
    seg = slice(end - 32 * BLOCK, end)
    ref = np.stack([signal.fftconvolve(x[c], h2[c])[seg] for c in range(C)])
    err = float(((y3[:, -32 * BLOCK:] - ref) ** 2).sum())
    assert 10 * np.log10(float((ref ** 2).sum()) / err) > 100

    # a second change while a transition is under way rebuilds
    for sp, spec in ((jsp, JS), (tsp, TS)):
        sp.reconfigure(_config(p1, spec))
        sp.process(rng.standard_normal((C, 2 * BLOCK)).astype(np.float32))
    assert tsp._nu_old is not None
    for sp, spec in ((jsp, JS), (tsp, TS)):
        sp.reconfigure(_config(p3, spec))
    assert tsp._channels == 0 and tsp._pending_swap is None
    x4 = rng.standard_normal((C, 40 * BLOCK)).astype(np.float32)
    y4 = tsp.process(x4)
    assert tsp._impl == "nonuniform3" and tsp._state.head.blockcounter == 40
    _close(y4, jsp.process(x4), 1e-5)
    assert _snr(y4, x4, h3) > 100  # a cold start on the third filter
