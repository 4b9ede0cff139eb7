"""The ``extended`` engine of bfir_tpu_torch (``kernels/extended``: native
float64) on the CPU against bfir_tpu's df64 ``kernels/extended`` and
scipy on the same numpy inputs, streams handed over between the packages
through ``convert``, and the session's ``extended`` mode.

Tolerances: against scipy's float64 convolution the port reaches >= 240
dB (SNR over the whole output; it reads about 306 dB); against the
reference's df64 step >= 160 dB (the reference's own df64 floor,
tests/test_extended.py); >= 30 dB above the port's float32 ``step_hc``;
coefficients to 1e-13 of their largest magnitude, the df64 split bit for
bit; the session's output within atol 1e-11 of scipy (as
tests/test_engine.py holds the reference's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import signal

from bfir_tpu.core import spec as JS
from bfir_tpu.engine.cache import ArtifactCache as JArtifactCache
from bfir_tpu.engine.session import StreamProcessor as JStreamProcessor
from bfir_tpu.kernels import extended as JE
from bfir_tpu_torch import convert
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.kernels import extended as E
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.ops import formats as fm

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends: XLA's CPU
    compiler has aborted xdist workers late in full runs once many
    executables had accumulated in one process (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


def snr_db(y, ref):
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(float((ref ** 2).sum())
                         / max(float((e ** 2).sum()), 1e-300))


def _problem(seed, c=2, n=128, p=32, blocks=6):
    """A decaying impulse [c, n p] and blocks of float32 noise, with scipy's
    float64 convolution of the two."""
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((c, n * p))
         * np.exp(-np.arange(n * p) / 800.0)) * 0.1
    x = rng.standard_normal((c, n * blocks)).astype(np.float32)
    ref = signal.fftconvolve(x.astype(np.float64), h, axes=1)[:, :n * blocks]
    return h, x, ref


def _spec(n, p, spec=TS, dtype="float64"):
    return spec.FilterSpec(block_length=n, n_partitions=p, dtype=dtype)


def _run_port(state, coeff, x, n, a=0):
    """port step_df over the blocks of x from block a; (state, [C, T])."""
    outs = []
    for b in range(a, x.shape[1] // n):
        state, o = E.step_df(state, coeff, torch.from_numpy(
            x[:, b * n:(b + 1) * n]))
        assert o.dtype == torch.float64
        outs.append(o.numpy())
    return state, np.concatenate(outs, 1)


def _run_ref(state, pair, x, n, a=0):
    """reference step_df over the blocks of x from block a."""
    outs = []
    for b in range(a, x.shape[1] // n):
        state, o = JE.step_df(state, pair[0], pair[1],
                              jnp.asarray(x[:, b * n:(b + 1) * n]))
        outs.append(np.asarray(o, np.float64))
    return state, np.concatenate(outs, 1)


def test_step_df_beats_f32_by_30db():
    """The port's float64 step against scipy (>= 240 dB) and >= 30 dB
    above the port's float32 ``step_hc`` at the same geometry."""
    c, n, p = 2, 128, 32
    h, x, ref = _problem(0, c, n, p)
    s32 = K.init_hc_state(_spec(n, p, dtype="float32"), c, device="cpu")
    c32 = K.hc_coeffs(h.astype(np.float32), _spec(n, p, dtype="float32"), c,
                      device="cpu")
    outs32 = []
    for b in range(6):
        s32, o = K.step_hc(s32, c32, torch.from_numpy(x[:, b * n:(b + 1) * n]))
        outs32.append(o.numpy().astype(np.float64))
    snr32 = snr_db(np.concatenate(outs32, 1), ref)
    _, y = _run_port(E.init_df_state(_spec(n, p), c, device="cpu"),
                     E.df_coeffs(h, _spec(n, p), c, device="cpu"), x, n)
    snrdf = snr_db(y, ref)
    assert snrdf > snr32 + 30, (snrdf, snr32)
    assert snrdf >= 240, snrdf


def test_step_df_matches_reference_df64():
    """The port's float64 step against the reference's df64 step on the
    same inputs: >= 160 dB between them (the df64 floor), each against
    scipy."""
    c, n, p = 2, 128, 32
    h, x, ref = _problem(1, c, n, p)
    _, yj = _run_ref(JE.init_df_state(_spec(n, p, JS, "float32"), c),
                     JE.df_coeffs(h, _spec(n, p, JS, "float32"), c), x, n)
    _, yt = _run_port(E.init_df_state(_spec(n, p), c, device="cpu"),
                      E.df_coeffs(h, _spec(n, p), c, device="cpu"), x, n)
    assert snr_db(yt, yj) >= 160
    assert snr_db(yj, ref) >= 160
    assert snr_db(yt, ref) >= 240


def test_df_coeffs_matches_hc_coeffs_layout():
    """The float64 plane has hc_coeffs' layout; split as the reference
    splits it, it equals the reference's (hi, lo) bit for bit."""
    rng = np.random.default_rng(1)
    c, n, p = 2, 64, 4
    h = rng.standard_normal((c, 150)) * 0.1
    pk32 = K.hc_coeffs(h.astype(np.float32), _spec(n, p, dtype="float32"), c,
                       device="cpu").numpy()
    pk = E.df_coeffs(h, _spec(n, p), c, device="cpu")
    assert pk.dtype == torch.float64 and tuple(pk.shape) == pk32.shape
    np.testing.assert_allclose(pk.numpy(), pk32, atol=2e-5)
    jhi, jlo = JE.df_coeffs(h, _spec(n, p, JS, "float32"), c)
    hi, lo = convert.df_coeffs_to_numpy(pk)
    np.testing.assert_array_equal(hi, np.asarray(jhi))
    np.testing.assert_array_equal(lo, np.asarray(jlo))
    back = convert.df_coeffs_from_numpy((jhi, jlo), "cpu").numpy()
    np.testing.assert_allclose(back, pk.numpy(), rtol=0,
                               atol=1e-13 * np.abs(pk.numpy()).max())
    # a shared filter: one filter's plane, the MAC broadcasts it
    sh = E.df_coeffs(h[:1], _spec(n, p), c, shared=True, device="cpu")
    assert tuple(sh.shape) == (p, 2, pk.shape[-1])
    per = E.df_coeffs(np.repeat(h[:1], c, 0), _spec(n, p), c, device="cpu")
    ring = torch.from_numpy(rng.standard_normal(tuple(per.shape)))
    idx = E.slot_order(3, p, "cpu")
    for got, want in zip(E.mac_df(ring, sh, idx), E.mac_df(ring, per, idx)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-13)
    # the device-order MAC is the hc path's plain MAC, bit for bit
    for got, want in zip(E.mac_df(ring, per, idx), K.mac_reference_hc(
            ring[:, :c], ring[:, c:], per[:, :c], per[:, c:], 3)):
        assert torch.equal(got, want)


def test_hc_coeffs_precise_layout_and_accuracy():
    """hc_coeffs(precise=True) is df_coeffs rounded once to float32 (to one
    float32 step: the two take their float64 rfft from torch and numpy)."""
    rng = np.random.default_rng(2)
    c, n, p = 2, 64, 4
    h = rng.standard_normal((c, 200)) * 0.1
    spec32 = _spec(n, p, dtype="float32")
    fast = K.hc_coeffs(h.astype(np.float32), spec32, c, device="cpu").numpy()
    prec = K.hc_coeffs(h, spec32, c, precise=True, device="cpu").numpy()
    assert prec.shape == fast.shape and prec.dtype == fast.dtype
    np.testing.assert_allclose(prec, fast, atol=2e-5)
    pk = E.df_coeffs(h, _spec(n, p), c, device="cpu").numpy()
    np.testing.assert_allclose(prec, pk.astype(np.float32), rtol=2.0 ** -23,
                               atol=0)


def test_step_df_crossfade_glitch_free():
    rng = np.random.default_rng(3)
    c, n, p = 1, 64, 4
    spec = _spec(n, p)
    h_old = np.zeros((c, 8))
    h_old[:, 0] = 1.0
    h_new = np.zeros((c, 8))
    h_new[:, 0] = 0.25
    st = E.init_df_state(spec, c, device="cpu")
    co = E.df_coeffs(h_old, spec, c, device="cpu")
    cn = E.df_coeffs(h_new, spec, c, device="cpu")
    x = torch.ones((c, n), dtype=torch.float32)
    for _ in range(3):
        st, o = E.step_df(st, co, x)
    np.testing.assert_allclose(o.numpy(), 1.0, atol=1e-12)
    st, o = E.step_df_crossfade(st, co, cn, x)
    seq = o.numpy()[0]
    assert abs(seq[0] - 1.0) < 1e-12 and abs(seq[-1] - 0.25) < 1e-12
    assert np.all(np.diff(seq) <= 1e-12)  # monotone fade
    st, o = E.step_df(st, cn, x)
    np.testing.assert_allclose(o.numpy(), 0.25, atol=1e-12)
    # the ramp block against the reference's, on a noise input
    h1, h2 = (rng.standard_normal((2, 3 * n)) * 0.1 for _ in range(2))
    xn = rng.standard_normal((2, 4 * n))
    jspec = _spec(n, p, JS, "float32")
    js, ts = JE.init_df_state(jspec, 2), E.init_df_state(spec, 2, device="cpu")
    jpairs = [JE.df_coeffs(g, jspec, 2) for g in (h1, h2)]
    tplanes = [E.df_coeffs(g, spec, 2, device="cpu") for g in (h1, h2)]
    js, _ = _run_ref(js, jpairs[0], xn[:, :3 * n], n)
    ts, _ = _run_port(ts, tplanes[0], xn[:, :3 * n], n)
    _, jo = JE.step_df_crossfade(js, jpairs[0], jpairs[1],
                                 jnp.asarray(xn[:, 3 * n:]))
    _, to = E.step_df_crossfade(ts, *tplanes, torch.from_numpy(xn[:, 3 * n:]))
    assert snr_db(to.numpy(), np.asarray(jo, np.float64)) >= 160


@pytest.mark.parametrize("start", ["reference", "port"])
def test_df_state_moves_between_packages(start):
    """A stream started in one package resumes in the other through
    ``convert``: the joined output against one uninterrupted run of the
    port >= 160 dB (the df64 floor), and against scipy. The way back
    splits as the reference splits float64 (hi = f32(x), lo = f32(x - hi))."""
    c, n, p = 2, 64, 8
    h, x, ref = _problem(4, c, n, p, blocks=12)
    jspec, tspec = _spec(n, p, JS, "float32"), _spec(n, p)
    pair = JE.df_coeffs(h, jspec, c)
    plane = E.df_coeffs(h, tspec, c, device="cpu")
    _, whole = _run_port(E.init_df_state(tspec, c, device="cpu"), plane, x, n)
    xa = x[:, :5 * n]
    if start == "reference":
        js, ya = _run_ref(JE.init_df_state(jspec, c), pair, xa, n)
        ts = convert.df_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, js), "cpu")
        assert ts.ring.dtype == torch.float64 and ts.blockcounter == 5
        _, yb = _run_port(ts, plane, x, n, a=5)
    else:
        ts, ya = _run_port(E.init_df_state(tspec, c, device="cpu"), plane,
                           xa, n)
        planes = convert.df_state_to_numpy(ts)
        assert planes.ring_hi.dtype == np.float32
        np.testing.assert_array_equal(
            planes.ring_hi, ts.ring.numpy().astype(np.float32))
        js = JE.DfState(*(jnp.asarray(a) for a in planes))
        _, yb = _run_ref(js, pair, x, n, a=5)
    y = np.concatenate([ya, yb], 1)
    assert snr_db(y, whole) >= 160
    assert snr_db(y, ref) >= 160


@pytest.mark.parametrize("handoff", ["fresh", "reset", "crossfade",
                                     "convert"])
def test_graph_step_body_matches_step_df(handoff):
    """``GraphStep`` on CPU tensors runs ``step_df``'s body (the ring
    position on the device) eagerly on buffers of its own: over 3P + 5
    blocks, the ring wrapping 3 times, its outputs and states equal
    ``step_df``'s bit for bit and the reference's df64 ``step_df`` to >=
    160 dB, across a handoff at block P + 3 that each stream takes alike:
    none after the fresh state, a reset to a fresh state, an eager
    ``step_df_crossfade`` block to a second filter, or a round trip of the
    state through ``convert``."""
    c, n, p = 2, 64, 8
    blocks = 3 * p + 5
    h, x, ref = _problem(5, c, n, p, blocks=blocks)
    h2 = _problem(6, c, n, p)[0]
    tspec, jspec = _spec(n, p), _spec(n, p, JS, "float32")
    planes = [E.df_coeffs(g, tspec, c, device="cpu") for g in (h, h2)]
    pairs = [JE.df_coeffs(g, jspec, c) for g in (h, h2)]
    step = E.GraphStep()
    jstep, jxfade = jax.jit(JE.step_df), jax.jit(JE.step_df_crossfade)
    sg, se = (E.init_df_state(tspec, c, device="cpu") for _ in range(2))
    js = JE.init_df_state(jspec, c)
    yg, ye, yj = [], [], []
    k = 0  # the filter in use
    for b in range(blocks):
        blk = x[:, b * n:(b + 1) * n]
        tb, jb = torch.from_numpy(blk), jnp.asarray(blk)
        if b == p + 3 and handoff == "reset":
            sg, se = (E.init_df_state(tspec, c, device="cpu")
                      for _ in range(2))
            js = JE.init_df_state(jspec, c)
        if b == p + 3 and handoff == "convert":
            sg, se = (convert.df_state_from_numpy(
                convert.df_state_to_numpy(s), "cpu") for s in (sg, se))
        if b == p + 3 and handoff == "crossfade":
            sg, og = E.step_df_crossfade(sg, *planes, tb)
            se, oe = E.step_df_crossfade(se, *planes, tb)
            js, oj = jxfade(js, *pairs, jb)
            k = 1
        else:
            sg, og = step(sg, planes[k], tb)
            se, oe = E.step_df(se, planes[k], tb)
            js, oj = jstep(js, *pairs[k], jb)
        yg.append(og.numpy())
        ye.append(oe.numpy())
        yj.append(np.asarray(oj, np.float64))
    yg, ye, yj = (np.concatenate(y, 1) for y in (yg, ye, yj))
    np.testing.assert_array_equal(yg, ye)
    assert torch.equal(sg.ring, se.ring) and torch.equal(sg.prev, se.prev)
    assert sg.blockcounter == se.blockcounter == (
        blocks - p - 3 if handoff == "reset" else blocks)
    assert snr_db(yg, yj) >= 160
    if handoff == "fresh":
        assert snr_db(yg, ref) >= 240
    # no graph on the CPU
    assert step.graphs.captures == step.graphs.replays == 0


def test_init_df_state_refuses_missing_cuda():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            E.init_df_state(_spec(64, 4), 2, device="cuda")


# -- the session's extended mode ---------------------------------------------


def _config(path, spec=TS, mode="extended", **stream):
    """An EngineConfig of the port (``spec=TS``) or of the reference
    (``spec=JS``) at float64, block 256, from the same kwargs."""
    return spec.EngineConfig(
        filter=spec.FilterSpec(block_length=256, n_partitions=1,
                               dtype="float64"),
        stream=spec.StreamSpec(n_channels=2, sample_rate=44100, **stream),
        chain=spec.ChainSpec(files=(
            spec.ImpulseFileSpec(enabled=True, filename=path),
            spec.ImpulseFileSpec(), spec.ImpulseFileSpec())),
        engine_mode=mode)


def _save(tmp_path, name, h):
    p = str(tmp_path / name)
    wavio.write(p, np.asarray(h).T, 44100, subtype="float64")
    return p


def test_session_extended_engine_mode(tmp_path):
    """tests/test_engine.py::test_session_extended_engine_mode against the
    port: atol 1e-11 against scipy, ``_impl == "extended"``, a crossfade
    reconfigure; then ``render`` takes ``process_buffer`` (the bulk engine
    is never built) and returns T frames."""
    rng = np.random.default_rng(23)
    h = rng.standard_normal((2, 300)) * 0.05
    p = _save(tmp_path, "he.wav", h)
    sp = StreamProcessor(_config(p), ArtifactCache(str(tmp_path / "c")),
                         device="cpu")
    x = rng.standard_normal((2, 1024))
    y = sp.process(x)
    assert sp._impl == "extended" and y.dtype == np.float64
    ref = np.stack([signal.fftconvolve(x[c], h[c])[: y.shape[1]]
                    for c in range(2)])
    np.testing.assert_allclose(y, ref, atol=1e-11)
    h2 = h * 0.5
    p2 = _save(tmp_path, "he2.wav", h2)
    sp.reconfigure(_config(p2))
    assert sp._pending_swap is not None, "extended path must crossfade"
    y2 = sp.process(x)
    assert y2.shape == x.shape
    # the crossfade block ramps from the old filter to the new one
    full = np.concatenate([x, x], 1)
    old = np.stack([signal.fftconvolve(full[c], h[c])[1024:1280]
                    for c in range(2)])
    ramp = np.arange(256) / 255.0
    np.testing.assert_allclose(y2[:, :256], old * (1 - 0.5 * ramp),
                               atol=1e-11)
    np.testing.assert_allclose(
        y2[:, 256:], np.stack([signal.fftconvolve(full[c], h2[c])[1280:2048]
                               for c in range(2)]), atol=1e-11)
    # render: process_buffer, flushed to T frames, no bulk engine
    t = 1000
    yr = sp.render(x[:, :t])
    assert yr.shape == (2, t) and sp._bulk is None


def test_session_extended_render_and_raw_match_reference(tmp_path):
    """``render`` and undithered S24 ``process_raw`` in extended mode
    against the reference's extended session: render within 1e-12 of it
    and 1e-11 of scipy; the S24 bytes within one LSB (the two round
    float64 and df64 values to 24 bits)."""
    rng = np.random.default_rng(24)
    h = rng.standard_normal((2, 700)) * 0.05
    p = _save(tmp_path, "hr.wav", h)
    x = rng.standard_normal((2, 2000)) * 0.2
    tsp = StreamProcessor(_config(p), ArtifactCache(str(tmp_path / "t")),
                          device="cpu")
    jsp = JStreamProcessor(_config(p, JS), JArtifactCache(str(tmp_path / "j")))
    yt, yj = tsp.render(x), np.asarray(jsp.render(x), np.float64)
    assert yt.shape == yj.shape == x.shape
    np.testing.assert_allclose(yt, yj, atol=1e-12)
    ref = np.stack([signal.fftconvolve(x[c], h[c])[:2000] for c in range(2)])
    np.testing.assert_allclose(yt, ref, atol=1e-11)
    s24 = dict(in_format=TS.SampleFormat.S24_LE,
               out_format=TS.SampleFormat.S24_LE)
    js24 = dict(in_format=JS.SampleFormat.S24_LE,
                out_format=JS.SampleFormat.S24_LE)
    tsr = StreamProcessor(_config(p, **s24), ArtifactCache(str(tmp_path / "t")),
                          device="cpu")
    jsr = JStreamProcessor(_config(p, JS, **js24),
                           JArtifactCache(str(tmp_path / "j")))
    xi = np.round(x * 2 ** 23).astype(np.int32)
    raw = fm.encode_int(xi, TS.SampleFormat.S24_LE)
    bt, bj = tsr.process_raw(raw), jsr.process_raw(raw)
    assert tsr._impl == "extended" and len(bt) == len(bj) == 3 * 2 * 1792
    qt = fm.decode(bt, TS.SampleFormat.S24_LE, 2)
    qj = fm.decode(bj, TS.SampleFormat.S24_LE, 2)
    assert np.abs(qt - qj).max() <= 2.0 ** -23
