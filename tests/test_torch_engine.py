"""bfir_tpu_torch's engine layer on the CPU against bfir_tpu, case for case
with the reference's own tests: ``engine/cache`` and ``engine/chain``
(tests/test_engine.py:57-152), the session's stream handling (passthrough,
reblocking and ``flush``, reinit on a channel change, the NaN abort plain
and pipelined, overflow accounting, reconfigure from passthrough,
``reset``; tests/test_engine.py:158-255, :632), the self-check verdict
cache (tests/test_engine.py:491, tests/test_presets_checkpoint.py:185-246)
and the geometry-change reconfigures (tests/test_crossfade_coeffio.py:197,
:232). Each case builds the same config in both packages from the same
kwargs and the same seeded numpy inputs; scipy is the oracle where the
reference's test uses it.

Tolerance: composed impulses within 1e-12 x max|reference| (FFTs summed in
other orders); float64 sessions within 1e-10 absolute of each other and of
scipy (the reference tests' 1e-10), float32 sessions within 1e-5 x
max|scipy|; passthrough and NaN-abort output bit for bit."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import signal

from bfir_tpu.core import spec as JS
from bfir_tpu.engine import selfcheck as jselfcheck
from bfir_tpu.engine.cache import ArtifactCache as JaxArtifactCache
from bfir_tpu.engine.chain import build_chain as jax_build_chain
from bfir_tpu.engine.session import StreamProcessor as JaxStreamProcessor
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine import selfcheck
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.chain import build_chain
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.ops import formats as F

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


def save_impulse(tmp_path, name, imp, rate=44100):
    p = str(tmp_path / name)
    wavio.write(p, np.asarray(imp).T, rate, subtype="float64")
    return p


def make_config(spec, files=(), eq_enabled=False, block=256, dtype="float64",
                mode="auto"):
    """tests/test_engine.py's make_config in the package of ``spec`` (TS:
    the port, JS: the reference)."""
    fspecs = [spec.ImpulseFileSpec(enabled=True, filename=f, level_steps=lv,
                                   resample=rs) for f, lv, rs in files]
    fspecs += [spec.ImpulseFileSpec()] * (3 - len(fspecs))
    return spec.EngineConfig(
        filter=spec.FilterSpec(block_length=block, n_partitions=1,
                               dtype=dtype),
        stream=spec.StreamSpec(n_channels=2, sample_rate=44100),
        chain=spec.ChainSpec(eq=spec.EqSpec(enabled=eq_enabled),
                             files=tuple(fspecs)),
        eq_filter_blocks=8, engine_mode=mode)


def sessions(tmp_path, **kw):
    """The port's and the reference's StreamProcessor on the same config,
    each with a cache of its own."""
    tsp = StreamProcessor(make_config(TS, **kw),
                          ArtifactCache(str(tmp_path / "torch")), device="cpu")
    jsp = JaxStreamProcessor(make_config(JS, **kw),
                             JaxArtifactCache(str(tmp_path / "jax")))
    return tsp, jsp


def _close(got, ref, atol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _scipy(x, h, length):
    return np.stack([signal.fftconvolve(x[c], h[c])[:length]
                     for c in range(x.shape[0])])


# -- cache --------------------------------------------------------------------


def test_cache_filenames_and_clean_temp(tmp_path):
    caches = (ArtifactCache(str(tmp_path / "p")),
              JaxArtifactCache(str(tmp_path / "p")))
    names = []
    for cache in caches:
        names.append((
            cache.eq_filename([20.0], [0.0], [0.0], 512, 8, 2, 44100),
            cache.resampled_filename("/a/b.wav", 2, 96000),
            cache.preconvolved_filename(["a", "b"], 1000, 8, 2, 44100)))
        p = cache.temp_path("x.txt")
        with open(p, "w") as f:
            f.write("hi")
        cache.clean_temp()
        assert not os.path.exists(p) and os.path.isdir(cache.temp)
    assert names[0] == names[1]
    eq, rs, pre = names[0]
    assert "/temp/eq-" in eq and eq.endswith("-512-8-2-44100.wav")
    assert "/temp/ir-" in rs and rs.endswith("-2-96000.wav")
    assert "/temp/file-" in pre and pre.endswith("-1000-8-2-44100.wav")


# -- chain --------------------------------------------------------------------


def _chain_case(tmp_path, case):
    """make_config kwargs and the reference test's own check of a case."""
    rng = np.random.default_rng(0)
    if case == "inactive":
        return {}, lambda b, c: b.impulse is None
    if case == "single":  # +6 dB level
        imp = rng.standard_normal((2, 300)) * 0.1
        return ({"files": [(save_impulse(tmp_path, "a.wav", imp), 60, False)]},
                lambda b, c: (np.allclose(b.impulse, imp, rtol=0, atol=1e-12)
                              and np.isclose(b.scale, 10 ** 0.3)
                              and b.n_partitions == 2))
    if case == "two_files":  # (a * b scale_b) cut to max(200, 150)
        a = rng.standard_normal((2, 200)) * 0.2
        b = rng.standard_normal((2, 150)) * 0.2
        ref = np.stack([np.convolve(a[c], b[c] * 10 ** 0.1)[:200]
                        for c in range(2)])
        return ({"files": [(save_impulse(tmp_path, "a.wav", a), 0, False),
                           (save_impulse(tmp_path, "b.wav", b), 20, False)]},
                lambda bc, c: (np.allclose(bc.impulse, ref, rtol=0, atol=1e-10)
                               and bc.scale == 1.0))
    if case == "rate_drop":  # foo_dsp_bfir.cpp:183-190
        p = save_impulse(tmp_path, "w.wav", np.ones((2, 100)) * 0.1, 48000)
        return {"files": [(p, 0, False)]}, lambda b, c: b.impulse is None
    if case == "rate_resample":
        imp = np.zeros((2, 480))
        imp[:, 0] = 0.5
        p = save_impulse(tmp_path, "rs.wav", imp, 48000)
        return ({"files": [(p, 0, True)]},
                lambda b, c: (b.impulse.shape == (2, 441) and os.path.exists(
                    c.resampled_filename(p, 2, 44100))))
    if case == "mono":
        imp = np.zeros((1, 64))
        imp[0, 0] = 1.0
        p = save_impulse(tmp_path, "mono.wav", imp)
        return ({"files": [(p, 0, False)]},
                lambda b, c: b.impulse.shape == (2, 64))
    assert case == "eq"  # flat EQ: a near-dirac of half the EQ taps, cached
    return ({"eq_enabled": True},
            lambda b, c: (b.impulse.shape == (2, 256 * 8 // 2)
                          and abs(b.impulse[0, 0] - 1.0) < 1e-6
                          and glob.glob(str(c.temp / "eq-*.wav"))))


@pytest.mark.parametrize("case", ["inactive", "single", "two_files",
                                  "rate_drop", "rate_resample", "mono", "eq"])
def test_chain_matches_reference(tmp_path, case):
    kw, check = _chain_case(tmp_path, case)
    tcache = ArtifactCache(str(tmp_path / "torch"))
    jcache = JaxArtifactCache(str(tmp_path / "jax"))
    tcfg, jcfg = make_config(TS, **kw), make_config(JS, **kw)
    tb = build_chain(tcfg, tcfg.stream, tcache)
    jb = jax_build_chain(jcfg, jcfg.stream, jcache)
    assert check(tb, tcache) and check(jb, jcache)
    assert (tb.scale, tb.n_partitions) == (jb.scale, jb.n_partitions)
    if jb.impulse is None:
        assert tb.impulse is None
    else:
        _close(tb.impulse, jb.impulse, 1e-12 * np.abs(jb.impulse).max())


# -- session ------------------------------------------------------------------


def test_session_passthrough_when_unconfigured(tmp_path):
    tsp, jsp = sessions(tmp_path)
    x = np.random.default_rng(0).standard_normal((2, 1000))
    np.testing.assert_array_equal(tsp.process(x), x)
    np.testing.assert_array_equal(jsp.process(x), x)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_session_filters_reblocks_and_flushes(tmp_path, dtype):
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 300)) * 0.05
    tsp, jsp = sessions(tmp_path, dtype=dtype,
                        files=[(save_impulse(tmp_path, "h.wav", h), 0, False)])
    x = rng.standard_normal((2, 2000))
    ys = []
    for sp in (tsp, jsp):  # awkward chunks
        outs = [sp.process(x[:, a:b])
                for a, b in ((0, 100), (100, 700), (700, 2000))]
        ys.append(np.concatenate([o for o in outs if o.size], axis=1))
    yt, yj = ys
    assert yt.shape == yj.shape == (2, 1792)  # 7 blocks of 256
    ref = _scipy(x, h, 1792)
    atol = 1e-10 if dtype == "float64" else 1e-5 * np.abs(ref).max()
    _close(yt, ref, atol)
    _close(yt, yj, atol)
    # flush drops the partial 208 frames: the next 256 make one block
    x2 = rng.standard_normal((2, 256))
    for sp in (tsp, jsp):
        sp.flush()
    yt2, yj2 = tsp.process(x2), jsp.process(x2)
    assert yt2.shape == (2, 256)
    _close(yt2, yj2, atol)


def test_session_reinit_on_channel_change(tmp_path):
    h = np.zeros((2, 10))
    h[:, 0] = 1.0
    tsp, jsp = sessions(tmp_path,
                        files=[(save_impulse(tmp_path, "d.wav", h), 0, False)])
    x2 = np.random.default_rng(3).standard_normal((2, 512))
    yt, yj = tsp.process(x2), jsp.process(x2)
    assert yt.shape == (2, 512)
    _close(yt, yj, 1e-10)
    _close(yt, x2, 1e-10)
    # 3 channels: the 2-channel impulse drops out of the chain: passthrough
    x3 = np.random.default_rng(4).standard_normal((3, 512))
    np.testing.assert_array_equal(tsp.process(x3), x3)
    np.testing.assert_array_equal(jsp.process(x3), x3)


def _raw_sessions(tmp_path, files):
    """``sessions`` with float input bytes and S16 output bytes: the
    port's ``process_raw`` keeps an integer output on the device."""
    cfgs = [make_config(spec, files=files) for spec in (TS, JS)]
    cfgs = [dataclasses.replace(cfg, stream=dataclasses.replace(
        cfg.stream, out_format=spec.SampleFormat.S16_LE))
        for cfg, spec in zip(cfgs, (TS, JS))]
    return (StreamProcessor(cfgs[0], ArtifactCache(str(tmp_path / "torch")),
                            device="cpu"),
            JaxStreamProcessor(cfgs[1],
                               JaxArtifactCache(str(tmp_path / "jax"))))


@pytest.mark.parametrize("case", ["plain", "pipelined", "crossfade",
                                  "crossfade_raw"])
def test_session_nan_abort_to_passthrough(tmp_path, case):
    """A NaN block turns the engine to passthrough. Pipelined
    (tests/test_engine.py:632): the offending block and every later one of
    the same call pass through, no sample lost (brutefir.cpp:313-321).
    Crossfade: after a ``reconfigure``, a NaN in the change block passes
    that block through and drops the rest of the call, as the reference
    does, through ``process`` and through ``process_raw`` to S16 (the
    port's output kept on the device)."""
    h = np.zeros((2, 10))
    h[:, 0] = 1.0  # a dirac: the filtered blocks equal the input too
    p = save_impulse(tmp_path, "d2.wav", h)
    if case.startswith("crossfade"):
        x = np.random.default_rng(78).uniform(-0.4, 0.4, (2, 8 * 256))
        x[:, 3 * 256] = np.nan  # first sample of block 3, the change block
        h2 = 0.5 * h
        files2 = [(save_impulse(tmp_path, "d3.wav", h2), 0, False)]
        if case == "crossfade":
            tsp, jsp = sessions(tmp_path, files=[(p, 0, False)])
            call = lambda sp, v: sp.process(v)  # noqa: E731
        else:
            tsp, jsp = _raw_sessions(tmp_path, [(p, 0, False)])
            call = lambda sp, v: F.decode(  # noqa: E731
                sp.process_raw(F.encode_float(v, TS.SampleFormat.FLOAT_LE)),
                TS.SampleFormat.S16_LE, 2)
        ys = []
        for sp, spec in ((tsp, TS), (jsp, JS)):
            before = call(sp, x[:, :3 * 256])
            after = _reconfigure_then(sp, spec, files2, call, x[:, 3 * 256:])
            ys.append(np.concatenate([before, after], axis=1))
        yt, yj = ys
        # the change block passes through; the rest of the call is dropped
        assert yt.shape == yj.shape == (2, 4 * 256)
        want, tol = x[:, :4 * 256], 1e-9
        if case == "crossfade_raw":
            # the NaN sample's integer is the cast's own: leave it out
            fin = np.isfinite(want)
            yt, yj, want = (np.where(fin, y, 0) for y in (yt, yj, want))
            tol = 1.01 / 32768.0
        np.testing.assert_array_equal(yt[:, 3 * 256:], yj[:, 3 * 256:])
        _close(yt, yj, tol)
        _close(yt, want, tol)
        x2 = np.full((2, 256), 0.25)
    else:
        tsp, jsp = sessions(tmp_path, files=[(p, 0, False)])
        if case == "pipelined":
            x = np.random.default_rng(77).standard_normal((2, 8 * 256))
            x[:, 3 * 256] = np.nan  # first sample of block 3
        else:
            x = np.full((2, 256), np.nan)
        yt, yj = tsp.process(x), jsp.process(x)
        assert yt.shape == yj.shape == x.shape
        np.testing.assert_array_equal(yt[:, 3 * 256:], x[:, 3 * 256:])
        np.testing.assert_array_equal(yt[:, 3 * 256:], yj[:, 3 * 256:])
        _close(yt, yj, 1e-9)
        _close(yt, x, 1e-9)
        x2 = np.ones((2, 256))
        call = lambda sp, v: sp.process(v)  # noqa: E731
    assert tsp._failed and jsp._failed
    np.testing.assert_array_equal(call(tsp, x2), x2)
    np.testing.assert_array_equal(call(jsp, x2), x2)


def _reconfigure_then(sp, spec, files, call, x):
    """``reconfigure`` ``sp`` to ``files`` (the engine's geometry kept: a
    crossfade at the next block), then ``call(sp, x)``."""
    cfg = make_config(spec, files=files)
    if sp.config.stream.out_format != cfg.stream.out_format:
        cfg = dataclasses.replace(cfg, stream=dataclasses.replace(
            cfg.stream, out_format=sp.config.stream.out_format))
    sp.reconfigure(cfg)
    return call(sp, x)


def test_session_overflow_accounting(tmp_path):
    h = np.zeros((2, 4))
    h[:, 0] = 10.0  # +20 dB: over float full scale
    p = save_impulse(tmp_path, "hot.wav", h)
    tsp, jsp = sessions(tmp_path, files=[(p, 0, False)])
    tsp.process(np.ones((2, 512)))
    jsp.process(np.ones((2, 512)))
    tof, jof = tsp.overflow_stats(), jsp.overflow_stats()
    assert int(tof.n_overflows[0]) > 0 and float(tof.largest[0]) > 9.0
    np.testing.assert_array_equal(tof.n_overflows, jof.n_overflows)
    _close(tof.largest, jof.largest, 1e-12)


def test_session_reconfigure_from_passthrough(tmp_path):
    tsp, jsp = sessions(tmp_path)
    x = np.ones((2, 512)) * 0.1
    np.testing.assert_array_equal(tsp.process(x), x)
    np.testing.assert_array_equal(jsp.process(x), x)
    h = np.zeros((2, 4))
    h[:, 0] = 2.0
    files = [(save_impulse(tmp_path, "g.wav", h), 0, False)]
    tsp.reconfigure(make_config(TS, files=files))
    jsp.reconfigure(make_config(JS, files=files))
    yt, yj = tsp.process(x), jsp.process(x)
    _close(yt, 0.2 * np.ones((2, 512)), 1e-12)
    _close(yt, yj, 1e-12)


def test_session_reset(tmp_path):
    """reset clears the running state (brutefir.cpp:345-367): the stream
    after it equals a fresh session's, in both packages."""
    rng = np.random.default_rng(8)
    h = rng.standard_normal((2, 600)) * 0.05
    files = [(save_impulse(tmp_path, "r.wav", h), 0, False)]
    tsp, jsp = sessions(tmp_path, files=files)
    x1 = rng.standard_normal((2, 3 * 256 + 100))
    x2 = rng.standard_normal((2, 4 * 256))
    for sp in (tsp, jsp):
        sp.process(x1)
        sp.reset()
    yt, yj = tsp.process(x2), jsp.process(x2)
    ref = _scipy(x2, h, 4 * 256)
    _close(yt, ref, 1e-10)
    _close(yt, yj, 1e-10)


# -- the self-check verdict cache --------------------------------------------


def _oracle_calls(monkeypatch, module):
    calls = []
    real = module._oracle
    monkeypatch.setattr(module, "_oracle",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_selfcheck_verdict_cache(tmp_path, monkeypatch):
    """A second build with the same key skips the full check and runs only
    the spot check; new coefficients run it again (tests/test_engine.py:491).
    The port and the reference call the oracle the same number of times."""
    rng = np.random.default_rng(41)
    h = rng.standard_normal((2, 900)) * 0.05
    p, p2 = (save_impulse(tmp_path, "hck.wav", h),
             save_impulse(tmp_path, "hck2.wav", h * 0.5))
    counts = []
    for spec, mod, make in (
            (TS, selfcheck, lambda cfg, c: StreamProcessor(
                cfg, ArtifactCache(c), device="cpu")),
            (JS, jselfcheck, lambda cfg, c: JaxStreamProcessor(
                cfg, JaxArtifactCache(c)))):
        calls = _oracle_calls(monkeypatch, mod)
        cache_dir = str(tmp_path / spec.__name__)
        seen = []
        for path in (p, p, p2):
            sp = make(make_config(spec, files=[(path, 0, False)],
                                  mode="packed"), cache_dir)
            sp.process(np.zeros((2, 256)))
            assert sp._impl == "packed"
            seen.append(len(calls))
        assert os.path.exists(os.path.join(cache_dir, "selfcheck-cache.json"))
        counts.append(seen)
    assert counts[0] == counts[1]
    first, cached, rerun = counts[0]
    assert first >= 1 and cached == first + 1 and rerun > cached


def test_selfcheck_failure_verdict_expires(tmp_path):
    """A cached failure ages out after FAILURE_TTL_S; a pass is kept."""
    got = []
    for mod in (selfcheck, jselfcheck):
        cf = str(tmp_path / f"{mod.__name__}.json")
        mod.store_verdict(cf, "kfail", 4.0, False)
        mod.store_verdict(cf, "kpass", 130.0, True)
        fresh = mod.load_verdict(cf, "kfail")["ok"]
        with open(cf) as f:
            data = json.load(f)
        for v in data.values():
            v["t"] -= mod.FAILURE_TTL_S + 10
        with open(cf, "w") as f:
            json.dump(data, f)
        got.append((fresh, mod.load_verdict(cf, "kfail"),
                    mod.load_verdict(cf, "kpass")["ok"]))
    assert got[0] == got[1] == (False, None, True)
    assert selfcheck.FAILURE_TTL_S == jselfcheck.FAILURE_TTL_S


def test_selfcheck_cached_pass_spot_checked(tmp_path):
    """A cached pass still gets a 2-block spot check; a step that turns bad
    contradicts it and the full check refuses it
    (tests/test_presets_checkpoint.py:210)."""
    c = 2
    spec, jspec = (S.FilterSpec(block_length=64, n_partitions=2,
                                dtype="float32") for S in (TS, JS))
    h = np.zeros((c, spec.max_taps), np.float32)
    h[:, 0] = 1.0  # a dirac
    sides = {
        "torch": (lambda st, co, blk: (st, blk),
                  lambda st, co, blk: (st, blk + 0.05),
                  lambda step, cf: selfcheck.check_stream(
                      step, lambda: None, None, h, spec, c, device="cpu",
                      cache_file=cf, label="x"),
                  selfcheck.EngineSelfCheckError),
        "jax": (lambda st, co, blk: (st, jnp.asarray(blk)),
                lambda st, co, blk: (st, jnp.asarray(blk) + 0.05),
                lambda step, cf: jselfcheck.check_stream(
                    step, lambda: None, None, h, jspec, c, cache_file=cf,
                    label="x"),
                jselfcheck.EngineSelfCheckError)}
    snrs = {}
    for side, (good, bad, check, error) in sides.items():
        cf = str(tmp_path / f"{side}.json")
        s1 = check(good, cf)
        assert s1 > 100
        assert check(good, cf) == s1  # cached pass, spot check passes
        calls = []
        with pytest.raises(error):
            check(lambda *a: calls.append(1) or bad(*a), cf)
        assert len(calls) >= 2  # the spot check and the full check streamed
        snrs[side] = (s1, len(calls))
    assert snrs["torch"] == snrs["jax"]


# -- reconfigures that change the geometry ------------------------------------


@pytest.mark.parametrize("mode", ["auto", "hc", "nonuniform"])
def test_reconfigure_geometry_change_reinits(tmp_path, mode):
    """A reconfigure to a longer impulse rebuilds at 2 partitions
    (tests/test_crossfade_coeffio.py:197)."""
    h1 = np.zeros((2, 8))
    h1[:, 0] = 1.0
    h_long = np.zeros((2, 400))
    h_long[:, 0] = 0.5
    p1 = save_impulse(tmp_path, "a.wav", h1)
    p2 = save_impulse(tmp_path, "long.wav", h_long)
    tsp, jsp = sessions(tmp_path, files=[(p1, 0, False)], mode=mode)
    ys = []
    for sp, spec in ((tsp, TS), (jsp, JS)):
        sp.process(np.ones((2, 256)))
        assert sp.n_partitions == 1
        sp.reconfigure(make_config(spec, files=[(p2, 0, False)], mode=mode))
        ys.append(sp.process(np.ones((2, 256))))
        assert sp.n_partitions == 2
    _close(ys[0][:, -1], 0.5 * np.ones(2), 1e-9)
    _close(ys[0], ys[1], 1e-9)
    assert tsp._impl == jsp._impl


@pytest.mark.parametrize("mode", ["auto", "hc", "nonuniform"])
def test_stale_swap_voided_by_geometry_change(tmp_path, mode):
    """A queued same-geometry swap does not survive a later reconfigure
    that changes the partition count (tests/test_crossfade_coeffio.py:232)."""
    h = np.zeros((2, 8))
    h[:, 0] = 1.0
    h_long = np.zeros((2, 500))
    h_long[:, 0] = 0.5
    p1 = save_impulse(tmp_path, "a.wav", h)
    p2 = save_impulse(tmp_path, "b.wav", h_long)
    tsp, jsp = sessions(tmp_path, files=[(p1, 0, False)], mode=mode)
    ys = []
    for sp, spec in ((tsp, TS), (jsp, JS)):
        sp.process(np.ones((2, 256)))
        sp.reconfigure(make_config(spec, files=[(p1, -60, False)], mode=mode))
        assert sp._pending_swap is not None  # a level change: queued
        sp.reconfigure(make_config(spec, files=[(p2, 0, False)], mode=mode))
        ys.append(sp.process(np.ones((2, 512))))
        assert np.isfinite(ys[-1]).all() and sp.n_partitions == 2
    _close(ys[0], ys[1], 1e-9)
