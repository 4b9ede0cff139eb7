"""bfir_tpu_torch's ``engine_mode="sharded"`` session on CPU meshes, case
for case with the reference's tests/test_session_sharded.py: the sharded
session against the complex engine (``process``, ``process_buffer``, a
mid-stream crossfade), the self-check guard, the two-stage local engine
with its two-phase reconfigure and the three-stage local engine with its
rebuild. Where the reference falls back to another engine (a failing
build, a refused self-check) the port raises. The local engine the session
picks is held to the one the reference's fall-through reaches, by running
that fall-through on the reference's own ``ShardedEngine``.

The reference's sharded non-uniform *session* is not built here (it
sometimes aborts inside XLA); the comparisons use the reference's complex
session, its ``ShardedEngine`` and scipy.

Tolerances: 1e-10 absolute at float64 (the reference tests' bound);
float32 streams against scipy > 100 dB, as the reference's."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from scipy import signal

import jax

from bfir_tpu.core import spec as JS
from bfir_tpu.core.spec import FilterSpec as JFilterSpec
from bfir_tpu.engine.cache import ArtifactCache as JaxArtifactCache
from bfir_tpu.engine.session import StreamProcessor as JaxStreamProcessor
from bfir_tpu.parallel import mesh as JM
from bfir_tpu.parallel import sharded as JSH
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine import selfcheck
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.parallel import mesh as M
from bfir_tpu_torch.parallel import sharded as SH

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


@pytest.fixture
def cache(tmp_path):
    return ArtifactCache(str(tmp_path / "profile"))


def cpu_mesh(c_s=1, p_s=8):
    return M.make_mesh(c_s, p_s, devices=["cpu"] * (c_s * p_s))


def save_impulse(tmp_path, name, imp, rate=44100):
    p = str(tmp_path / name)
    wavio.write(p, np.asarray(imp).T, rate, subtype="float64")
    return p


def make_config(spec, fname, block=256, engine_mode="sharded", level=0,
                **kw):
    """The reference test's make_config in the package of ``spec``."""
    files = [spec.ImpulseFileSpec(enabled=True, filename=fname,
                                  level_steps=level),
             spec.ImpulseFileSpec(), spec.ImpulseFileSpec()]
    return spec.EngineConfig(
        filter=spec.FilterSpec(block_length=block, n_partitions=1,
                               dtype=kw.pop("dtype", "float64")),
        stream=spec.StreamSpec(n_channels=2, sample_rate=44100),
        chain=spec.ChainSpec(eq=spec.EqSpec(), files=tuple(files)),
        engine_mode=engine_mode, **kw)


@pytest.fixture
def impulse_file(tmp_path):
    rng = np.random.default_rng(3)
    imp = rng.standard_normal((2, 700)) * 0.1  # 3 partitions at block 256
    return save_impulse(tmp_path, "ir.wav", imp), imp


def _scipy(x, imp, length):
    return np.stack([signal.fftconvolve(x[c], imp[c])[:length]
                     for c in range(x.shape[0])])


def _snr_db(y, ref):
    return 10 * np.log10(float((ref ** 2).sum())
                         / float(((y - ref) ** 2).sum()))


def test_sharded_session_matches_complex(cache, tmp_path, impulse_file):
    fname, _ = impulse_file
    x = np.random.default_rng(4).standard_normal((2, 256 * 5))
    sp = StreamProcessor(make_config(TS, fname), cache, device="cpu",
                         mesh=cpu_mesh())
    y = sp.process(x)
    assert sp._impl == "sharded" and sp._sharded.local_impl == "complex"
    # 3 partitions round up to the mesh's p
    assert sp._runtime_filter_spec.n_partitions == 8
    jsp = JaxStreamProcessor(make_config(JS, fname, engine_mode="complex"),
                             JaxArtifactCache(str(tmp_path / "j")))
    np.testing.assert_allclose(y, jsp.process(x), atol=1e-10)
    tsp = StreamProcessor(make_config(TS, fname, engine_mode="complex"),
                          cache, device="cpu")
    np.testing.assert_allclose(y, tsp.process(x), atol=1e-10)


def test_sharded_session_process_buffer(cache, tmp_path, impulse_file):
    fname, _ = impulse_file
    x = np.random.default_rng(5).standard_normal((2, 256 * 6 + 100))
    sp = StreamProcessor(make_config(TS, fname), cache, device="cpu",
                         mesh=cpu_mesh(2, 4))
    y_s = sp.process_buffer(x)
    assert y_s.shape == (2, 256 * 6)
    jsp = JaxStreamProcessor(make_config(JS, fname, engine_mode="complex"),
                             JaxArtifactCache(str(tmp_path / "j")))
    np.testing.assert_allclose(y_s, jsp.process_buffer(x), atol=1e-10)
    # render takes process_buffer on the sharded engine, T frames back
    sp2 = StreamProcessor(make_config(TS, fname), cache, device="cpu",
                          mesh=cpu_mesh(2, 4))
    y_r = sp2.render(x)
    assert y_r.shape == x.shape
    np.testing.assert_allclose(y_r[:, :256 * 6], y_s, atol=1e-10)


def test_sharded_session_midstream_reconfigure_crossfade(cache, tmp_path,
                                                         impulse_file):
    """A mid-stream filter change on the sharded engine: the crossfade
    block, identical to the reference's complex path."""
    fname, _ = impulse_file
    rng = np.random.default_rng(6)
    fname2 = save_impulse(tmp_path, "ir2.wav",
                          rng.standard_normal((2, 700)) * 0.1)
    x = rng.standard_normal((2, 256 * 6))
    outs = {}
    for pkg in (TS, JS):
        mode = "sharded" if pkg is TS else "complex"
        if pkg is TS:
            sp = StreamProcessor(make_config(pkg, fname, engine_mode=mode),
                                 cache, device="cpu", mesh=cpu_mesh(2, 4))
        else:
            sp = JaxStreamProcessor(make_config(pkg, fname, engine_mode=mode),
                                    JaxArtifactCache(str(tmp_path / "j")))
        y1 = sp.process(x[:, :256 * 3])
        sp.reconfigure(make_config(pkg, fname2, engine_mode=mode))
        assert sp._pending_swap is not None, "same geometry => crossfade"
        y2 = sp.process(x[:, 256 * 3:])
        outs[pkg.__name__] = np.concatenate([y1, y2], axis=1)
    np.testing.assert_allclose(outs[TS.__name__], outs[JS.__name__],
                               atol=1e-10)


def _corrupt(monkeypatch, name):
    """Make ``parallel.sharded.<name>``'s steps add 0.01 to every output
    (a deterministic fault, as a miscompile would be)."""
    orig = getattr(SH, name)

    def corrupted(*a, **k):
        step = orig(*a, **k)

        def bad(state, coeffs, block):
            st, out = step(state, coeffs, block)
            return st, out + 0.01
        return bad

    monkeypatch.setattr(SH, name, corrupted)


def test_self_check_refuses_corrupted_engine(cache, tmp_path, impulse_file,
                                            monkeypatch):
    """The known-answer guard fires on a faulty sharded step; the port
    raises (the reference refuses and passes through)."""
    _corrupt(monkeypatch, "make_ppermute_step")
    fname, _ = impulse_file
    sp = StreamProcessor(make_config(TS, fname), cache, device="cpu",
                         mesh=cpu_mesh())
    x = np.random.default_rng(7).standard_normal((2, 1024))
    with pytest.raises(selfcheck.EngineSelfCheckError, match="sharded"):
        sp.process(x)
    assert not sp._active


def test_failing_sharded_build_raises(cache, tmp_path, impulse_file,
                                      monkeypatch):
    """A failing sharded build propagates (the reference falls back to the
    complex engine)."""
    class Boom:
        def __init__(self, *a, **k):
            raise RuntimeError("no mesh for you")

    monkeypatch.setattr(SH, "ShardedEngine", Boom)
    fname, _ = impulse_file
    sp = StreamProcessor(make_config(TS, fname), cache, device="cpu",
                         mesh=cpu_mesh())
    with pytest.raises(RuntimeError, match="no mesh for you"):
        sp.process(np.zeros((2, 256 * 4)))
    assert not sp._active and sp._channels == 0


def test_self_check_can_be_disabled(cache, tmp_path, impulse_file,
                                    monkeypatch):
    _corrupt(monkeypatch, "make_ppermute_step")
    fname, imp = impulse_file
    cfg = dataclasses.replace(make_config(TS, fname), self_check=False)
    sp = StreamProcessor(cfg, cache, device="cpu", mesh=cpu_mesh())
    x = np.random.default_rng(9).standard_normal((2, 1024))
    y = sp.process(x)
    assert sp._active  # explicit opt-out skips the guard
    np.testing.assert_allclose(y - 0.01, _scipy(x, imp, 1024), atol=1e-9)


def _long_impulse(tmp_path, rng, block=128, tail_parts=3):
    taps = 16 * block + tail_parts * 8 * block + 50
    imp = rng.standard_normal((2, taps)) * 0.05
    return save_impulse(tmp_path, "irlong.wav", imp), imp


def test_sharded_session_nonuniform_local(cache, tmp_path):
    """sharded_local="nonuniform": the sharded two-stage engine behind the
    session, against scipy; a mid-stream reconfigure drives the two-phase
    (ramp, hold) protocol and converges to the new filter."""
    rng = np.random.default_rng(40)
    block = 128
    fname, imp = _long_impulse(tmp_path, rng, block)
    cfg = make_config(TS, fname, block=block, dtype="float32",
                      sharded_local="nonuniform")
    sp = StreamProcessor(cfg, cache, device="cpu", mesh=cpu_mesh())
    x = rng.standard_normal((2, 40 * block))
    y = sp.process(x)
    assert sp._impl == "sharded" and sp._sharded.local_impl == "nonuniform"
    assert sp._nuspec.p_tail % 8 == 0  # padded to the mesh
    assert _snr_db(y, _scipy(x, imp, y.shape[1])) > 100

    imp2 = np.random.default_rng(41).standard_normal(imp.shape) * 0.05
    fname2 = save_impulse(tmp_path, "irlong2.wav", imp2)
    sp.reconfigure(make_config(TS, fname2, block=block, dtype="float32",
                               sharded_local="nonuniform"))
    assert sp._pending_swap is not None, "same geometry => crossfade queued"
    state = sp._state
    x2 = rng.standard_normal((2, 40 * block))
    y2 = sp.process(x2)
    assert sp._nu_old is None and sp._state is not state
    full = np.concatenate([x, x2], axis=1)
    ref2 = _scipy(full, imp2, full.shape[1])
    seg = slice(70 * block, 80 * block)
    assert _snr_db(np.concatenate([y, y2], axis=1)[:, seg],
                   ref2[:, seg]) > 100


def test_sharded_session_nu_selfcheck_refuses(cache, tmp_path, monkeypatch):
    """A faulty sharded two-stage step is refused by the self-check; the
    port raises (the reference falls back to the uniform sharded
    engine)."""
    _corrupt(monkeypatch, "make_ppermute_step_nu")
    rng = np.random.default_rng(42)
    block = 128
    fname, _ = _long_impulse(tmp_path, rng, block)
    cfg = make_config(TS, fname, block=block, dtype="float32",
                      sharded_local="nonuniform")
    sp = StreamProcessor(cfg, cache, device="cpu", mesh=cpu_mesh(2, 4))
    with pytest.raises(selfcheck.EngineSelfCheckError, match="nonuniform"):
        sp.process(rng.standard_normal((2, 16 * block)))


def test_sharded_session_nonuniform3_local(cache, tmp_path):
    """sharded_local="nonuniform3" through ``process_buffer`` (the macro
    steps on super-cycle-aligned work) against scipy; reconfigure is a
    rebuild."""
    rng = np.random.default_rng(70)
    block = 128
    taps = 40960  # 320 partitions: beyond outer + inner head coverage
    imp = rng.standard_normal((2, taps)) * 0.05
    fname = save_impulse(tmp_path, "irnu3.wav", imp)
    cfg = make_config(TS, fname, block=block, dtype="float32",
                      sharded_local="nonuniform3", self_check=False)
    sp = StreamProcessor(cfg, cache, device="cpu", mesh=cpu_mesh(2, 4))
    sup = 64  # r1 * r2 of the geometry
    x = rng.standard_normal((2, 4 * sup * block))
    y = sp.process_buffer(x)
    assert sp._sharded.local_impl == "nonuniform3"
    assert _snr_db(y, _scipy(x, imp, y.shape[1])) > 100

    fname2 = save_impulse(tmp_path, "irnu3b.wav", imp * 0.5)
    sp.reconfigure(make_config(TS, fname2, block=block, dtype="float32",
                               sharded_local="nonuniform3",
                               self_check=False))
    assert sp._pending_swap is None and sp._channels == 0  # rebuild
    y2 = sp.process_buffer(rng.standard_normal((2, sup * block)))
    assert sp._sharded.local_impl == "nonuniform3"
    assert y2.shape[1] == sup * block


def test_sharded_session_hc_local_matches_reference_engine(cache, tmp_path,
                                                           monkeypatch):
    """The uniform hc local engine (a CUDA mesh's default) behind the
    session, held to the reference's ShardedEngine with local_impl="hc" on
    the same blocks."""
    monkeypatch.setattr(StreamProcessor, "_sharded_local",
                        lambda self, fspec: "hc")
    rng = np.random.default_rng(12)
    imp = (rng.standard_normal((2, 1000)) * 0.1).astype(np.float32)
    fname = save_impulse(tmp_path, "irhc.wav", imp)
    sp = StreamProcessor(make_config(TS, fname, block=128, dtype="float32"),
                         cache, device="cpu", mesh=cpu_mesh(2, 4))
    x = rng.standard_normal((2, 10 * 128)).astype(np.float32)
    y = sp.process(x)
    assert sp._sharded.local_impl == "hc"
    jeng = JSH.ShardedEngine(JFilterSpec(128, 8, "float32"), 2,
                             JM.make_mesh(2, 4), local_impl="hc")
    jco = jeng.prepare_coeffs(imp)
    jst = jeng.init_state()
    ref = []
    for b in range(10):
        jst, o = jeng.step(jst, jco, x[:, b * 128:(b + 1) * 128])
        ref.append(np.asarray(o))
    ref = np.concatenate(ref, axis=1)
    np.testing.assert_allclose(y, ref, atol=1e-5 * np.abs(ref).max())


def _reference_fallthrough(want, parts, block, p_s):
    """The local engine the reference session reaches: its ShardedEngine
    tried in the order of its ValueError fall-through
    (bfir_tpu/engine/session.py:531-553) on a CPU mesh."""
    jmesh = JM.make_mesh(1, p_s, devices=jax.devices()[:p_s])
    spec = JFilterSpec(block, parts, "float32")
    order = {"nonuniform3": ["nonuniform3", "nonuniform", None],
             "nonuniform": ["nonuniform", None], "uniform": [None]}[want]
    for local in order:
        try:
            return JSH.ShardedEngine(spec, 2, jmesh, local_impl=local
                                     ).local_impl
        except ValueError:
            if local is None:
                raise
    raise AssertionError("unreachable")


@pytest.mark.parametrize("want", ["nonuniform3", "nonuniform", "uniform"])
@pytest.mark.parametrize("p_s", [1, 3, 8])
@pytest.mark.parametrize("parts", [8, 17, 144, 150, 320])
def test_local_engine_choice_matches_reference_fallthrough(want, p_s, parts,
                                                           tmp_path):
    """The port decides the local engine from the geometry; it lands where
    the reference's fall-through lands (at 128-sample blocks: 8 partitions
    the head covers, 17 and 144 two stages cover, 150 and 320 three; p = 3
    divides no head)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual JAX devices")
    block = 128
    rounded = -(-parts // p_s) * p_s
    cfg = make_config(TS, str(tmp_path / "unused.wav"), block=block,
                      dtype="float32", sharded_local=want)
    sp = StreamProcessor(cfg, device="cpu",
                         mesh=M.make_mesh(1, p_s, devices=["cpu"] * p_s))
    sp.n_partitions = parts
    sp._impl = "sharded"
    fspec = sp._runtime_filter_spec
    assert fspec.n_partitions == rounded
    got = sp._sharded_local(fspec) or "complex"
    assert got == _reference_fallthrough(want, rounded, block, p_s)


def test_session_guards(cache, tmp_path, impulse_file):
    """A mesh of another device type, channels the mesh's c does not
    divide, an integer tail store on a non-uniform local engine; the
    self-check verdict is cached per mesh shape."""
    fname, _ = impulse_file
    cuda_mesh = M.Mesh(np.array([[torch.device("cuda", 0)]], dtype=object))
    with pytest.raises(ValueError, match="mesh devices are cuda"):
        StreamProcessor(make_config(TS, fname), cache, device="cpu",
                        mesh=cuda_mesh)
    sp = StreamProcessor(make_config(TS, fname), cache, device="cpu",
                         mesh=cpu_mesh(4, 2))
    with pytest.raises(ValueError, match="not divisible by mesh c"):
        sp.process(np.zeros((2, 256)))
    rng = np.random.default_rng(80)
    fname_long, _ = _long_impulse(tmp_path, rng)
    sp = StreamProcessor(
        make_config(TS, fname_long, block=128, dtype="float32",
                    sharded_local="nonuniform", nu_tail_store="int24"),
        cache, device="cpu", mesh=cpu_mesh())
    with pytest.raises(ValueError, match="integer tail storage"):
        sp.process(np.zeros((2, 128)))
    x = rng.standard_normal((2, 512))
    for mesh in (cpu_mesh(1, 8), cpu_mesh(2, 4), cpu_mesh(2, 4)):
        StreamProcessor(make_config(TS, fname), cache, device="cpu",
                        mesh=mesh).process(x)
    with open(cache.path("selfcheck-cache.json")) as f:
        assert len(json.load(f)) == 2  # one verdict per mesh shape
    assert os.path.exists(cache.path("selfcheck-cache.json"))
