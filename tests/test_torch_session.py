"""The slice end to end: bfir_tpu_torch ``StreamProcessor(device="cpu")``
against bfir_tpu's ``StreamProcessor`` and scipy on the same impulse WAV
and input, plus the port's guards.

Tolerance: float32 engines, 1e-5 x max|reference| against each other and
against the float64 scipy convolution."""

import ast
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from scipy import signal

from bfir_tpu.core import spec as JS
from bfir_tpu.engine.cache import ArtifactCache as JaxArtifactCache
from bfir_tpu.engine.session import StreamProcessor as JaxStreamProcessor
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends: XLA's CPU
    compiler has aborted xdist workers late in full runs once many
    executables had accumulated in one process (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


N = 256
TAPS = 6100  # head covers 16 x 256 = 4096 taps: the tail stage is engaged


def _close(got, ref, rel=1e-5):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _config(path, mode="nonuniform", spec=TS):
    """An EngineConfig of the port (``spec=TS``) or of the reference
    (``spec=JS``); tests that run both build each from the same kwargs."""
    return spec.EngineConfig(
        filter=spec.FilterSpec(block_length=N, dtype="float32"),
        stream=spec.StreamSpec(n_channels=2, sample_rate=44100),
        chain=spec.ChainSpec(files=(
            spec.ImpulseFileSpec(enabled=True, filename=path),
            spec.ImpulseFileSpec(), spec.ImpulseFileSpec())),
        engine_mode=mode)


def _impulse(tmp_path, name, rows, seed, taps=TAPS):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((rows, taps))
         * np.exp(-np.arange(taps) / 2000.0) * 0.05).astype(np.float32)
    path = str(tmp_path / name)
    wavio.write(path, h.T, 44100, subtype="float32")
    return path, np.broadcast_to(h.astype(np.float64), (2, taps))


def _scipy(x, h):
    return np.stack([signal.fftconvolve(x[c], h[c]) for c in range(2)])


@pytest.mark.parametrize("rows", [2, 1], ids=["per_channel", "mono_shared"])
def test_session_nonuniform_matches_reference(tmp_path, rows):
    path, h = _impulse(tmp_path, "h.wav", rows, 40 + rows)
    cfg = _config(path)
    jsp = JaxStreamProcessor(_config(path, spec=JS),
                             JaxArtifactCache(str(tmp_path / "jax")))
    tsp = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "torch")),
                          device="cpu")
    rng = np.random.default_rng(41)
    x = rng.standard_normal((2, 40 * N + 100)).astype(np.float32)
    # uneven chunks exercise the re-blocking
    yj = np.concatenate([jsp.process(x[:, a:b]) for a, b in
                         [(0, 1000), (1000, 1001), (1001, x.shape[1])]], 1)
    yt = np.concatenate([tsp.process(x[:, a:b]) for a, b in
                         [(0, 300), (300, 5000), (5000, x.shape[1])]], 1)
    assert tsp._impl == jsp._impl == "nonuniform"
    assert tsp._nuspec.tail_store == "float32"  # auto on the CPU
    assert tsp._coeffs.head.shape[1] == (2 if rows == 1 else 4)
    assert yt.shape == yj.shape == (2, 40 * N)
    _close(yt, yj)
    _close(yt, _scipy(x, h)[:, :yt.shape[1]])

    # live reconfigure: the head ramps in-block, the tail bridges at its
    # next fire; the stream converges to the new filter
    path2, h2 = _impulse(tmp_path, "h2.wav", rows, 50 + rows)
    jsp.reconfigure(_config(path2, spec=JS))
    tsp.reconfigure(_config(path2))
    assert tsp._pending_swap is not None
    x2 = rng.standard_normal((2, 60 * N)).astype(np.float32)
    yj2, yt2 = jsp.process(x2), tsp.process(x2)
    assert tsp._nu_old is None, "transition must have completed"
    _close(yt2, yj2)
    nu = tsp._nuspec
    settle = (nu.ratio * (nu.delay_blocks + 2) + nu.p_head) * N
    full = np.concatenate([x[:, :yt.shape[1] + 100], x2], axis=1)
    ref2 = _scipy(full, h2)[:, yt.shape[1]:yt.shape[1] + yt2.shape[1]]
    _close(yt2[:, settle:], ref2[:, settle:])

    # bulk path: process_buffer agrees with the reference's and with scipy
    x3 = rng.standard_normal((2, 16 * N)).astype(np.float32)
    yj3, yt3 = jsp.process_buffer(x3), tsp.process_buffer(x3)
    _close(yt3, yj3)
    full = np.concatenate([full, x3], axis=1)
    t0 = yt.shape[1] + yt2.shape[1]
    _close(yt3, _scipy(full, h2)[:, t0:t0 + yt3.shape[1]])
    stats = tsp.overflow_stats()
    assert stats.largest.shape == (2,) and stats.largest.max() > 0


def test_session_short_filter_takes_hc(tmp_path):
    """A filter the head alone covers takes the halfcomplex engine, decided
    from the geometry before anything is built."""
    path, h = _impulse(tmp_path, "hs.wav", 2, 60, taps=900)
    sp = StreamProcessor(_config(path), ArtifactCache(str(tmp_path / "c")),
                         device="cpu")
    x = np.random.default_rng(61).standard_normal((2, 8 * N)).astype(np.float32)
    y = sp.process(x)
    assert sp._impl == "hc"
    _close(y, _scipy(x, h)[:, :y.shape[1]])
    auto = StreamProcessor(_config(path, mode="auto"),
                           ArtifactCache(str(tmp_path / "c")), device="cpu")
    _close(auto.process(x), y)
    assert auto._impl == "complex"  # auto on the CPU, as the reference


def test_session_guards(tmp_path):
    cfg = _config(str(tmp_path / "missing.wav"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamProcessor(cfg, device="cuda")
    # every mode is ported: "sharded" takes a mesh of the session's device
    # type (parallel.mesh; tests/test_torch_session_sharded.py runs it)
    cuda_mesh = M.Mesh(np.array([[torch.device("cuda", 0)]], dtype=object))
    with pytest.raises(ValueError, match="mesh devices are cuda"):
        StreamProcessor(dataclasses.replace(cfg, engine_mode="sharded"),
                        device="cpu", mesh=cuda_mesh)
    # the three-stage engine builds (two stages cover 16 x 256 + 16 x 2048)
    path, _ = _impulse(tmp_path, "h3.wav", 2, 70, taps=37000)
    sp3 = StreamProcessor(_config(path, mode="nonuniform3"),
                          ArtifactCache(str(tmp_path / "c3")), device="cpu")
    sp3.process(np.zeros((2, N), np.float32))
    assert sp3._impl == "nonuniform3"
    # a missing impulse file passes the stream through (reference parity)
    sp = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "c")), device="cpu")
    x = np.ones((2, 3 * N), np.float32)
    np.testing.assert_array_equal(sp.process(x), x)
    np.testing.assert_array_equal(sp.render(x), x)  # render passes through too


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    """Importing every bfir_tpu_torch module, and loading and calling the
    native codec, leaves jax and every module of bfir_tpu out of the
    process."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bfir_tpu_torch\n"
        "for m in pkgutil.walk_packages(bfir_tpu_torch.__path__, 'bfir_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import bfir_tpu_torch.engine.session, bfir_tpu_torch.convert\n"
        "from bfir_tpu_torch import native\n"
        "from bfir_tpu_torch.core.spec import SampleFormat\n"
        "assert native.decode_f64(b'\\0' * 6, SampleFormat.S24_LE, 2).shape"
        " == (2, 1)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'bfir_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def _imported_roots(path):
    """Top-level package of every import statement in a source file,
    including imports inside functions."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_neither_jax_nor_bfir_tpu():
    """No file of bfir_tpu_torch, and not chip_smoke.py, names jax or
    bfir_tpu in an import, even one that runs only on some path."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "bfir_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    assert os.path.join(ROOT, "bfir_tpu_torch", "native", "__init__.py") in files
    bad = [(os.path.relpath(f, ROOT), root) for f in files
           for root in _imported_roots(f)
           if root in ("jax", "jaxlib", "bfir_tpu")]
    assert not bad, bad


def test_native_codec_includes_only_the_standard_library():
    """codec.cpp, which g++ builds alone, includes nothing but C++ standard
    headers and files of its own directory: nothing of bfir_tpu/native."""
    native_dir = os.path.join(ROOT, "bfir_tpu_torch", "native")
    with open(os.path.join(native_dir, "codec.cpp")) as f:
        includes = re.findall(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]',
                              f.read(), flags=re.M)
    assert includes
    for kind, name in includes:
        if kind == "<":
            assert name in _CXX_STANDARD_HEADERS, name
        else:
            assert "/" not in name and os.path.exists(
                os.path.join(native_dir, name)), name


_CXX_STANDARD_HEADERS = {
    "algorithm", "array", "atomic", "cassert", "cerrno", "cfloat",
    "climits", "cmath", "cstddef", "cstdint", "cstdio", "cstdlib",
    "cstring", "limits", "memory", "new", "type_traits", "utility",
    "vector"}
