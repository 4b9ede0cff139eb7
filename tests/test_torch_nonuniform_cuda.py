"""The two-stage engine's head graphs (``core.nonuniform.NuGraphStep``) on a
card: a session's stream, whose head steps replay one CUDA graph a head
ring slot, against eager ``step_nu`` on the same card, bit for bit, across
the slot wrap and the handoffs a stream meets. Skips without a card. On
the card the suite's ``conftest.py`` (which imports JAX) is left out:
``python -m pytest --noconftest tests/test_torch_nonuniform_cuda.py``."""

import numpy as np
import pytest
import torch

from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.utils import profiling as P

# the cinema cell's stages at 8 channels: a float32 head of 16 x 128 and an
# int24 tail of 30 x 1024 (K1 every block, K3 and K4 every 8th)
C, N, TAPS = 8, 128, 16 * 128 + 30 * 1024
# the build's known-answer check: (D + 2) x R blocks, replayed untraced
SELF_CHECK_BLOCKS = (2 + 2) * 8


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the head replays CUDA graphs there "
                    "alone")


def _config(path, head_store="float32"):
    return TS.EngineConfig(
        filter=TS.FilterSpec(block_length=N, dtype="float32"),
        stream=TS.StreamSpec(n_channels=C, sample_rate=48000),
        chain=TS.ChainSpec(files=(
            TS.ImpulseFileSpec(enabled=True, filename=path),
            TS.ImpulseFileSpec(), TS.ImpulseFileSpec())),
        engine_mode="nonuniform", nu_tail_store="int24",
        nu_head_store=head_store)


def _impulse(tmp_path, name, rng):
    h = rng.standard_normal((C, TAPS)) * np.exp(-np.arange(TAPS) / 4096.0)
    h = 0.5 * h / np.linalg.norm(h, axis=1, keepdims=True)
    path = str(tmp_path / name)
    wavio.write(path, h.astype(np.float32).T, 48000, subtype="float32")
    return path


def _eager(sp, x, blocks, marks, coeffs):
    """The session's stream stepped eagerly on the card: ``step_nu``, a
    fresh state at ``marks["reset"]``, and from ``marks["crossfade"]`` the
    two-stage change (the head's ramp, then held blocks through the
    bridging fire). Returns (outputs, blocks the crossfade stepped)."""
    ratio = sp._nuspec.ratio
    state = NU.init_nu_state(sp._nuspec, C, device="cuda")
    old, want, special = None, [], 0
    for b in range(blocks):
        blk = torch.from_numpy(x[:, b * N:(b + 1) * N]).to("cuda")
        if b == marks.get("reset"):
            state = NU.init_nu_state(sp._nuspec, C, device="cuda")
        fired = NU._phase(state, blk) == ratio - 1
        if b == marks.get("crossfade"):
            state, out = NU.step_nu_crossfade(state, coeffs[0], coeffs[1],
                                              blk, head_ramp=True)
            old = None if fired else coeffs[0]
            special += 1
        elif old is not None:
            state, out = NU.step_nu_crossfade(state, old, coeffs[1], blk,
                                              head_ramp=False)
            old = None if fired else old
            special += 1
        else:
            co = coeffs[b >= marks.get("crossfade", blocks)]
            state, out = NU.step_nu(state, co, blk)
        want.append(out.cpu().numpy())
    return np.concatenate(want, axis=1), special


def test_head_replay_equals_eager_step_nu(cuda_card, tmp_path):
    """200 blocks (calls of 64, 100 and 36: 12 turns of the head ring and
    the in-flight drain), 16 more, then 40 after each of ``reset()``, a
    ``reconfigure`` (its ramp and held blocks eager) and a cleared cuFFT
    plan cache, 20 with the cache full (the head eager), 20 after its
    limit is restored, 20 through ``process_buffer`` (``step_nu``) and 20
    after it: the session's output equals eager ``step_nu`` on the same
    card bit for bit. One capture a head ring slot serves the geometry
    (the self-check's; the new filter is copied into the graphs' plane),
    p_head more after the cache is cleared and after its limit changes;
    every other plain block is a replay, and a replayed K1 is no launch."""
    rng = np.random.default_rng(24)
    paths = [_impulse(tmp_path, f"h{i}.wav", rng) for i in range(2)]
    x = (rng.standard_normal((C, 460 * N)) * 0.1).astype(np.float32)
    sp = StreamProcessor(_config(paths[0]), ArtifactCache(str(tmp_path / "c")),
                         device="cuda")
    tr = P.Tracer()
    sp.tracer = tr
    got, pos = [], 0

    def run(blocks, call=sp.process):
        nonlocal pos
        got.append(call(x[:, pos * N:(pos + blocks) * N]))
        pos += blocks

    for blocks in (64, 100, 36):
        run(blocks)
    step = sp._step
    p_head = sp._nuspec.p_head
    assert sp._impl == "nonuniform" and isinstance(step, NU.NuGraphStep)
    assert p_head == 16 and step.graphs.captures == p_head
    launches = K.mac_hc.launches
    run(16)
    assert K.mac_hc.launches == launches  # 16 heads, all replayed
    coeffs = [sp._coeffs]
    marks = {"reset": pos}
    sp.reset()
    run(40)
    assert step.graphs.captures == p_head
    marks["crossfade"] = pos
    sp.reconfigure(_config(paths[1]))
    run(40)
    coeffs.append(sp._coeffs)
    assert coeffs[1] is not coeffs[0] and step.graphs.captures == p_head
    cache = torch.backends.cuda.cufft_plan_cache[0]
    cache.clear()
    run(40)
    assert step.graphs.captures == 2 * p_head
    limit = cache.max_size
    try:
        cache.max_size = cache.size  # full: the head runs eagerly
        run(20)
        assert step.graphs.captures == 2 * p_head
    finally:
        cache.max_size = limit
    run(20)
    assert step.graphs.captures == 3 * p_head
    run(20, sp.process_buffer)
    run(20)
    y = np.concatenate(got, axis=1)
    assert y.shape == (C, pos * N)

    want, special = _eager(sp, x, pos, marks, coeffs)
    np.testing.assert_array_equal(y, want)

    traced = tr.counters["session.blocks"]  # process_buffer is untraced
    assert traced == pos - 20
    # neither the crossfade's blocks nor the 20 with the cache full
    assert tr.counters["engine.head_replays"] == traced - special - 20
    assert tr.counters["engine.graph_captures"] == 2 * p_head
    assert step.graphs.replays == SELF_CHECK_BLOCKS + traced - special - 20


def test_int24_head_replay_equals_eager_step_nu(cuda_card, tmp_path):
    """An int24 head (``nu_head_store``: the quantizing insert and K3 in
    the graph) over 3 turns of its ring and a ``reset()``: bit for bit
    against eager ``step_nu``."""
    rng = np.random.default_rng(25)
    path = _impulse(tmp_path, "h.wav", rng)
    x = (rng.standard_normal((C, 80 * N)) * 0.1).astype(np.float32)
    sp = StreamProcessor(_config(path, "int24"),
                         ArtifactCache(str(tmp_path / "c")), device="cuda")
    tr = P.Tracer()
    sp.tracer = tr
    y = [sp.process(x[:, :50 * N])]
    assert isinstance(sp._coeffs.head, K.IntPlanes)
    sp.reset()
    y.append(sp.process(x[:, 50 * N:]))
    want, _ = _eager(sp, x, 80, {"reset": 50}, [sp._coeffs])
    np.testing.assert_array_equal(np.concatenate(y, axis=1), want)
    assert tr.counters["engine.head_replays"] == 80
    assert sp._step.graphs.captures == 16
