"""The ``extended`` engine's CUDA graph (``kernels.extended.GraphStep``) on
a card: a session's stream, replayed one graph a block, against eager
``step_df`` on the same card, bit for bit, across the handoffs a stream
meets. Skips without a card. On the card the suite's ``conftest.py``
(which imports JAX) is left out: ``python -m pytest --noconftest
tests/test_torch_extended_cuda.py``."""

import numpy as np
import pytest
import torch

from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.kernels import extended as E
from bfir_tpu_torch.utils import profiling as P

C, N, TAPS = 2, 256, 2048  # 8 partitions
SELF_CHECK_BLOCKS = 3  # the build's known-answer check, replayed untraced


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step replays a CUDA graph there "
                    "alone")


def _config(path):
    return TS.EngineConfig(
        filter=TS.FilterSpec(block_length=N, n_partitions=1,
                             dtype="float64"),
        stream=TS.StreamSpec(n_channels=C, sample_rate=44100),
        chain=TS.ChainSpec(files=(
            TS.ImpulseFileSpec(enabled=True, filename=path),
            TS.ImpulseFileSpec(), TS.ImpulseFileSpec())),
        engine_mode="extended")


def _impulse(tmp_path, name, rng):
    h = rng.standard_normal((C, TAPS)) * np.exp(-np.arange(TAPS) / 500.0)
    path = str(tmp_path / name)
    wavio.write(path, (h * 0.05).T, 44100, subtype="float64")
    return path


def test_graph_replay_equals_eager_step_df(cuda_card, tmp_path):
    """200 blocks (calls of 64, 100 and 36: the in-flight drain), then 40
    after each of ``reset()``, a ``reconfigure`` (its crossfade block
    eager) and a cleared cuFFT plan cache, 20 with the cache full (the
    body eager), 20 after its limit is restored, then 20 through
    ``process_buffer``: the session's output equals eager ``step_df`` on
    the same card bit for bit. One capture for the geometry (the
    self-check's serves the stream, and the new filter is copied into the
    graph's plane), one more after the cache is cleared and after its
    limit changes; every other plain block is a replay."""
    rng = np.random.default_rng(41)
    paths = [_impulse(tmp_path, f"h{i}.wav", rng) for i in range(2)]
    x = rng.standard_normal((C, 400 * N)) * 0.1
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
    assert sp._impl == "extended" and isinstance(step, E.GraphStep)
    assert step.graphs.captures == 1
    coeffs = [sp._coeffs]
    marks = {"reset": pos}
    sp.reset()
    run(40)
    assert step.graphs.captures == 1
    marks["crossfade"] = pos
    sp.reconfigure(_config(paths[1]))
    run(40)
    coeffs.append(sp._coeffs)
    assert step.graphs.captures == 1
    cache = torch.backends.cuda.cufft_plan_cache[0]
    cache.clear()
    run(40)
    assert step.graphs.captures == 2
    limit = cache.max_size
    try:
        cache.max_size = cache.size  # full: the body runs eagerly
        run(20)
        assert step.graphs.captures == 2
    finally:
        cache.max_size = limit
    run(20)
    assert step.graphs.captures == 3
    run(20, sp.process_buffer)
    y = np.concatenate(got, axis=1)
    assert y.shape == (C, pos * N)

    state = E.init_df_state(sp._runtime_filter_spec, C, device="cuda")
    want = []
    for b in range(pos):
        blk = torch.from_numpy(x[:, b * N:(b + 1) * N]).to("cuda")
        if b == marks["reset"]:
            state = E.init_df_state(sp._runtime_filter_spec, C, device="cuda")
        if b == marks["crossfade"]:
            state, out = E.step_df_crossfade(state, *coeffs, blk)
        else:
            state, out = E.step_df(state, coeffs[b > marks["crossfade"]],
                                   blk)
        want.append(out.cpu().numpy())
    np.testing.assert_array_equal(y, np.concatenate(want, axis=1))

    traced = tr.counters["session.blocks"]  # process_buffer is untraced
    assert traced == pos - 20
    # neither the crossfade block nor the 20 with the cache full
    assert tr.counters["engine.graph_replays"] == traced - 21
    assert tr.counters["engine.graph_captures"] == 2
    assert step.graphs.replays == SELF_CHECK_BLOCKS + traced - 21 + 20
