"""The session's two-stage step, ``core.nonuniform.NuGraphStep``, on the
CPU: its head step runs on buffers of its own (on a card from one CUDA
graph a head ring slot; here eagerly), and its outputs and states equal
``step_nu``'s bit for bit across the handoffs a stream meets. The
geometry is the cinema cell's at a small size: 4 ch x 4096 taps at N = 16,
a 16-partition head and a 30-partition tail of 8N."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from bfir_tpu_torch import convert
from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

N, C, TAPS, RATE = 16, 4, 4096, 48000
BLOCKS = 3 * 16 + 5  # three turns of the head ring and a few blocks more
AT = 21  # the handoff block: mid-cycle, head ring slot 5


def _impulse(seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((C, TAPS)) * np.exp(-np.arange(TAPS) / 512.0)
    return (0.5 * h / np.linalg.norm(h, axis=1, keepdims=True)).astype(
        np.float32)


def _tensors(x):
    """Every tensor of a (nested) state, in order."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, tuple):
        return [t for part in x for t in _tensors(part)]
    return []


def _assert_states_equal(a, b):
    assert a.head.blockcounter == b.head.blockcounter
    assert a.tail.blockcounter == b.tail.blockcounter
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for u, v in zip(ta, tb):
        assert u.dtype == v.dtype and torch.equal(u, v)


def _xfade_blocks(state, coeffs_old, coeffs_new, block, first):
    """``step_nu_crossfade`` as the session runs it: the ramp on the
    change block, then hold blocks through the bridging fire."""
    return NU.step_nu_crossfade(state, coeffs_old, coeffs_new, block,
                                head_ramp=first)


def _fires(state, block):
    return NU._phase(state, block) == state.inbuf.shape[-1] // N - 1


@pytest.mark.parametrize("tail,head", [("int24", "float32"),
                                       ("float32", "float32"),
                                       ("int24", "int24")])
@pytest.mark.parametrize("handoff", ["fresh", "reset", "crossfade",
                                     "convert"])
def test_graph_step_equals_step_nu(tail, head, handoff):
    spec = NU.NuSpec(N, 8, 16, 30, "float32", tail, head)
    co = [NU.nu_coeffs(_impulse(s), spec, C, device="cpu") for s in (1, 2)]
    x = torch.from_numpy((0.1 * np.random.default_rng(5).standard_normal(
        (BLOCKS, C, N))).astype(np.float32))
    step = NU.NuGraphStep()
    a = NU.init_nu_state(spec, C, device="cpu")
    b = NU.init_nu_state(spec, C, device="cpu")
    coeffs, xfade = co[0], None  # xfade: the old coefficients until the fire
    for k in range(BLOCKS):
        blk = x[k]
        if k == AT and handoff == "reset":
            a = NU.init_nu_state(spec, C, device="cpu")
            b = NU.init_nu_state(spec, C, device="cpu")
        if k == AT and handoff == "convert":
            a = convert.nu_state_from_numpy(convert.nu_state_to_numpy(a),
                                            "cpu")
            b = convert.nu_state_from_numpy(convert.nu_state_to_numpy(b),
                                            "cpu")
        if k == AT and handoff == "crossfade":
            xfade, coeffs = coeffs, co[1]
        if xfade is not None:
            fired = _fires(a, blk)
            a, ya = _xfade_blocks(a, xfade, coeffs, blk, k == AT)
            b, yb = _xfade_blocks(b, xfade, coeffs, blk, k == AT)
            # the crossfade wrote its ring slot into the step's own ring
            assert a.head.ring is step._ring
            xfade = None if fired else xfade
        else:
            a, ya = step(a, coeffs, blk)
            b, yb = NU.step_nu(b, coeffs, blk)
        assert torch.equal(ya, yb), k
        _assert_states_equal(a, b)
    # the CPU steps eagerly
    assert step.graphs.captures == step.graphs.replays == 0
    # the state the step hands back holds its own buffers
    assert a.head.ring is step._ring and a.head.prev_block is step._prev


def test_a_changed_geometry_takes_new_buffers():
    step = NU.NuGraphStep()
    blk = torch.zeros((C, N))
    small = NU.NuSpec(N, 8, 16, 30)
    wide = NU.NuSpec(2 * N, 8, 16, 30)
    st, _ = step(NU.init_nu_state(small, C, device="cpu"),
                 NU.nu_coeffs(_impulse(1), small, C, device="cpu"), blk)
    ring = step._ring
    co = NU.nu_coeffs(_impulse(1), wide, C, device="cpu")
    b = NU.init_nu_state(wide, C, device="cpu")
    st, y = step(NU.init_nu_state(wide, C, device="cpu"), co,
                 torch.ones((C, 2 * N)))
    b, want = NU.step_nu(b, co, torch.ones((C, 2 * N)))
    assert step._ring is not ring and step._ring.shape == b.head.ring.shape
    assert torch.equal(y, want)
    _assert_states_equal(st, b)


def _config(path, **kw):
    return TS.EngineConfig(
        filter=TS.FilterSpec(N, dtype="float32"),
        stream=TS.StreamSpec(n_channels=C, sample_rate=RATE),
        chain=TS.ChainSpec(files=(
            TS.ImpulseFileSpec(enabled=True, filename=path),
            TS.ImpulseFileSpec(), TS.ImpulseFileSpec())),
        engine_mode="nonuniform", nu_tail_store="int24", **kw)


def _session(tmp_path, path, name):
    return StreamProcessor(_config(path),
                           ArtifactCache(str(tmp_path / name)), device="cpu")


def test_session_steps_through_the_graph_step(tmp_path):
    """A session's ``nonuniform`` step is a ``NuGraphStep``; its stream
    (one-block and uneven calls, a ``reset()``, a live ``reconfigure``
    and a ``process_buffer``) equals, bit for bit, the same session with
    ``step_nu`` as its step. No option selects the graph: the step takes
    no argument and the configuration has no field for it."""
    paths = []
    for i in (1, 2):
        paths.append(str(tmp_path / f"h{i}.wav"))
        wavio.write(paths[-1], _impulse(i).T, RATE, subtype="float32")
    x = (0.1 * np.random.default_rng(9).standard_normal(
        (C, 200 * N))).astype(np.float32)
    outs = []
    for eager in (False, True):
        sp = _session(tmp_path, paths[0], f"c{eager}")
        sp.process(x[:, :0], RATE)  # builds the engine
        assert sp._impl == "nonuniform"
        assert isinstance(sp._step, NU.NuGraphStep)
        if eager:
            sp._step = NU.step_nu
        tr = P.Tracer()
        sp.tracer = tr
        got, t = [], 0
        for k in (N, N, 5 * N + 3, 37, 30 * N, 7):
            got.append(sp.process(x[:, t:t + k], RATE))
            t += k
        sp.reset()
        for k in (N, 20 * N):
            got.append(sp.process(x[:, t:t + k], RATE))
            t += k
        sp.reconfigure(_config(paths[1]))
        for k in (N, 3 * N, 40 * N):
            got.append(sp.process(x[:, t:t + k], RATE))
            t += k
        got.append(sp.process_buffer(x[:, t:t + 24 * N], RATE))
        t += 24 * N
        got.append(sp.process(x[:, t:], RATE))
        outs.append(np.concatenate(got, axis=1))
        # the CPU replays nothing, so it counts no replays
        assert "engine.head_replays" not in tr.counters
        assert "engine.graph_captures" not in tr.counters
    # reset() drops the 15 frames held then, and 1 frame is held at the end
    assert outs[0].shape == (C, x.shape[1] - 16)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not inspect.signature(NU.NuGraphStep).parameters
    names = [f.name for f in dataclasses.fields(TS.EngineConfig)]
    assert not [n for n in names if "graph" in n or "replay" in n]


def test_int_head_ring_is_taken_up_by_copy():
    # a restored int24 head (new tensors) is copied field by field
    spec = NU.NuSpec(N, 8, 16, 30, "float32", "int24", "int24")
    co = NU.nu_coeffs(_impulse(3), spec, C, device="cpu")
    x = torch.from_numpy((0.1 * np.random.default_rng(4).standard_normal(
        (20, C, N))).astype(np.float32))
    step = NU.NuGraphStep()
    a = NU.init_nu_state(spec, C, device="cpu")
    for k in range(10):
        a, _ = step(a, co, x[k])
    snap = convert.nu_state_to_numpy(a)
    b = convert.nu_state_from_numpy(snap, "cpu")
    r = convert.nu_state_from_numpy(snap, "cpu")
    assert isinstance(b.head.ring, K.IntPlanes)
    assert b.head.ring.hi is not step._ring.hi
    for k in range(10, 20):
        b, y = step(b, co, x[k])
        r, want = NU.step_nu(r, co, x[k])
        assert torch.equal(y, want)
    _assert_states_equal(b, r)
