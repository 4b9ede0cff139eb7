"""The engines' one CUDA-graph mechanism, ``utils.graphs``, on the CPU.

A stand-in cuFFT plan cache (an object with ``size`` and ``max_size``)
takes the place of the device's through ``graphs.plan_cache``, and a
stand-in capture through ``graphs.capture``: its "graphs" record nothing
and, replayed, run the body again on the step's buffers, so a step's
replayed stream is its eager stream bit for bit exactly where the
mechanism feeds the graph the right buffers and coefficient plane. The
cases hold the plan-cache rule (a shrunk cache or a changed limit drops the
graphs, a full cache says eager, a CPU device never captures), the
graph-owned coefficient plane (copied in for a new object, captured anew
for a new layout), and both graph steps (``kernels.extended.GraphStep``,
``core.nonuniform.NuGraphStep``) through it. On a card the real captures
are held to eager steps in ``tests/test_torch_extended_cuda.py`` and
``tests/test_torch_nonuniform_cuda.py``."""

import numpy as np
import pytest
import torch

from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.core.spec import FilterSpec
from bfir_tpu_torch.kernels import extended as E
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.utils import graphs as G
from bfir_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

CUDA = torch.device("cuda", 0)  # a device name only: nothing runs there


class FakeCache:
    def __init__(self, size=3, max_size=10):
        self.size, self.max_size = size, max_size


class FakeGraph:
    """A "captured" ``body(i)``: replayed, it runs the body again and puts
    what it returns where the capture's output stands."""

    def __init__(self, body, i, outs):
        self._body, self._i, self._outs = body, i, outs

    def replay(self):
        self._outs[self._i] = self._body(self._i)


def _fake_capture(device, k, body, warmup):
    warmup()
    outs = [None] * k
    return [FakeGraph(body, i, outs) for i in range(k)], outs


@pytest.fixture
def cache(monkeypatch):
    """A stand-in plan cache for every device, and the stand-in capture."""
    fake = FakeCache()
    monkeypatch.setattr(G, "plan_cache", lambda device: fake)
    monkeypatch.setattr(G, "capture", _fake_capture)
    return fake


def _graphs(k=2):
    """StepGraphs of a body that records (slot, plane) and returns the
    plane's sum; the plane is the graphs' own copy."""
    seen = []

    def body(i, plane):
        seen.append((i, plane))
        return plane.sum()

    g = G.StepGraphs(body, lambda plane: None, "test.replays")
    g.reset(CUDA, k)
    return g, seen


@pytest.mark.parametrize("event", ["shrunk", "limit", "full"])
def test_plan_cache_rule(cache, event):
    """Captured once for a geometry; a shrunk cache or a changed limit
    drops the graphs (captured again at once), a full cache says eager
    and drops them (captured again once there is room). Each look counts
    1 (replay) or 0 (eager) in the step's counter."""
    g, _ = _graphs()
    tr = P.Tracer()
    coeff = torch.ones(4)
    assert g.ready(coeff, tr) and g.captures == 2
    assert g.ready(coeff, tr) and g.captures == 2
    if event == "shrunk":
        cache.size = 1  # a clear: plans the graphs point into may be gone
        assert g.ready(coeff, tr) and g.captures == 4
    elif event == "limit":
        cache.max_size = 20
        assert g.ready(coeff, tr) and g.captures == 4
    else:
        cache.size = cache.max_size
        assert not g.ready(coeff, tr) and not g.ready(coeff, tr)
        assert g.captures == 2
        cache.size -= 1  # room again: the graphs were dropped
        assert g.ready(coeff, tr) and g.captures == 4
    assert g.ready(coeff, tr) and g.captures == 4  # nothing more changed
    assert tr.counters["engine.graph_captures"] == 4
    assert tr.counters["test.replays"] == 4  # the full cache's looks: 0
    assert g.replays == 0  # ready captures; replay replays


def test_cpu_device_never_captures(monkeypatch):
    def refuse(*args):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(G, "capture", refuse)
    g = G.StepGraphs(refuse, refuse, "test.replays")
    g.reset(torch.device("cpu"), 1)
    tr = P.Tracer()
    assert G.plan_cache(torch.device("cpu")) is None
    assert not g.ready(torch.ones(4), tr)
    # no replay counted either way: the CPU replays nothing
    assert g.captures == g.replays == 0 and not tr.counters


def test_coefficient_plane_is_the_graphs_own(cache):
    """A new plane object of the same layout is copied into the graphs'
    plane with no capture; a new layout is captured anew; a reset drops
    the graphs."""
    g, seen = _graphs(k=1)
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    assert g.ready(a, None) and g.captures == 1
    assert g.replay().item() == a.sum().item() and g.replays == 1
    plane = seen[-1][1]
    assert plane is not a and torch.equal(plane, a)
    assert g.ready(b, None) and g.captures == 1
    assert g.replay().item() == b.sum().item()
    assert seen[-1][1] is plane and torch.equal(plane, b)
    assert g.ready(torch.ones(6), None) and g.captures == 2
    assert g.replay().item() == 6.0
    g.reset(CUDA, 1)
    assert g.ready(torch.ones(6), None) and g.captures == 3


def test_int_planes_map_copy_and_layout():
    """A named tuple of tensors (``IntPlanes``, ``lo`` None at int16) is
    cloned, copied and compared field by field."""
    q = K.quantize_planes(torch.randn(2, 4, 8), 16)
    assert q.lo is None
    c = G.map_planes(torch.clone, q)
    assert isinstance(c, K.IntPlanes) and c.lo is None
    assert c.hi is not q.hi and torch.equal(c.hi, q.hi)
    assert G.layout(c) == G.layout(q)
    z = G.map_planes(torch.zeros_like, q)
    G.copy_planes(z, q)
    assert torch.equal(z.hi, q.hi) and torch.equal(z.scale, q.scale)
    assert G.layout(K.quantize_planes(torch.randn(2, 4, 8), 24)) != (
        G.layout(q))


def _cache_events(cache, b):
    """The stream's plan cache: cleared at block 20, full over 25-27. Three
    captures: the first block's, block 20's and block 28's."""
    if b == 20:
        cache.size = 0
    if b == 25:
        cache.size = cache.max_size
    if b == 28:
        cache.size = 2


def test_graph_step_replays_as_step_df(cache):
    """``GraphStep`` through the mechanism: replayed blocks, a filter
    change at block 10 (copied into the graph's plane), a cleared cache
    (a capture) and a full one (eager, then a capture) give ``step_df``'s
    stream bit for bit."""
    c, n, p = 2, 64, 8
    spec = FilterSpec(block_length=n, n_partitions=p, dtype="float64")
    rng = np.random.default_rng(3)
    planes = [E.df_coeffs(rng.standard_normal((c, n * p)) * 0.1, spec, c,
                          device="cpu") for _ in range(2)]
    x = torch.from_numpy(rng.standard_normal((32, c, n)))
    step, tr = E.GraphStep(), P.Tracer()
    sg, se = (E.init_df_state(spec, c, device="cpu") for _ in range(2))
    with tr.call("stream"):
        for b in range(32):
            _cache_events(cache, b)
            co = planes[b >= 10]
            sg, yg = step(sg, co, x[b])
            se, ye = E.step_df(se, co, x[b])
            assert torch.equal(yg, ye), b
    assert torch.equal(sg.ring, se.ring) and torch.equal(sg.prev, se.prev)
    assert step.graphs.captures == 3 and step.graphs.replays == 29
    assert tr.counters["engine.graph_replays"] == 29
    assert tr.counters["engine.graph_captures"] == 3


@pytest.mark.parametrize("head", ["float32", "int24"])
def test_nu_graph_step_replays_as_step_nu(cache, head):
    """``NuGraphStep`` through the mechanism, one graph a head ring slot,
    over the same events: ``step_nu``'s stream bit for bit."""
    c, n = 4, 16
    spec = NU.NuSpec(n, 8, 16, 30, "float32", "int24", head)
    rng = np.random.default_rng(4)
    co = [NU.nu_coeffs((rng.standard_normal((c, 4096)) * 0.01).astype(
        np.float32), spec, c, device="cpu") for _ in range(2)]
    x = torch.from_numpy((0.1 * rng.standard_normal((32, c, n))).astype(
        np.float32))
    step, tr = NU.NuGraphStep(), P.Tracer()
    a, b_ = (NU.init_nu_state(spec, c, device="cpu") for _ in range(2))
    with tr.call("stream"):
        for b in range(32):
            _cache_events(cache, b)
            coeffs = co[b >= 10]
            a, ya = step(a, coeffs, x[b])
            b_, yb = NU.step_nu(b_, coeffs, x[b])
            assert torch.equal(ya, yb), b
    assert torch.equal(a.pending, b_.pending)
    assert step.graphs.captures == 3 * 16 and step.graphs.replays == 29
    assert tr.counters["engine.head_replays"] == 29
    assert tr.counters["engine.graph_captures"] == 3 * 16
