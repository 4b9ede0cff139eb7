"""CUDA graphs of an engine's block step: the one mechanism of the port's
graph steps (``kernels.extended.GraphStep``, ``core.nonuniform.NuGraphStep``).

A step owns the buffers its body reads and writes; ``StepGraphs`` owns k
graphs of that body (one a ring slot fixed in it, or k = 1), captured into
one memory pool, and the coefficient plane they read: a tensor, or a named
tuple of tensors such as ``kernels.spectrum_mac.IntPlanes``. The plane is
cloned at capture; a plane object other than the last one passed (a
filter change) is copied into it, on the stream, with no capture; a plane
of another layout is captured anew.

The plan-cache rule: a graph's transforms point into cuFFT plans that the
device's plan cache holds (torch holds a plan nowhere else), so the graphs
are dropped, and captured again, when the cache has shrunk or changed its
size limit since the last block. The size and the limit are all that is
seen of the cache: a clear followed, before the next block, by as many new
plans as it held goes unseen. While the cache is full, where any new plan
may evict one of the graphs', the step runs eagerly. On a device that is
not CUDA nothing is captured and the step always runs eagerly.
"""

from __future__ import annotations

import torch


def map_planes(fn, x):
    """``fn`` over a plane's tensors (None fields stay None)."""
    if isinstance(x, tuple):
        return type(x)(*(None if t is None else fn(t) for t in x))
    return fn(x)


def layout(x):
    """What a copy of the plane ``x`` must match."""
    if isinstance(x, tuple):
        return tuple(None if t is None else (t.shape, t.dtype, t.device)
                     for t in x)
    return x.shape, x.dtype, x.device


def copy_planes(dst, src) -> None:
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            if d is not None:
                d.copy_(s)
    else:
        dst.copy_(src)


def plan_cache(device: torch.device):
    """The cuFFT plan cache of ``device``; None where it is not CUDA."""
    if device.type != "cuda":
        return None
    return torch.backends.cuda.cufft_plan_cache[device.index]


def capture(device: torch.device, k: int, body, warmup):
    """(graphs, outputs): ``body(i)`` for i in [0, k) captured as k graphs
    in one pool (their replays follow one another, and nothing one makes
    outlives it), and what each call returned. ``warmup()``, an eager run
    on copies of the buffers, first makes the cuFFT plans on the capture
    stream; the captures run nothing, so the buffers keep the stream."""
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    pool = torch.cuda.graph_pool_handle()
    graphs, outs = [], []
    with torch.cuda.device(device), torch.cuda.stream(stream):
        warmup()
        for i in range(k):
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outs.append(body(i))
            finally:
                graph.capture_end()
            graphs.append(graph)
    torch.cuda.current_stream(device).wait_stream(stream)
    return graphs, outs


class StepGraphs:
    """A step's graphs: ``body(i, plane)`` on the step's buffers, and
    ``warmup(plane)`` on copies of them. ``ready`` says whether a block
    replays, and counts 1 (a replay) or 0 in the tracer's ``counter`` on a
    CUDA device; ``captures`` and ``replays`` count graphs captured (also
    in ``engine.graph_captures``) and replayed."""

    def __init__(self, body, warmup, counter: str):
        self._body, self._warmup, self._counter = body, warmup, counter
        self.captures = self.replays = 0
        self.reset(torch.device("cpu"), 0)

    def reset(self, device: torch.device, k: int) -> None:
        """New buffers on ``device``, for k graphs: none captured yet."""
        self._device, self._k = device, k
        self._graphs = self._outs = None
        self._plane = None  # the coefficient plane the graphs read
        self._coeff = None  # the plane last copied into it
        self._cache = plan_cache(device)
        self._plans = None  # its (size, max_size) at the last look

    def ready(self, coeff, tr) -> bool:
        """Whether this block replays, ``coeff`` in the graphs' plane
        (captured first where there are no graphs for its layout). ``tr``:
        the tracer, or None."""
        if self._cache is None:
            return False
        size, limit = self._cache.size, self._cache.max_size
        if self._plans is not None and (size < self._plans[0]
                                        or limit != self._plans[1]):
            self._graphs = None  # plans the graphs point into may be gone
        self._plans = (size, limit)
        if tr is not None:
            tr.count(self._counter, int(size < limit))
        if size >= limit:
            self._graphs = self._outs = self._plane = self._coeff = None
            return False
        if self._graphs is None or layout(self._plane) != layout(coeff):
            self._graphs = self._outs = None
            plane = self._plane = map_planes(torch.clone, coeff)
            self._graphs, self._outs = capture(
                self._device, self._k, lambda i: self._body(i, plane),
                lambda: self._warmup(plane))
            self.captures += self._k
            if tr is not None:
                tr.count("engine.graph_captures", self._k)
            self._plans = (self._cache.size, self._cache.max_size)
        elif coeff is not self._coeff:
            copy_planes(self._plane, coeff)
        self._coeff = coeff
        return True

    def replay(self, i: int = 0):
        """Replay graph ``i``; returns what its body returned at capture,
        which the next replay overwrites."""
        self._graphs[i].replay()
        self.replays += 1
        return self._outs[i]
