"""The program's own spans and block counter in a traced run, reduced to
host time a block by layer and the device's idle time under the spans.

The program records into a ``Tracer`` set on its session
(``StreamProcessor.tracer``, ``bfir_tpu_torch.utils.profiling``):
``session.process`` a call, ``session.to_device``, ``engine.step`` (and
the engine's phases inside it), ``session.fetch``, ``session.guard`` and
``session.overflow`` inside the call, and the ``session.blocks`` counter.
In a run whose device the harness traced (``run.trace``: a run on a card),
two more slices of the cell's traffic run through its driver (``traced``)
with a tracer of their own on the session, which then gets its tracer
back:

- the host slice, with no profiler: each ``session.process`` span is cut
  into disjoint pieces by the innermost span open in each (``segments``),
  and each piece goes to a layer: engine host under an ``engine.step``,
  fetch under a ``session.fetch``, session host elsewhere in the call
  (``host_split``). Each is summed and divided by ``session.blocks``. The
  harness's own clock times the same calls (its ``process`` span hook);
- the idle slice, under a profiler of the device's activity alone with
  ``devtrace``'s opening and closing markers, taken again until whole: the
  spans are mapped onto the profiler's clock with the tracer's anchor, and
  the time no kernel, copy or memset ran is put down to the innermost span
  the host was in then (``idle_under``).

Without a card there is no idle slice, and a program without a tracer
reads nothing. Each span name's self time and each innermost span's idle
time a block go to standard error.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from portbench import devtrace
from portbench.catalog import Catalog

STATE = "progtrace"
LAYERS = {"engine.step": "engine", "session.fetch": "fetch"}


def log(msg: str) -> None:
    print(f"progtrace: {msg}", file=sys.stderr, flush=True)


def read(run, key: str) -> Optional[float]:
    """One reading of the run (ms a block): ``session_host_ms``,
    ``engine_host_ms``, ``fetch_ms`` or ``engine_idle_ms``; None where it
    was not read. The slices run once a run."""
    if STATE not in run.state:
        run.state[STATE] = _readings(run)
    return (run.state[STATE] or {}).get(key)


def segments(spans) -> List[Tuple[int, int, int]]:
    """Disjoint ``(start, end, i)`` pieces of the root spans' time, each
    under span ``i``, the innermost span open then. ``spans``: records with
    ``start_ns``, ``end_ns`` and ``parent`` (the index of the enclosing
    span, -1 at a root), nested, each after its parent and its earlier
    siblings."""
    children = defaultdict(list)
    for i, s in enumerate(spans):
        children[s.parent].append(i)
    out = []

    def walk(i):
        t = spans[i].start_ns
        for j in children[i]:
            if spans[j].start_ns > t:
                out.append((t, spans[j].start_ns, i))
            walk(j)
            t = spans[j].end_ns
        if spans[i].end_ns > t:
            out.append((t, spans[i].end_ns, i))

    for root in children[-1]:
        walk(root)
    return out


def layer_of(spans) -> List[str]:
    """Each span's layer: ``engine`` or ``fetch`` where it or an enclosing
    span is an ``engine.step`` or a ``session.fetch``, else ``session``."""
    out: List[str] = []
    for s in spans:
        out.append(LAYERS.get(s.name) or (out[s.parent] if s.parent >= 0
                                          else "session"))
    return out


def host_split(spans) -> Dict[str, int]:
    """Nanoseconds of the calls' host time by layer (``session``,
    ``engine``, ``fetch``) and the calls' whole time (``process``)."""
    layer = layer_of(spans)
    out = dict.fromkeys(("session", "engine", "fetch"), 0)
    for a, b, i in segments(spans):
        out[layer[i]] += b - a
    out["process"] = sum(s.end_ns - s.start_ns for s in spans
                         if s.parent < 0)
    return out


def self_ns(spans) -> Dict[str, int]:
    """Each span name's self time: its spans' time less their children's."""
    out: Dict[str, int] = defaultdict(int)
    for a, b, i in segments(spans):
        out[spans[i].name] += b - a
    return out


def idle_under(busy: Sequence[Tuple[int, int]], segs) -> Dict[object, int]:
    """The time of each label's pieces in which the device ran nothing.
    ``busy``: the device's merged busy intervals, sorted; ``segs``: sorted
    disjoint ``(start, end, label)`` pieces on the same clock."""
    out: Dict[object, int] = defaultdict(int)
    j = 0
    for a, b, label in segs:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        out[label] += (b - a) - covered
    return out


def _slice(run, driver, tracer) -> List[int]:
    """One ``traced`` slice of the driver with ``tracer`` on the session;
    returns the harness's clock of each call into the program (ns)."""
    calls: List[int] = []

    @contextlib.contextmanager
    def timed(name):
        t0 = time.perf_counter_ns()
        yield
        if name == "process":
            calls.append(time.perf_counter_ns() - t0)

    sp = run.sp
    prior = sp.tracer
    sp.tracer = tracer
    run.span = timed  # the driver's span hook around each call, timed
    try:
        driver.traced(run)
    finally:
        del run.span
        sp.tracer = prior
    return calls


def _idle_slice(run, driver, tracer_cls):
    """(tracer, merged busy intervals in Unix ns) of a whole device-only
    trace of one slice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(devtrace.TRIES):
        tracer = tracer_cls()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(devtrace.LEAD_CYCLES)
            for _ in range(8):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            _slice(run, driver, tracer)
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda._sleep(devtrace.LEAD_CYCLES)
            torch.cuda.synchronize()
        events = [(e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        spins = [(a, b) for a, b, name in events if "spin_kernel" in name]
        work = [(a, b) for a, b, name in events if "spin_kernel" not in name
                and not name.startswith(devtrace.SPAN)]
        if work and any(b <= min(w[0] for w in work) for _, b in spins) \
                and any(a >= max(w[1] for w in work) for a, _ in spins):
            return tracer, devtrace._merge(work)
        log(f"idle slice's trace of {len(work)} device events not whole; "
            "tracing again")
    raise RuntimeError(f"no whole trace in {devtrace.TRIES} tries")


def _per_block(ns: float, blocks: int) -> float:
    return ns / 1e6 / blocks


def _readings(run) -> Optional[dict]:
    if run.trace is None or not hasattr(run.sp, "tracer"):
        return None
    try:
        from bfir_tpu_torch.utils.profiling import Tracer
    except ImportError:
        return None
    driver = Catalog().driver(run.traffic["loop"])
    tracer = Tracer()
    calls = _slice(run, driver, tracer)
    spans = tracer.spans
    blocks = tracer.counters.get("session.blocks", 0)
    if not blocks or tracer.dropped:
        log(f"host slice: {blocks} blocks, {tracer.dropped} spans dropped; "
            "nothing read")
        return None
    split = host_split(spans)
    parts = split["session"] + split["engine"] + split["fetch"]
    out = {"session_host_ms": _per_block(split["session"], blocks),
           "engine_host_ms": _per_block(split["engine"], blocks),
           "fetch_ms": _per_block(split["fetch"], blocks)}
    n_calls = tracer.calls
    harness_ms = statistics.fmean(calls) / 1e6 if calls else float("nan")
    process_ms = split["process"] / 1e6 / n_calls
    log(f"host slice, {blocks} blocks in {n_calls} calls: session.process "
        f"{_per_block(split['process'], blocks)!r} ms a block = session "
        f"host {out['session_host_ms']!r} + engine host "
        f"{out['engine_host_ms']!r} + fetch {out['fetch_ms']!r} (parts "
        f"less the whole: {parts - split['process']} ns); session.process "
        f"{process_ms!r} ms a call, the harness's clock of the same calls "
        f"{harness_ms!r} ms (ratio {process_ms / harness_ms!r})")
    if run.window is not None and run.window.service_s:
        log("the window's calls (tracing off), mean of their own time: "
            f"{statistics.fmean(run.window.service_s) * 1e3!r} ms")
    log("self time a block (ms): " + ", ".join(
        f"{k} {_per_block(v, blocks):.5f}" for k, v in sorted(
            self_ns(spans).items(), key=lambda kv: -kv[1])))
    if run.device.type != "cuda":
        return out
    tracer, busy = _idle_slice(run, driver, Tracer)
    spans = tracer.spans
    blocks = tracer.counters.get("session.blocks", 0)
    layer = layer_of(spans)
    segs = [(tracer.to_unix_ns(a), tracer.to_unix_ns(b), i)
            for a, b, i in segments(spans)]
    idle = idle_under(busy, segs)
    by_name: Dict[str, int] = defaultdict(int)
    by_layer: Dict[str, int] = defaultdict(int)
    for i, t in idle.items():
        by_name[spans[i].name] += t
        by_layer[layer[i]] += t
    out["engine_idle_ms"] = _per_block(by_layer["engine"], blocks)
    log(f"idle slice, {blocks} blocks in {tracer.calls} calls; device idle "
        "a block (ms) by layer: " + ", ".join(
            f"{k} {_per_block(v, blocks)!r}" for k, v in sorted(
                by_layer.items())) + "; under each innermost span: "
        + ", ".join(f"{k} {_per_block(v, blocks):.5f}" for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])))
    return out
