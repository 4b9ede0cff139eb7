"""A traced slice of the traffic, reduced to counts, times and a breakdown.

``traced`` is the smoke test's ``_traced``, copied: on the H100 the
profiler now and then loses device events at a trace's ends, so the trace
opens with a spin of about 25 ms and eight marker spins and closes with a
marker and a second spin; it is whole when a marker ends before the first
device event of the slice and one starts after the last. ``trace_slice``
takes a slice again until its trace is whole.

A slice traced with the device's activity alone gives the counts, the
device time and the busy and idle shares. Recording every host op as well
slows the host about 1.5-2 x on these paths, so only a second slice
records them: with the harness's own host spans (``span``:
``portbench.<name>`` ranges around each call into the program and around
the open loop's wait) it puts each idle gap of the device down to what the
host was doing then.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, List, Tuple

LEAD_CYCLES = 50_000_000  # a spin of about 25 ms at the H100's clocks
TRIES = 5  # slices traced at most before the run gives up
SPAN = "portbench."
TOP = 10  # entries of each breakdown list
NAME_CHARS = 96


def span(name: str):
    """The harness's host span ``portbench.<name>`` (a profiler range)."""
    from torch.profiler import record_function

    return record_function(SPAN + name)


@dataclass
class TraceSummary:
    blocks: int  # N-frame blocks the slice processed
    window_s: float  # host wall of the slice
    kernels: int
    copies: int  # memcpy and memset
    device_s: float  # summed durations of the device work
    kernel_s: float  # summed durations of the kernels (no memcpy, memset)
    busy_s: float  # time some device work ran (union)
    host_copy_s: float  # host <-> device memcpy durations
    device_ops: List[list]  # [[name, seconds]] the largest, by name
    idle_gaps: List[list]  # [[host activity, seconds]] the largest

    @property
    def launches(self) -> int:
        return self.kernels + self.copies


def _is_spin(e) -> bool:
    return "spin_kernel" in e.name


def traced(run: Callable[[], int], host_ops: bool = False):
    """(run(), its wall seconds, its device events, the host events (none
    unless ``host_ops``), whether the trace is whole), from one
    torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    with profile(activities=acts) as prof:
        torch.cuda._sleep(LEAD_CYCLES)
        for _ in range(8):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1)
        torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    spins = [e.time_range for e in dev if _is_spin(e)]
    # the profiler mirrors host ranges onto the device timeline; they are
    # not device work
    work = [e for e in dev if not _is_spin(e) and not e.name.startswith(SPAN)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    opened = bool(work) and any(
        t.end <= min(e.time_range.start for e in work) for t in spins)
    closed = bool(work) and any(
        t.start >= max(e.time_range.end for e in work) for t in spins)
    if work and not (opened and closed):
        print(f"trace of {len(work)} device events lacks its "
              + " and ".join(w for w, ok in (("opening", opened),
                                             ("closing", closed)) if not ok)
              + " marker", file=sys.stderr)
    return y, wall, work, host, opened and closed


def trace_slice(run: Callable[[], int], host_ops: bool = False,
                tries: int = TRIES) -> TraceSummary:
    """``run`` (which returns the blocks it processed) under the profiler,
    again until its trace is whole, reduced by ``summarize``."""
    for _ in range(tries):
        blocks, wall, work, host, whole = traced(run, host_ops)
        if whole:
            return summarize(work, host, wall, blocks)
        print(f"trace not whole ({len(work)} device events); tracing "
              "again", file=sys.stderr)
    raise RuntimeError(f"no whole trace in {tries} tries")


def _merge(intervals) -> List[Tuple[float, float]]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_segments(spans, ops):
    """Disjoint (start, end, label) pieces of each span: ``<span>/<op>``
    while a top-level host op runs, else ``<span>``."""
    starts = [o[0] for o in ops]
    segs = []
    for s, e, label in spans:
        i = bisect.bisect_left(starts, s)
        t = s
        while i < len(ops) and ops[i][0] < e:
            a, b, op = ops[i]
            if a > t:
                segs.append((t, a, label))
            if min(b, e) > max(a, t):
                segs.append((max(a, t), min(b, e), f"{label}/{op}"))
            t = max(t, min(b, e))
            i += 1
        if t < e:
            segs.append((t, e, label))
    return segs


def _overlap(idle, segs):
    """Seconds of ``idle`` under each label of ``segs`` (both sorted and
    disjoint; times in microseconds)."""
    out = defaultdict(float)
    i = j = 0
    while i < len(idle) and j < len(segs):
        a = max(idle[i][0], segs[j][0])
        b = min(idle[i][1], segs[j][1])
        if b > a:
            out[segs[j][2]] += (b - a) / 1e6
        if idle[i][1] < segs[j][1]:
            i += 1
        else:
            j += 1
    return out


def _top(d) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(work, host, wall_s: float, blocks: int) -> TraceSummary:
    """Counts, times and the breakdown of one whole trace. ``work``: the
    slice's device events; ``host``: the host events (the harness's spans
    and the ops inside them); event times in microseconds."""
    def dur(e):
        return e.time_range.end - e.time_range.start

    copies = [e for e in work if e.name.startswith(("Memcpy", "Memset"))]
    busy = _merge((e.time_range.start, e.time_range.end) for e in work)
    by_name = defaultdict(float)
    for e in work:
        by_name[e.name[:NAME_CHARS]] += dur(e) / 1e6
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len(SPAN):]) for e in host
                   if e.name.startswith(SPAN))
    idle_gaps: List[list] = []
    if spans:
        thread = next(e.thread for e in host if e.name.startswith(SPAN))
        ops = []
        # outer before inner where two ops start together
        for a, b, name in sorted(
                ((e.time_range.start, e.time_range.end, e.name[:NAME_CHARS])
                 for e in host if e.thread == thread
                 and not e.name.startswith(SPAN)),
                key=lambda o: (o[0], -o[1])):
            if not ops or a >= ops[-1][1]:  # top-level: in no other op
                ops.append((a, b, name))
        lo, hi = spans[0][0], max(s[1] for s in spans)
        idle, t = [], lo
        for a, b in busy:
            if a > t and t < hi:
                idle.append((t, min(a, hi)))
            t = max(t, b)
        if t < hi:
            idle.append((t, hi))
        by_host = _overlap(idle, _host_segments(spans, ops))
        rest = sum(b - a for a, b in idle) / 1e6 - sum(by_host.values())
        if rest > 0:
            by_host["harness"] += rest
        idle_gaps = _top(by_host)
    return TraceSummary(
        blocks=blocks, window_s=wall_s, kernels=len(work) - len(copies),
        copies=len(copies), device_s=sum(map(dur, work)) / 1e6,
        kernel_s=(sum(map(dur, work)) - sum(map(dur, copies))) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        host_copy_s=sum(dur(e) for e in copies
                        if "HtoD" in e.name or "DtoH" in e.name) / 1e6,
        device_ops=_top(by_name), idle_gaps=idle_gaps)
