"""``live``: an open loop over ``StreamProcessor.process``, one block a
call, at a fixed rate: ``pace`` times the real-time rate.

Window block k is due at t0 + (k + 1) N / (fs x pace): at pace 1, when its
last frame would have arrived. The generator spins on the host clock until
then and hands exactly one block. A call still running at that time delays
the next, whose wait counts in its latency, which runs from the due time
to the output's return; its deadline stays one real-time block period
(N / fs) after it was due. The window holds the blocks due within
``--seconds``, the same count on every seed. Users: live room correction
or monitoring. The input is the seeded pool of ``stream``
(``inputs.Pool``), block after block; warm-up hands ``warm_blocks``
blocks unpaced (the first builds the engine). The check takes
``check_segments`` runs of ``segment_blocks`` consecutive window blocks at
seeded places. The traced slice is ``trace_blocks`` blocks at the same
pace.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import inputs
from portbench.check import Segment
from portbench.window import Window, percentile, spin_until

# the window records each block's latency, so a cell's limits may hold
# ``late_pct``
RECORDS_LATENCY = True


def prepare(run) -> None:
    t = run.traffic
    run.pool = inputs.Pool(inputs.audio(
        run.input_seed, (t["pool_chunks"], run.channels, t["chunk_frames"]),
        t["level"], run.device))
    run.state.update(next=0, outs=[])


def _block(run) -> np.ndarray:
    a = run.state["next"] * run.n
    off = a % run.pool.chunk_frames
    return run.pool.chunk(a // run.pool.chunk_frames)[:, off:off + run.n]


def _call(run, x):
    with run.span("process"):
        y = run.sp.process(x, run.rate)
    run.state["next"] += 1
    return y


def warm(run) -> None:
    for _ in range(run.traffic["warm_blocks"]):
        _call(run, _block(run))


def _paced(run, blocks: int, w: Window, outs=None) -> None:
    period = run.n / run.rate / run.traffic["pace"]
    for k in range(blocks):
        due = w.t0 + (k + 1) * period
        x = _block(run)
        index = run.state["next"]
        with run.span("wait"):
            spin_until(due)
        issued = time.perf_counter()
        y = _call(run, x)
        w.record(x.shape[1], y.shape[1])
        w.block_index.append(index)
        w.latency_s.append(w.t_end - due)
        w.issue_late_s.append(issued - due)
        w.service_s.append(w.t_end - issued)
        if outs is not None:
            outs.append((index, y))


def window(run, seconds: float) -> Window:
    blocks = int(seconds * run.rate * run.traffic["pace"] / run.n)
    outs = []
    w = Window(t0=time.perf_counter())
    _paced(run, blocks, w, outs)
    run.state["outs"] = outs
    late = np.asarray(w.issue_late_s) * 1e3
    lat = np.asarray(w.latency_s) * 1e3
    svc = np.asarray(w.service_s) * 1e3

    def q(v):
        return ", ".join(f"p{p} {percentile(v, p):.4f}"
                         for p in (50, 90, 99, 99.9)) + f", max {v.max():.4f}"

    print(f"live: {blocks} blocks due; calls issued after their due time "
          f"by {q(late)} ms; latency {q(lat)} ms; calls' own time "
          f"{q(svc)} ms; the 10 longest latencies at blocks "
          f"{np.argsort(lat)[-10:][::-1].tolist()}", file=sys.stderr)
    return w


def traced(run) -> int:
    blocks = run.traffic["trace_blocks"]
    _paced(run, blocks, Window(t0=time.perf_counter()))
    return blocks


def segments(run):
    outs = run.state["outs"]
    seg = min(run.traffic["segment_blocks"], len(outs))
    out = []
    for _ in range(run.traffic["check_segments"]):
        s = int(run.check_rng.integers(0, len(outs) - seg + 1))
        y = np.concatenate([o for _, o in outs[s:s + seg]], axis=1)
        out.append(Segment(run.pool, outs[s][0] * run.n, y))
    return out
