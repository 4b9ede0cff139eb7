"""``stream``: a closed loop over ``StreamProcessor.process``.

The input is a pool of seeded noise chunks played in a loop from frame 0
(``inputs.Pool``); each call hands the next chunk of ``chunk_frames``
frames, as soon as the last call returned: a converter, a batch job or a
player decoding ahead. Warm-up makes ``warm_calls`` calls (the first
builds the engine). The check keeps ``check_segments`` whole returned
chunks, drawn from the seed. The traced slice is ``trace_calls`` calls.
"""

from __future__ import annotations

import time

from portbench import inputs
from portbench.check import Segment
from portbench.window import Reservoir, Window, log_calls

# a closed loop: no block is due at a time, so there is no latency
RECORDS_LATENCY = False


def prepare(run) -> None:
    t = run.traffic
    run.pool = inputs.Pool(inputs.audio(
        run.input_seed, (t["pool_chunks"], run.channels, t["chunk_frames"]),
        t["level"], run.device))
    run.state.update(next=0, out_pos=0, kept=[])


def _call(run):
    """The next chunk through ``process``: (frames given, frames returned,
    a stretch of the output)."""
    x = run.pool.chunk(run.state["next"])
    with run.span("process"):
        y = run.sp.process(x, run.rate)
    run.state["next"] += 1
    start = run.state["out_pos"]
    run.state["out_pos"] += y.shape[1]
    return x.shape[1], y.shape[1], Segment(run.pool, start, y)


def warm(run) -> None:
    for _ in range(run.traffic["warm_calls"]):
        _call(run)


def window(run, seconds: float) -> Window:
    keep = Reservoir(run.traffic["check_segments"], run.check_rng)
    w = Window(t0=time.perf_counter())
    deadline = w.t0 + seconds
    while not w.calls or w.t_end < deadline:
        given, returned, seg = _call(run)
        w.record(given, returned)
        keep.offer(seg)
    run.state["kept"] = keep.items
    log_calls(w, "stream")
    return w


def traced(run) -> int:
    frames = sum(_call(run)[1] for _ in range(run.traffic["trace_calls"]))
    return frames // run.n


def segments(run):
    return run.state["kept"]
