"""How ``correct`` is decided.

The window keeps what the program returned for a sample of its output
(``Segment``: a stretch of one stream's output and where it starts). Once
the window has closed, the reference works out the same stretches from the
same inputs, and the numbers the cell's limits name
(``limits/<cell>.json``) are compared with them, every one:

- ``rel_err``: the worst channel's relative RMS error over every sampled
  stretch, sqrt(sum (y - ref) ** 2 / sum ref ** 2);
- ``failed``: calls in the window that returned another number of frames
  than they were given (limit 0);
- ``late_pct``, on an open loop (one that records each block's latency):
  the share (%) of the window's blocks whose output came back more than
  one block period N / fs after the block was due (``window.late_pct``,
  the count ``session.late_pct.live`` reads). For a live processor a
  block back after its deadline is a dropout: right samples, too late.
  The limit of 50 says that the median block met its deadline
  (``block_p50_ms.live`` <= N / fs); a run that misses most of its deadlines
  does not run the deployment. It follows from the deadline, not from
  readings: the live cells read 0 and at most about 9. A limit of
  ``late_pct`` on a loop that records no latencies is refused when the
  cell is loaded.

A NaN reads as failing. The control is the program's own path in the
precision below the configuration's (its ``control_engine``), judged the
same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from portbench.inputs import Pool
from portbench.reference import Reference


@dataclass
class Segment:
    pool: Pool  # the input stream the output came from
    start: int  # the stream frame of out[:, 0]
    out: np.ndarray  # [C, n] what the program returned


def rel_err(segments: List[Segment], impulse: np.ndarray) -> float:
    ref = Reference(impulse)
    c = impulse.shape[0]
    num = np.zeros(c)
    den = np.zeros(c)
    for seg in segments:
        n = seg.out.shape[1]
        hist = seg.pool.frames(seg.start - ref.taps + 1, seg.start + n)
        want = ref.segment(hist)
        got = np.asarray(seg.out, dtype=np.float64)
        num += ((got - want) ** 2).sum(axis=1)
        den += (want ** 2).sum(axis=1)
    return float(np.max(np.sqrt(num / den)))


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(every value within its limit, {name: {"value", "limit"}})."""
    table = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
