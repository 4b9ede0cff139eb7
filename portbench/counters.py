"""The program's counters over a host slice of the cell's traffic.

One ``traced`` slice of the cell's traffic loop runs with a ``Tracer`` of
its own on the session, as ``progtrace``'s host slice does, and only
where that slice read something (a run on a card, a program with a
tracer).
``share(run, name)`` is counter ``name`` over ``session.blocks`` in %,
None where the program never counted ``name`` (a program without it).
"""

from __future__ import annotations

from typing import Optional

from portbench import progtrace
from portbench.catalog import Catalog

STATE = "counters"


def share(run, name: str) -> Optional[float]:
    if progtrace.read(run, "engine_host_ms") is None:
        return None
    if STATE not in run.state:
        from bfir_tpu_torch.utils.profiling import Tracer

        tracer = Tracer()
        progtrace._slice(run, Catalog().driver(run.traffic["loop"]), tracer)
        run.state[STATE] = dict(tracer.counters)
        progtrace.log(f"counters over a host slice: {run.state[STATE]}")
    counters = run.state[STATE]
    blocks = counters.get("session.blocks", 0)
    if name not in counters or not blocks:
        return None
    return 100.0 * counters[name] / blocks
