"""The two-stage engine's own spans over a host slice of the cell's traffic.

The program records each block's head step as an ``engine.head`` span and
each tail fire as an ``engine.tail`` span, counted in
``engine.tail_fires`` (``bfir_tpu_torch.core.nonuniform``), all inside the
session's ``engine.step``. One ``traced`` slice of the cell's traffic loop
runs with a ``Tracer`` of its own on the session, as ``counters`` does,
and only where the harness traced the device (a run on a card) and the
program has a tracer. It keeps each span name's self time
(``progtrace.self_ns``) and the counters.
``per(run, span, counter)`` is ``span``'s self time over counter
``counter``, in ms; None where the program recorded no such span or
counted none.
"""

from __future__ import annotations

from typing import Optional

from portbench import progtrace
from portbench.catalog import Catalog

STATE = "stagetrace"


def _readings(run) -> Optional[dict]:
    if run.trace is None or not hasattr(run.sp, "tracer"):
        return None
    from bfir_tpu_torch.utils.profiling import Tracer

    tracer = Tracer()
    progtrace._slice(run, Catalog().driver(run.traffic["loop"]), tracer)
    if tracer.dropped:
        progtrace.log(f"stage slice: {tracer.dropped} spans dropped; "
                      "nothing read")
        return None
    own = dict(progtrace.self_ns(tracer.spans))
    counters = dict(tracer.counters)
    progtrace.log(f"stage slice: counters {counters}; self time (ms) "
                  + ", ".join(f"{k} {v / 1e6:.5f}" for k, v in sorted(
                      own.items(), key=lambda kv: -kv[1])))
    return {"self_ns": own, "counters": counters}


def per(run, span: str, counter: str) -> Optional[float]:
    if STATE not in run.state:
        run.state[STATE] = _readings(run)
    got = run.state[STATE]
    if not got or span not in got["self_ns"]:
        return None
    count = got["counters"].get(counter, 0)
    if not count:
        return None
    return got["self_ns"][span] / 1e6 / count
