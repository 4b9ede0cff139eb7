"""``engine.idle_ms_per_block.live``: the time the device ran nothing while
the host was inside an ``engine.step`` span, over ``session.blocks``, in
ms (``progtrace``'s idle slice, on a card only)."""

from portbench import progtrace


def read(run):
    return progtrace.read(run, "engine_idle_ms")
