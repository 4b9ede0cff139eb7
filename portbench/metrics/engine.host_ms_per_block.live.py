"""``engine.host_ms_per_block.live``: the program's host time a block in
its ``engine.step`` spans (the engine's dispatch), over
``session.blocks``, in ms (``progtrace``'s host slice)."""

from portbench import progtrace


def read(run):
    return progtrace.read(run, "engine_host_ms")
