"""``session.host_ms_per_block.stream``: the program's host time a block
in the session layer: its ``session.process`` spans less their
``engine.step`` and ``session.fetch`` spans, over ``session.blocks``, in
ms (``progtrace``'s host slice)."""

from portbench import progtrace


def read(run):
    return progtrace.read(run, "session_host_ms")
