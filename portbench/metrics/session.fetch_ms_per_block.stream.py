"""``session.fetch_ms_per_block.stream``: the program's host time a block in
its ``session.fetch`` spans (the drain's join, its wait for the device
and the device-to-host copy), over ``session.blocks``, in ms
(``progtrace``'s host slice)."""

from portbench import progtrace


def read(run):
    return progtrace.read(run, "fetch_ms")
