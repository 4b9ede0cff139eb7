"""``engine.tail_host_ms_per_fire.live``: the program's host self time in
its ``engine.tail`` spans (each tail fire: the M-block's forward
transform, K3, K4 and the pending push), over the ``engine.tail_fires``
counter, in ms a fire (``stagetrace``'s host slice); nothing where the
program has no such span."""

from portbench import stagetrace


def read(run):
    return stagetrace.per(run, "engine.tail", "engine.tail_fires")
