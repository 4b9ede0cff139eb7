"""``engine.head_host_ms_per_block.live``: the program's host self time a
block in its ``engine.head`` spans (the two-stage engine's head step: the
N-block transform, K1 and the inverse), over ``session.blocks``, in ms
(``stagetrace``'s host slice); nothing where the program has no such
span."""

from portbench import stagetrace


def read(run):
    return stagetrace.per(run, "engine.head", "session.blocks")
