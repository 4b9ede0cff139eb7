"""``engine.head_replay_pct.live``: the share (%) of blocks whose head step
the two-stage engine replayed from its CUDA graphs,
``engine.head_replays`` over ``session.blocks`` in a host slice
(``counters``); nothing where the program has no head graphs."""

from portbench import counters


def read(run):
    return counters.share(run, "engine.head_replays")
