"""``engine.graph_replay_pct.live``: the share (%) of blocks the
``extended`` engine stepped by replaying its CUDA graph,
``engine.graph_replays`` over ``session.blocks`` in a host slice
(``counters``); nothing where the program has no graph step."""

from portbench import counters


def read(run):
    return counters.share(run, "engine.graph_replays")
