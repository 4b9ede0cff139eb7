"""``engine.device_ms_per_block.live``: the summed time of the traced
slice's kernels over its blocks, in ms. Host <-> device copies and memsets
are the session's and stay out (``session.launches_per_block`` counts
them)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.kernel_s * 1e3 / tr.blocks
