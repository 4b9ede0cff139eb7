"""``engine.roofline_pct.stream``: the least time of one block's work at
the deployment's geometry (``roofline``: its planes at their tiers and the
block's input and output, or its operations, over the H100's published
peaks) over ``engine.device_ms_per_block.stream`` (kernels alone), in %.
"""


def read(run):
    tr = run.trace
    if tr is None or tr.kernel_s <= 0:
        return None
    least_ms, _ = run.geometry.least_ms()
    return 100.0 * least_ms / (tr.kernel_s * 1e3 / tr.blocks)
