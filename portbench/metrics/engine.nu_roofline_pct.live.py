"""``engine.nu_roofline_pct.live``: the least time of one block's
two-stage work at the deployment's geometry (``roofline_nu``: each
stage's planes at their tiers, the tail's over its ratio of blocks, and
the block's input and output, or its operations, over the H100's
published peaks) over ``engine.device_ms_per_block.live`` (kernels
alone), in %; nothing for a configuration without ``stages``."""

from portbench import roofline_nu


def read(run):
    tr = run.trace
    if tr is None or tr.kernel_s <= 0 or "stages" not in run.config:
        return None
    least_ms, _ = roofline_nu.geometry(run.config).least_ms()
    return 100.0 * least_ms / (tr.kernel_s * 1e3 / tr.blocks)
