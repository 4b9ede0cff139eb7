"""``card_ms_per_block``: the card's compute time a block, in ms: the summed
time of the kernels in the slice of the cell's traffic traced after the
window, over the slice's blocks. Over the block period it is the share of
the card's compute that one stream holds. Copies and memsets run on the
copy engines; a pageable copy's time carries the host's staging of it, so
they stay out (``session.launches_per_block`` counts them)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.kernel_s * 1e3 / tr.blocks
