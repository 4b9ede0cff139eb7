"""Device kernels, copies and memsets per block in the traced slice (all
of them: the port's kernels, PyTorch's and the copies)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.launches / tr.blocks
