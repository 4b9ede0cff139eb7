"""``device.idle_pct``: the share (%) of the traced slice's wall time in
which no device work ran."""


def read(run):
    tr = run.trace
    return None if tr is None else 100.0 * (1.0 - tr.busy_s / tr.window_s)
