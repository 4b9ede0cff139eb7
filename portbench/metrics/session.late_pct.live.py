"""``session.late_pct.live``: the share (%) of the window's blocks whose
output came back after their deadline, one block period after they were
due (``window.late_pct``, the same count the check holds to its limit)."""

from portbench.window import late_pct


def read(run):
    return late_pct(run.window, run.n / run.rate)
