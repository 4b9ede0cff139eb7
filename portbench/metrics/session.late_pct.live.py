"""``session.late_pct.live``: the share (%) of the window's blocks whose
output came back after their deadline, one block period after they were
due."""

import numpy as np


def read(run):
    lat = np.asarray(run.window.latency_s)
    if not lat.size:
        return None
    return 100.0 * float(np.mean(lat > run.n / run.rate))
