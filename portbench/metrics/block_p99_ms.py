"""``block_p99_ms``: the 99th percentile, over every block of the window,
of the time from when the block was due to when its output was back."""

from portbench.window import percentile


def read(run):
    lat = run.window.latency_s
    return percentile(lat, 99) * 1e3 if lat else None
