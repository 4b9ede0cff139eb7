"""``block_p50_ms.live``: the median, over every block of the window, of
the time from when the block was due to when its output was back
(``block_p99_ms``'s samples)."""

from portbench.window import percentile


def read(run):
    lat = run.window.latency_s
    return percentile(lat, 50) * 1e3 if lat else None
