"""``block_p50_ms``: the median of ``block_p99_ms``'s samples."""

from portbench.window import percentile


def read(run):
    lat = run.window.latency_s
    return percentile(lat, 50) * 1e3 if lat else None
