"""The rate and percentile arithmetic, the live loop's due times, and the
roofline's byte counts."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.catalog import Catalog
from portbench.inputs import Pool
from portbench.roofline import Uniform, bound, geometry
from portbench.window import Reservoir, Window, late_pct

PERIOD_FRAMES = 64
RATE = 44100


class FakeProcessor:
    """process() returns its input after ``cost`` seconds, ``stall``
    seconds more on call ``stall_at``; it records when each call began."""

    def __init__(self, cost, stall=0.0, stall_at=-1):
        self.cost, self.stall, self.stall_at = cost, stall, stall_at
        self.starts = []

    def process(self, x, rate):
        self.starts.append(time.perf_counter())
        wait = self.cost + (self.stall if len(self.starts) - 1
                            == self.stall_at else 0.0)
        end = time.perf_counter() + wait
        while time.perf_counter() < end:
            pass
        return np.array(x)


def _run(loop, sp, **traffic):
    run = SimpleNamespace(
        traffic=traffic, channels=2, n=PERIOD_FRAMES, rate=RATE,
        input_seed=1, device="cpu", state={}, sp=sp,
        check_rng=np.random.default_rng(0), span=lambda name: _Null())
    drv = Catalog().driver(loop)
    drv.prepare(run)
    return run, drv


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _read(name, run):
    return Catalog().reader(name).read(run)


def test_realtime_x_counts_all_work_and_time():
    sp = FakeProcessor(cost=0.002)
    run, drv = _run("stream", sp, chunk_frames=4410, pool_chunks=2,
                    level=0.1, check_segments=1)
    run.window = drv.window(run, 0.2)
    w = run.window
    assert w.frames == w.calls * 4410 and w.failed == 0
    assert w.t_end >= w.t0 + 0.2  # the last call issued before the close
    rx = _read("realtime_x", run)
    assert rx == pytest.approx(w.frames / w.seconds / RATE)
    assert 0.5 * 4410 / 0.002 / RATE < rx < 4410 / 0.002 / RATE

    stalled = FakeProcessor(cost=0.002, stall=0.1, stall_at=5)
    run2, drv2 = _run("stream", stalled, chunk_frames=4410, pool_chunks=2,
                      level=0.1, check_segments=1)
    run2.window = drv2.window(run2, 0.2)
    # a 0.1 s stall in a 0.2 s window halves what the window completes
    assert _read("realtime_x", run2) < 0.7 * rx


def test_live_due_times_and_a_planted_stall():
    period = PERIOD_FRAMES / RATE
    sp = FakeProcessor(cost=0.2 * period, stall=5 * period, stall_at=100)
    run, drv = _run("live", sp, pace=1.0, chunk_frames=1024, pool_chunks=2,
                    level=0.1)
    run.window = w = drv.window(run, 0.2)
    blocks = int(0.2 * RATE / PERIOD_FRAMES)
    assert w.calls == blocks == len(w.latency_s) == len(sp.starts)
    due = w.t0 + (np.arange(blocks) + 1) * period
    starts = np.asarray(sp.starts)
    assert (starts >= due).all()  # never before its due time
    assert w.block_index == list(range(blocks))
    lat = np.asarray(w.latency_s)
    # the stalled call and the calls that queued behind it carry the wait
    assert lat[100] > 5 * period
    assert lat[101] > 4 * period and lat[102] > 3 * period
    assert (np.abs(starts[:100] - due[:100]) < 0.5 * period).mean() > 0.9
    p99 = _read("block_p99_ms", run)
    p50 = _read("block_p50_ms.live", run)
    assert p50 < period * 1e3 < p99
    assert _read("session.late_pct.live", run) == pytest.approx(
        100 * np.mean(lat > period))

    calm = FakeProcessor(cost=0.2 * period)
    run2, drv2 = _run("live", calm, pace=1.0, chunk_frames=1024,
                      pool_chunks=2, level=0.1)
    run2.window = drv2.window(run2, 0.2)
    assert _read("block_p99_ms", run2) < p99


def test_uniform_float64_counts_by_hand():
    # the plugin: 2 (ring, coefficients) x 64 partitions x 2 (re, im) x
    # 1024 lanes x 8 B x 8 channels; float32 in, float64 out
    g = geometry({"taps": 65536, "channels": 8,
                  "engine": {"block_length": 1024},
                  "geometry": {"store": "float64", "in_store": "float32"}})
    assert g == Uniform(65536, 1024, 8)
    assert g.partitions == 64
    assert g.mac_bytes() == 16777216
    assert g.io_bytes() == 8 * 1024 * 12
    assert g.flops() == (8 * 1024 * 64 + 10 * 1024 * 11) * 8
    ms, by = g.least_ms()
    assert by == "bytes"
    assert ms == pytest.approx((16777216 + 98304) / 3.35e12 * 1e3)
    assert bound(0, 34e9, "float64") == (pytest.approx(1.0), "operations")
    assert bound(0, 67e9) == (pytest.approx(1.0), "operations")


def test_reservoir_keeps_k_uniformly():
    counts = np.zeros(10)
    for s in range(2000):
        r = Reservoir(3, np.random.default_rng(s))
        for i in range(10):
            r.offer(i)
        assert len(r.items) == 3 and len(set(r.items)) == 3
        counts[r.items] += 1
    assert np.all(np.abs(counts / 2000 - 0.3) < 0.05)


def test_pool_frames_loop_and_silence():
    chunks = np.arange(2 * 1 * 4, dtype=np.float32).reshape(2, 1, 4)
    p = Pool(chunks)
    assert p.frames(-2, 10).tolist() == [[0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 0,
                                          1]]


def test_window_record_counts_failures():
    w = Window(t0=time.perf_counter())
    w.record(64, 64)
    w.record(64, 0)
    assert (w.calls, w.frames, w.failed) == (2, 64, 1)


def test_late_pct_counts_blocks_past_one_period():
    period = PERIOD_FRAMES / RATE
    w = Window(t0=0.0)
    assert late_pct(w, period) is None  # a closed loop records none
    # a block back exactly one period after it was due met its deadline
    w.latency_s = [0.5 * period, period, 1.5 * period, 3 * period]
    assert late_pct(w, period) == 50.0


def test_card_ms_per_block_is_kernel_time_over_blocks():
    from portbench import devtrace

    run = SimpleNamespace(trace=None)
    assert _read("card_ms_per_block", run) is None  # no trace, no value
    run.trace = devtrace.summarize([], [], 1.0, 64)
    run.trace.kernel_s, run.trace.busy_s = 0.0032, 0.004  # copies out
    assert _read("card_ms_per_block", run) == pytest.approx(0.05)
