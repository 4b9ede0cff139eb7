"""``progtrace``: the arithmetic that cuts the program's spans into layers
and puts the device's idle time under them, on hand-made spans and busy
intervals; and whole traced runs of the tiny cells on the CPU, where the
host slice reads, the idle slice does not, and the session gets its tracer
back."""

import time
from typing import NamedTuple

import pytest

from portbench import devtrace, harness, progtrace
from portbench.catalog import Catalog

from conftest import CELLS

MS = 1_000_000  # ns


class S(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int


# one call of two blocks, in ms: the step and fetch layers, session between
CALL = [
    S("session.process", 0, 20, -1),  # 0
    S("session.to_device", 1, 2, 0),  # 1
    S("engine.step", 2, 7, 0),  # 2
    S("engine.rfft", 2, 4, 2),  # 3
    S("engine.mac", 4, 6, 2),  # 4
    S("session.to_device", 8, 9, 0),  # 5
    S("engine.step", 9, 12, 0),  # 6
    S("session.fetch", 13, 17, 0),  # 7
    S("session.overflow", 18, 19, 0),  # 8
]
SPANS = [S(s.name, s.start_ns * MS, s.end_ns * MS, s.parent) for s in CALL]


def test_segments_tile_each_call_by_its_innermost_span():
    segs = [(a // MS, b // MS, i) for a, b, i in progtrace.segments(SPANS)]
    assert segs == [(0, 1, 0), (1, 2, 1), (2, 4, 3), (4, 6, 4), (6, 7, 2),
                    (7, 8, 0), (8, 9, 5), (9, 12, 6), (12, 13, 0),
                    (13, 17, 7), (17, 18, 0), (18, 19, 8), (19, 20, 0)]
    assert sum(b - a for a, b, _ in segs) == 20


def test_host_split_and_self_time_in_exact_ms():
    split = progtrace.host_split(SPANS)
    assert split == {"session": 8 * MS, "engine": 8 * MS, "fetch": 4 * MS,
                     "process": 20 * MS}
    own = progtrace.self_ns(SPANS)
    assert own["session.process"] == 5 * MS
    assert own["engine.step"] == 4 * MS  # 1 of the first, 3 of the second
    assert own["engine.rfft"] == own["engine.mac"] == 2 * MS
    assert own["session.to_device"] == 2 * MS


def test_idle_under_each_span_in_exact_ms():
    # the device works [3, 5), [6, 10) and [15, 30) ms; merged as devtrace
    busy = devtrace._merge([(6 * MS, 8 * MS), (3 * MS, 5 * MS),
                            (7 * MS, 10 * MS), (15 * MS, 30 * MS)])
    segs = progtrace.segments(SPANS)
    idle = progtrace.idle_under(busy, segs)
    layer = progtrace.layer_of(SPANS)
    by_layer = {}
    for i, t in idle.items():
        by_layer[layer[i]] = by_layer.get(layer[i], 0) + t
    # idle in the call: [0, 3) [5, 6) [10, 15) ms
    assert {i: t // MS for i, t in idle.items() if t} == {
        0: 2,  # [0, 1) and [12, 13), the call's own
        1: 1, 3: 1, 4: 1,  # [1, 2); [2, 3) of rfft, [5, 6) of mac
        6: 2,  # [10, 12)
        7: 2,  # [13, 15)
    }
    assert by_layer == {"session": 3 * MS, "engine": 4 * MS,
                        "fetch": 2 * MS}
    assert sum(idle.values()) == 9 * MS


def _run(root, cell, plant):
    args = harness.parse(["--workload", cell, "--seed", str(2 ** 31 + 77),
                          "--seconds", "0.3", "--trace", "1"])
    return harness.run_cell(args, Catalog([str(root)]), time.perf_counter(),
                            plant=plant, device="cpu")


HOST = ("session.host_ms_per_block", "engine.host_ms_per_block",
        "session.fetch_ms_per_block")


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_reads_the_host_slice(tiny_root, cell):
    from bfir_tpu_torch.utils.profiling import Tracer

    held = {}

    def plant(run):
        # the harness traces the device only on a card; its summary stands
        # in for that trace, which the program's slices follow
        run.trace = devtrace.summarize([], [], 1.0, 1)
        held["sp"], held["prior"] = run.sp, Tracer()
        run.sp.tracer = held["prior"]

    r = _run(tiny_root, cell, plant)
    assert r["correct"]
    for name in HOST:
        for mix in ("stream", "live"):
            assert r["metrics"][f"{name}.{mix}"]["value"] > 0
            assert r["metrics"][f"{name}.{mix}"]["unit"] == "ms"
    assert not any(m.startswith("engine.idle_ms_per_block")
                   for m in r["metrics"])
    # the session's own tracer is back, and holds the window's calls alone
    assert held["sp"].tracer is held["prior"]
    assert held["prior"].calls == r["attempted"]


def test_a_program_without_a_tracer_reads_nothing():
    # a session from before the spans has no ``tracer``: nothing is read
    # and nothing raised, however many readers ask
    run = type("Run", (), {"trace": object(), "sp": object(), "state": {}})()
    for key in ("session_host_ms", "engine_host_ms", "fetch_ms",
                "engine_idle_ms"):
        assert progtrace.read(run, key) is None
    assert run.state == {progtrace.STATE: None}
