"""``counters``: the program's counters over a host slice, read on the CPU
with a stand-in device trace planted (as ``test_pb_progtrace.py`` does): a
counter the program keeps reads as its share of the blocks, and one it
never counted reads nothing."""

import time

import pytest

from portbench import devtrace, harness
from portbench.catalog import Catalog

from conftest import CELLS

REPLAYS = ("engine.graph_replay_pct.stream", "engine.graph_replay_pct.live")


def _run(root, cell, plant):
    args = harness.parse(["--workload", cell, "--seed", str(2 ** 31 + 91),
                          "--seconds", "0.3", "--trace", "1"])
    return harness.run_cell(args, Catalog([str(root)]), time.perf_counter(),
                            plant=plant, device="cpu")


def _traced(run):
    run.trace = devtrace.summarize([], [], 1.0, 1)


@pytest.mark.parametrize("cell", CELLS)
def test_a_counted_step_reads_its_share_of_the_blocks(tiny_root, cell):
    from bfir_tpu_torch.utils import profiling as P

    def plant(run):
        # every block counts as replayed, as the graph step counts on a card
        _traced(run)
        step = run.sp._step

        def counted(*a):
            tr = P.current()
            if tr is not None:
                tr.count("engine.graph_replays")
            return step(*a)

        run.sp._step = counted

    r = _run(tiny_root, cell, plant)
    assert r["correct"]
    for name in REPLAYS:
        assert r["metrics"][name] == {"value": 100.0, "unit": "%"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_without_the_counter_reads_nothing(tiny_root, cell):
    # on the CPU the session steps eagerly: no graph, no counter
    r = _run(tiny_root, cell, _traced)
    assert r["correct"] and "engine.host_ms_per_block.live" in r["metrics"]
    assert not set(REPLAYS) & set(r["metrics"])
