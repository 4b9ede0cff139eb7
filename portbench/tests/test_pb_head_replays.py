"""``engine.head_replay_pct.live``: the two-stage engine's head replays
over the blocks, read on the CPU with a stand-in device trace planted (as
``test_pb_counters.py`` does). On the CPU the program steps its head
eagerly and counts no replays, so the metric reads nothing, as it does on
a program without the counter; a step that counts every block reads
100."""

import json
import time

import pytest

from portbench import devtrace, harness
from portbench.catalog import Catalog

from conftest import CELLS
from test_pb_atmos64 import TINY_NU

METRIC = "engine.head_replay_pct.live"
NU_CELL = "tinynu.tiny_live"


@pytest.fixture
def root(tiny_root):
    """``tiny_root`` with a live cell of the two-stage ``TINY_NU``."""
    pb = tiny_root / "portbench"
    (pb / "configs" / "tinynu.json").write_text(json.dumps(TINY_NU))
    (pb / "limits" / f"{NU_CELL}.json").write_text(
        json.dumps({"rel_err": 2e-6, "failed": 0}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinynu", "source": "a test size",
                             "file": "portbench/configs/tinynu.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": NU_CELL, "config": "tinynu",
                               "traffic": "tiny_live", "chips": 1,
                               "why": "tests"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


def _run(root, cell, plant):
    args = harness.parse(["--workload", cell, "--seed", str(2 ** 31 + 24),
                          "--seconds", "0.3", "--trace", "1"])
    return harness.run_cell(args, Catalog([str(root)]), time.perf_counter(),
                            plant=plant, device="cpu")


def _traced(run):
    run.trace = devtrace.summarize([], [], 1.0, 1)


@pytest.mark.parametrize("cell", CELLS + (NU_CELL,))
def test_a_program_without_the_counter_reads_nothing(root, cell):
    r = _run(root, cell, _traced)
    assert r["correct"] and "engine.host_ms_per_block.live" in r["metrics"]
    assert METRIC not in r["metrics"]


def test_a_counted_head_reads_its_share_of_the_blocks(root):
    from bfir_tpu_torch.utils import profiling as P

    def plant(run):
        # every head counts as replayed, as the graph step counts on a card
        _traced(run)
        step = run.sp._step

        def counted(*a):
            tr = P.current()
            if tr is not None:
                tr.count("engine.head_replays")
            return step(*a)

        run.sp._step = counted

    r = _run(root, NU_CELL, plant)
    assert r["correct"], r["check"]
    assert r["metrics"][METRIC] == {"value": 100.0, "unit": "%"}
