"""BENCHMARK.json against the benchmark's contract, and the catalog finding
every piece by name, a throwaway one from a temporary folder too."""

import json
import os
import re

import pytest

from portbench.catalog import REPO_ROOT, Catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert os.path.getsize(os.path.join(REPO_ROOT, "BENCHMARK.json")) < 65536


def test_every_cell_reports_what_its_metrics_move(bench):
    cat = Catalog()
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = cat.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    for m in bench["per_layer"]:
        assert m["workloads"]
        assert any(m["moves"] == e["name"] for e in bench["end_to_end"])


def test_every_piece_is_found_by_name(bench):
    cat = Catalog()
    for c in bench["configs"]:
        cfg = cat.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == []
    for w in bench["workloads"]:
        cell = cat.cell(w["name"])
        drv = cat.driver(cell.traffic["loop"])
        for fn in ("prepare", "warm", "window", "traced", "segments"):
            assert callable(getattr(drv, fn))
        # an open loop's cell is held to its deadline too, a closed one's
        # cannot be
        late = {"late_pct"} if drv.RECORDS_LATENCY else set()
        assert set(cell.limits) == {"rel_err", "failed"} | late
        assert cell.limits.get("late_pct", 50) == 50
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cat.reader(m["name"]).read)


def test_throwaway_pieces_from_a_temporary_folder(tiny_root):
    metric = tiny_root / "portbench" / "metrics"
    metric.mkdir()
    (metric / "tiny.frames.py").write_text(
        "def read(run):\n    return run.window.frames\n")
    cat = Catalog([str(tiny_root)])
    cell = cat.cell("tiny.tiny_stream")
    assert cell.config["channels"] == 4
    assert cell.traffic["chunk_frames"] == 1024
    assert cell.limits["rel_err"] == 1e-10
    assert callable(cat.driver("stream").window)
    assert cat.reader("tiny.frames").read(
        type("R", (), {"window": type("W", (), {"frames": 7})})) == 7
    # the repository's own cells stay out of the throwaway BENCHMARK.json
    with pytest.raises(KeyError):
        cat.cell("plugin8_f64.stream")
