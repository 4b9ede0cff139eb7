"""The cinema cell ``atmos64_f32.live``: it loads through the catalog, the
two-stage count reads the geometry as the program counts it, and the
two-stage engine's spans are read where the program records them and
nothing is read where it does not (on the CPU, with a stand-in device
trace planted, as ``test_pb_counters.py`` does)."""

import json
import time

import pytest

from portbench import devtrace, harness, roofline_nu
from portbench.catalog import Catalog

from conftest import TINY_TRAFFIC

CELL = "atmos64_f32.live"
NEW = ("engine.device_ms_per_block.live", "engine.nu_roofline_pct.live",
       "engine.head_host_ms_per_block.live",
       "engine.tail_host_ms_per_fire.live", "engine.head_replay_pct.live")
SHARED = ("block_p99_ms", "block_p50_ms.live", "session.late_pct.live",
          "session.launches_per_block.live", "session.host_ms_per_block.live",
          "session.fetch_ms_per_block.live", "engine.host_ms_per_block.live",
          "engine.idle_ms_per_block.live")
STAGES = ("engine.head_host_ms_per_block.live",
          "engine.tail_host_ms_per_fire.live")


def test_the_cell_loads_through_the_catalog():
    cat = Catalog()
    cell = cat.cell(CELL)
    cfg = cell.config
    assert (cfg["channels"], cfg["taps"], cfg["sample_rate"]) == (
        64, 65536, 48000)
    assert cfg["engine"] == {"block_length": 128, "dtype": "float32",
                             "engine_mode": "auto", "self_check": True}
    assert cfg["control_engine"] == {"nu_tail_store": "int16"}
    assert cell.chips == 1 and cell.traffic["loop"] == "live"
    # one 128-frame block due every 2.667 ms: 375 calls a second
    assert cfg["sample_rate"] * cell.traffic["pace"] / 128 == 375
    assert set(cell.limits) == {"rel_err", "failed", "late_pct"}
    assert cell.limits["failed"] == 0 and cell.limits["late_pct"] == 50
    assert {m["name"] for m in cell.end_to_end} == {"card_ms_per_block",
                                                     "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert per_layer == set(NEW) | set(SHARED)
    for m in cell.per_layer:
        assert m["moves"] == "card_ms_per_block"
        assert callable(cat.reader(m["name"]).read)
    # the plugin's cells keep their own metrics: the new ones list this
    # cell alone
    for other in ("plugin8_f64.live", "plugin8_f64.stream"):
        assert not set(NEW) & {m["name"] for m in cat.cell(other).per_layer}


def test_two_stage_count_at_the_cells_geometry():
    from bfir_tpu_torch.core.nonuniform import nu_geometry

    cfg = Catalog().cell(CELL).config
    g = roofline_nu.geometry(cfg)
    assert (g.p_head, g.p_tail, g.m) == (16, 62, 1024)
    spec = nu_geometry(65536, 128, 8, tail_store="int24")
    assert (spec.p_head, spec.p_tail) == (g.p_head, g.p_tail)
    io = 64 * 128 * (4 + 4)
    assert g.io_bytes() == io
    assert g.mac_bytes() == spec.traffic_bytes_per_block * 64
    assert g.mac_bytes() + g.io_bytes() == 8_257_536
    # MACs 8 x (128 x 16 + 1024 x 62 / 8), transforms 10 x 128 x 8 and
    # 10 x 1024 x 11 / 8, a channel
    assert g.flops() == 64 * (8 * (2048 + 7936) + 10240 + 14080)
    ms, by = g.least_ms()
    assert by == "bytes" and ms == pytest.approx(8_257_536 / 3.35e12 * 1e3)


# the deployment's kind at a test size: the two-stage engine forced (auto
# on the CPU builds complex), its int24 tail, and the int16 control
TINY_NU = {
    "name": "tinynu", "source": "a test size", "channels": 4, "taps": 4096,
    "sample_rate": 48000,
    "engine": {"block_length": 16, "dtype": "float32",
               "engine_mode": "nonuniform", "nu_tail_store": "int24",
               "self_check": True},
    "control_engine": {"nu_tail_store": "int16"},
    "geometry": {"store": "float32", "in_store": "float32"},
    "stages": {"ratio": 8, "head_store": "float32", "tail_store": "int24"},
    "impulse": {"law": "decaying_noise", "tau": 512, "scale": 0.5},
}


@pytest.fixture
def nu_root(tiny_root):
    """``tiny_root`` with a live cell of ``TINY_NU`` added."""
    pb = tiny_root / "portbench"
    (pb / "configs" / "tinynu.json").write_text(json.dumps(TINY_NU))
    (pb / "limits" / "tinynu.tiny_live.json").write_text(
        json.dumps({"rel_err": 2e-6, "failed": 0}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinynu", "source": "a test size",
                             "file": "portbench/configs/tinynu.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tinynu.tiny_live",
                               "config": "tinynu", "traffic": "tiny_live",
                               "chips": 1, "why": "tests"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


def _run(root, cell, plant, *extra):
    args = harness.parse(["--workload", cell, "--seed", str(2 ** 31 + 22),
                          "--seconds", "0.3", "--trace", "1", *extra])
    return harness.run_cell(args, Catalog([str(root)]), time.perf_counter(),
                            plant=plant, device="cpu")


def _traced(run):
    run.trace = devtrace.summarize([], [], 1.0, 1)


def test_no_stage_spans_read_nothing(tiny_root):
    # the extended engine records no engine.head or engine.tail
    r = _run(tiny_root, "tiny.tiny_live", _traced)
    assert r["correct"] and "engine.host_ms_per_block.live" in r["metrics"]
    assert not set(STAGES) & set(r["metrics"])
    # no stages in the configuration: no two-stage count
    assert "engine.nu_roofline_pct.live" not in r["metrics"]


def test_two_stage_spans_read_on_the_cpu(nu_root):
    blocks = TINY_TRAFFIC["tiny_live"]["trace_blocks"]
    least_ms, _ = roofline_nu.geometry(TINY_NU).least_ms()

    def plant(run):
        # a stand-in trace whose kernels take twice the least time
        _traced(run)
        run.trace.blocks = blocks
        run.trace.kernel_s = 2 * least_ms * blocks / 1e3

    r = _run(nu_root, "tinynu.tiny_live", plant)
    assert r["correct"], r["check"]
    m = r["metrics"]
    for name in STAGES:
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"
    assert m["engine.nu_roofline_pct.live"]["value"] == pytest.approx(50.0)
    assert m["engine.device_ms_per_block.live"]["value"] == pytest.approx(
        2 * least_ms)


def test_two_stage_control_is_not_correct(nu_root):
    r = _run(nu_root, "tinynu.tiny_live", None, "--control")
    assert not r["correct"]
    assert r["check"]["rel_err"]["value"] > r["check"]["rel_err"]["limit"]
