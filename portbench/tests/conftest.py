"""Tests of the benchmark harness. They run on the CPU, against a tiny
throwaway cell written to a temporary folder, except those marked
``portbench_chip``, which need a CUDA card and skip without one (decided in
the ``cuda_card`` fixture, never at import). Run them from the root of the
checkout: ``python -m pytest portbench/tests -q``."""

import json
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "portbench_chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on "
                    "the H100")


# the benchmark's kind of configuration at a test size: float64 on
# ``extended``, with the program's float32 path as its control
TINY_CONFIG = {
    "name": "tiny", "source": "a test size", "channels": 4, "taps": 2048,
    "sample_rate": 44100,
    "engine": {"block_length": 64, "dtype": "float64",
               "engine_mode": "extended", "self_check": True},
    "control_engine": {"dtype": "float32", "engine_mode": "hc"},
    "geometry": {"store": "float64", "in_store": "float32"},
    "impulse": {"law": "decaying_noise", "tau": 256, "scale": 0.5},
}
TINY_TRAFFIC = {
    "tiny_stream": {"loop": "stream", "chunk_frames": 1024, "pool_chunks": 4,
                    "level": 0.1, "warm_calls": 2, "check_segments": 2,
                    "trace_calls": 1},
    "tiny_live": {"loop": "live", "pace": 1.0, "chunk_frames": 1024,
                  "pool_chunks": 4, "level": 0.1, "warm_blocks": 16,
                  "check_segments": 2, "segment_blocks": 32,
                  "trace_blocks": 8},
}
CELLS = ("tiny.tiny_stream", "tiny.tiny_live")


@pytest.fixture
def tiny_root(tmp_path):
    """A folder holding a BENCHMARK.json of the tiny cells and their
    configuration, mixes and limits (nothing else: the catalog finds the
    drivers and readers in the repository)."""
    pb = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True)
    (pb / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    for name, mix in TINY_TRAFFIC.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    with open(os.path.join(os.path.dirname(__file__), "..", "..",
                           "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": "a test size",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [
        {"name": c, "config": "tiny", "traffic": c.split(".")[1],
         "chips": 1, "why": "tests"} for c in CELLS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in CELLS:
        # the live cell is held to its deadline as the repository's are
        late = {"late_pct": 50} if c == "tiny.tiny_live" else {}
        (pb / "limits" / f"{c}.json").write_text(
            json.dumps({"rel_err": 1e-10, "failed": 0, **late}))
    return tmp_path
