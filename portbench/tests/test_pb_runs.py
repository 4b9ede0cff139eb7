"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped): sound runs come out correct, and the control and each fault
planted under the timed path come out not correct."""

import time

import pytest

from portbench import harness
from portbench.catalog import Catalog

from conftest import CELLS


def _run(root, cell, *extra, plant=None, seed=20260101):
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", "0.3", *extra])
    return harness.run_cell(args, Catalog([str(root)]), time.perf_counter(),
                            plant=plant, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    r = _run(tiny_root, cell, seed=2 ** 31 + 12345)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "check"
    assert r["check"]["rel_err"]["value"] < 1e-13
    assert {"setup_s", "realtime_x"} <= set(r["metrics"])
    assert r["device"]["count"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    r = _run(tiny_root, cell, "--control")
    assert not r["correct"]
    assert r["check"]["rel_err"]["value"] > r["check"]["rel_err"]["limit"]


def _stepper(run):
    """The timed path's step, the session's block step: it returns (state,
    out [C, N])."""
    return run.sp, "_step"


def _state_unchanged(run):
    obj, name = _stepper(run)
    step = getattr(obj, name)
    setattr(obj, name, lambda state, *a: (state, step(state, *a)[1]))


def _half_left_out(run):
    obj, name = _stepper(run)
    step = getattr(obj, name)

    def half(*a):
        state, out = step(*a)
        out = out.clone()
        out[..., out.shape[-2] // 2:, :] = 0
        return state, out

    setattr(obj, name, half)


def _answer_altered(run):
    obj, name = _stepper(run)
    step = getattr(obj, name)

    def altered(*a):
        state, out = step(*a)
        out = out.clone()
        out[..., 0, 0] += 1.0
        return state, out

    setattr(obj, name, altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    r = _run(tiny_root, cell, plant=fault)
    assert not r["correct"], r["check"]


def test_trace_run_reports_per_layer_metrics(tiny_root):
    r = _run(tiny_root, "tiny.tiny_live", "--trace", "1")
    # without a card there is no device trace: only the window's readers
    assert set(r["metrics"]) == {"block_p99_ms", "session.late_pct.live"}
    assert "breakdown" not in r and r["correct"]
