"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped): sound runs come out correct, and the control and each fault
planted under the timed path come out not correct."""

import json
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
    # no card, no device trace: its end-to-end metric is left out
    assert "card_ms_per_block" not in r["metrics"]
    assert r["device"]["count"] == 1 and "busy_s" not in r["device"]
    # the live cell's blocks met their deadlines; the stream has none
    late = r["check"].get("late_pct")
    if cell == "tiny.tiny_live":
        assert late["value"] <= late["limit"] == 50
    else:
        assert late is None


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
    assert set(r["metrics"]) == {"block_p99_ms", "block_p50_ms.live",
                                 "session.late_pct.live"}
    assert "breakdown" not in r and r["correct"]


def _slow_step(run, every=1):
    """Every ``every``-th block's step takes twice the block period: right
    samples, after their deadline."""
    obj, name = _stepper(run)
    step = getattr(obj, name)
    period = run.n / run.rate
    calls = [0]

    def slow(*a):
        calls[0] += 1
        if calls[0] % every == 0:
            time.sleep(2 * period)
        return step(*a)

    setattr(obj, name, slow)


def test_a_live_run_late_on_most_blocks_is_not_correct(tiny_root):
    r = _run(tiny_root, "tiny.tiny_live", plant=_slow_step)
    check = r["check"]
    assert not r["correct"], check
    assert check["late_pct"]["value"] > check["late_pct"]["limit"] == 50
    # late, not wrong
    assert check["rel_err"]["value"] <= check["rel_err"]["limit"]
    assert r["failed"] == 0


def test_late_pct_on_a_closed_loop_fails_at_load(tiny_root):
    limits = tiny_root / "portbench" / "limits" / "tiny.tiny_stream.json"
    limits.write_text(json.dumps({"rel_err": 1e-10, "failed": 0,
                                  "late_pct": 50}))
    with pytest.raises(ValueError, match="late_pct.*'stream'"):
        Catalog([str(tiny_root)]).cell("tiny.tiny_stream")


def test_check_and_reader_count_the_same_late_blocks(tiny_root):
    r = _run(tiny_root, "tiny.tiny_live", "--trace", "1",
             plant=lambda run: _slow_step(run, every=8))
    late = r["check"]["late_pct"]["value"]
    assert late > 0
    assert r["metrics"]["session.late_pct.live"]["value"] == late


@pytest.mark.parametrize("cell,trace,traced", [
    ("plugin8_f64.live", 0, True), ("atmos64_f32.live", 0, True),
    ("plugin8_f64.stream", 0, False), ("plugin8_f64.stream", 1, True)])
def test_device_trace_metric_traces_every_run(cell, trace, traced):
    # the live cells' card_ms_per_block comes from a trace after the window
    # in their --trace 0 runs too; the stream traces only with --trace 1
    assert harness.traces(Catalog().cell(cell), trace) is traced
