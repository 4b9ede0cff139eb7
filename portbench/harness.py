"""One run of one cell: set-up, the measured window, the traced slice, the
check, and the result line.

Set-up makes the impulse and the input from the seed, writes the impulse
file under ``TMPDIR``, builds ``StreamProcessor`` and lets the traffic's
driver warm every shape its window uses; ``setup_s`` runs from process
start to the window's first call. The program's artifact cache (its
self-check verdicts among them) lives in the run's own temporary folder,
so every run does the same set-up, the full self-check included. With
``--trace 1``, and in every run of a cell with an end-to-end metric read
from the device trace, a slice of the same traffic runs under the profiler
after the window. Then the program's state is dropped and the reference
checks the sample the window kept. The last line of standard output is the
result; the check's numbers, each beside its limit, are the last lines of
standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

from portbench import check, devtrace, inputs, roofline
from portbench.catalog import Catalog, Cell
from portbench.window import Window, late_pct

# top-level module names a run may not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "bfir_tpu")
_NULL = contextlib.nullcontext()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names) -> List[str]:
    """The loaded modules' top-level names (before the first dot, whole)
    that are in ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Run:
    """What a driver works on: the cell, the seeded inputs, the program
    under test and the traffic driver's own state."""

    def __init__(self, cell: Cell, seed: int, device):
        cfg = cell.config
        self.cell = cell
        self.traffic = cell.traffic
        self.config = cfg
        self.device = device
        self.rate = int(cfg["sample_rate"])
        self.n = int(cfg["engine"]["block_length"])
        self.channels = int(cfg["channels"])
        self.taps = int(cfg["taps"])
        self.geometry = roofline.geometry(cfg)
        s_impulse, s_input, s_check = inputs.sub_seeds(seed, 3)
        self.input_seed = s_input
        self.check_rng = np.random.default_rng(s_check)
        self.impulse = inputs.impulse(
            s_impulse, self.channels, self.taps, float(cfg["impulse"]["tau"]),
            float(cfg["impulse"]["scale"]), device)
        self.sp = None
        self.state: dict = {}
        self.tracing = False
        self.window: Optional[Window] = None
        self.trace: Optional[devtrace.TraceSummary] = None
        self.setup_s = float("nan")

    def span(self, name: str):
        return devtrace.span(name) if self.tracing else _NULL


def engine_config(cfg: dict, wav: str, overrides: dict):
    from bfir_tpu_torch.core.spec import (ChainSpec, EngineConfig,
                                          FilterSpec, ImpulseFileSpec)

    e = {**cfg["engine"], **overrides}
    fspec = FilterSpec(e.pop("block_length"), dtype=e.pop("dtype"))
    files = (ImpulseFileSpec(enabled=True, filename=wav), ImpulseFileSpec(),
             ImpulseFileSpec())
    return EngineConfig(filter=fspec, chain=ChainSpec(files=files), **e)


def traces(cell: Cell, trace: int) -> bool:
    """Whether a run traces a slice of its traffic after the window: with
    ``--trace 1``, and in every run of a cell with an end-to-end metric read
    from the device trace."""
    return bool(trace) or any(m["source"] == "device_trace"
                              for m in cell.end_to_end)


def card_line() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return smi.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the control (the cell's lower-precision "
                        "stand-in) instead of the program as configured")
    return p.parse_args(argv)


def _metrics(run: Run, catalog: Catalog, entries) -> dict:
    out = {}
    for m in entries:
        value = catalog.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(args, catalog: Catalog, t_start: float, plant=None,
             device: str = "cuda"):
    """One run; returns the result dict, or None after a refusal (logged).
    ``plant``: called with the ``Run`` after set-up, and ``device`` "cpu"
    in place of the card: both for the harness's tests."""
    import torch

    cell = catalog.cell(args.workload)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            log("portbench: CUDA is not available; no result")
            return None
        if torch.cuda.device_count() < cell.chips:
            log(f"portbench: {cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} visible; no result")
            return None
        torch.cuda.init()
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        return _run(args, catalog, cell, device, tmp, t_start, plant)


def _run(args, catalog, cell, device, tmp, t_start, plant):
    import torch

    cuda = device.type == "cuda"
    driver = catalog.driver(cell.traffic["loop"])
    stamp = [time.perf_counter()]

    def phase(what):
        now = time.perf_counter()
        log(f"setup: {what} {now - stamp[0]:.3f} s")
        stamp[0] = now

    phase("imports and CUDA init (since process start: "
          f"{time.perf_counter() - t_start:.3f} s)")
    run = Run(cell, args.seed, device)
    phase("impulse")
    from bfir_tpu_torch.engine.cache import ArtifactCache
    from bfir_tpu_torch.engine.session import StreamProcessor
    from bfir_tpu_torch.utils.logging import set_print_callback

    phase("program import")
    set_print_callback(lambda msg: log(
        f"program +{time.perf_counter() - t_start:.3f} s: {msg}"))
    wav = os.path.join(tmp, "impulse.wav")
    inputs.write_wav(wav, run.impulse, run.rate)
    phase("impulse file")
    over = cell.config["control_engine"] if args.control else {}
    run.sp = StreamProcessor(engine_config(cell.config, wav, over),
                             ArtifactCache(os.path.join(tmp, "cache")),
                             device=device)
    driver.prepare(run)
    phase("input")
    driver.warm(run)
    phase("first calls (build, self-check) and warm-up")
    if cuda:
        torch.cuda.synchronize()
    # what set-up made stays out of the collector's passes in the window
    gc.collect()
    gc.freeze()
    log(f"program engine: {getattr(run.sp, '_impl', '?')}, "
        f"{getattr(run.sp, '_nuspec', '?')}")
    if plant is not None:
        plant(run)
    run.window = driver.window(run, args.seconds)
    run.setup_s = run.window.t0 - t_start
    log(f"window: {run.window.calls} calls, {run.window.frames} frames, "
        f"{run.window.seconds:.4f} s; setup {run.setup_s:.3f} s")
    if traces(cell, args.trace):
        if cuda:
            def spanned():
                run.tracing = True
                try:
                    return driver.traced(run)
                finally:
                    run.tracing = False

            run.trace = devtrace.trace_slice(lambda: driver.traced(run))
            log(f"trace: {run.trace}")
            if args.trace:
                gaps = devtrace.trace_slice(spanned, host_ops=True)
                log(f"trace with host ops: {gaps}")
                run.trace.idle_gaps = gaps.idle_gaps
        else:
            log("trace: no device trace without CUDA")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    if args.trace and run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
    if cuda:
        log(f"card: {card_line()}")
    metrics = _metrics(run, catalog,
                       cell.per_layer if args.trace else cell.end_to_end)
    segments = driver.segments(run)
    run.sp = None  # the program's state goes before the reference runs
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = {"rel_err": check.rel_err(segments, run.impulse),
              "failed": run.window.failed}
    late = late_pct(run.window, run.n / run.rate)
    if late is not None:
        values["late_pct"] = late
    ok, table = check.verdict(values, cell.limits)
    log(f"check: {len(segments)} stretches, "
        f"{sum(s.out.shape[1] for s in segments)} frames a channel, "
        f"{time.perf_counter() - t_check:.3f} s")
    result = {"correct": ok, "attempted": run.window.calls,
              "failed": run.window.failed, "metrics": metrics,
              "device": device_info}
    if args.trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["check"] = table
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    result = run_cell(args, Catalog(), t_start)
    if result is None:
        return 2
    bad = forbidden_modules(sys.modules)
    if bad:
        log(f"portbench: the run loaded {', '.join(bad)}; no result")
        return 3
    for name, row in result["check"].items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
