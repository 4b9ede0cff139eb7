"""Offline render CLI: filter a WAV through a configured chain.

    python -m bfir_tpu_torch.cli.render in.wav out.wav \\
        [--impulse ir.wav [--impulse-level DB]] ... \\
        [--eq "b0,b1,...,b30" --eq-level DB] \\
        [--block 1024] [--dtype float64] [--out-format pcm24 [--dither]] \\
        [--delay 0,100 [--subdelay 0,8]] [--auto-attenuate] [--serve PORT] \\
        [--device cuda | --cpu]

Counterpart of ``bfir_tpu/cli/render.py``: the input goes through
``StreamProcessor.render`` (the bulk engine, core/bulk.py; the streaming
engine's ``process_buffer`` when a delay line is configured or the engine
is ``extended``) and the exact T filtered frames are written. The default
device is CUDA; ``--cpu`` is ``--device cpu``. Integer output formats are
rounded and clipped; with ``--dither`` they go through the output stage
first (hp-TPDF dither and error feedback in float64, a fresh dither state
over the whole render). The default ``--dtype`` is float64, as in the
reference: on CUDA the ``auto`` engine mode then takes ``extended`` (native
float64), on the CPU the ``complex`` engine. ``--auto-attenuate`` runs the
white-noise headroom probe (``ops.noise``) on the device for each impulse
file and prints the level it applies; ``--serve PORT`` runs the TCP control
server during the render, its changes crossfading into the running session.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from bfir_tpu_torch.cli.server import ControlServer
from bfir_tpu_torch.cli.store import ConfigStore
from bfir_tpu_torch.core.spec import (LEVEL_STEPS_PER_DB, ChainSpec,
                                      DelaySpec, EngineConfig, EqSpec,
                                      FilterSpec, ImpulseFileSpec,
                                      SampleFormat, StreamSpec)
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.ops import dither as dth
from bfir_tpu_torch.ops import formats as fm
from bfir_tpu_torch.ops.noise import calculate_attenuation

_SUBTYPE_FOR_FORMAT = {
    "pcm16": (SampleFormat.S16_LE, "pcm16"),
    "pcm24": (SampleFormat.S24_LE, "pcm24"),
    "pcm32": (SampleFormat.S32_LE, "pcm32"),
    "float32": (SampleFormat.FLOAT_LE, "float32"),
    "float64": (SampleFormat.FLOAT64_LE, "float64"),
}

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bfir-torch-render", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--impulse", action="append", default=[],
                   help="impulse WAV (repeat up to 3x)")
    p.add_argument("--impulse-level", action="append", type=float, default=[],
                   help="level dB for the matching --impulse")
    p.add_argument("--eq", help="31 comma-separated band gains in dB")
    p.add_argument("--eq-level", type=float, default=0.0)
    p.add_argument("--block", type=int, default=1024)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float64")
    p.add_argument("--out-format", choices=sorted(_SUBTYPE_FOR_FORMAT),
                   default="float32")
    p.add_argument("--resample", action="store_true",
                   help="resample impulse files whose rate differs from the "
                        "input")
    p.add_argument("--engine-mode",
                   choices=["auto", "complex", "packed", "hc", "nonuniform",
                            "nonuniform_split", "nonuniform3", "extended",
                            "sharded"],
                   default="auto",
                   help="streaming engine the session builds beside the "
                        "bulk render engine (default auto: extended for "
                        "float64 on CUDA; sharded over every visible "
                        "device of --device)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    p.add_argument("--dither", action="store_true",
                   help="hp-TPDF dither + error feedback for integer output "
                        "formats")
    p.add_argument("--auto-attenuate", action="store_true",
                   help="apply the white-noise headroom probe to each impulse")
    p.add_argument("--serve", type=int, metavar="PORT", default=None,
                   help="run the TCP control server on PORT during rendering "
                        "(same protocol as the reference plugin)")
    p.add_argument("--delay", metavar="SAMPLES[,SAMPLES...]",
                   help="per-channel output delay in samples (one value "
                        "broadcasts to all channels; delay.cpp:495-600)")
    p.add_argument("--subdelay", metavar="STEPS[,STEPS...]",
                   help="per-channel fractional delay in 1/16-sample steps "
                        "(+-15), through the Kaiser-sinc interpolator bank "
                        "(delay.cpp:182-306; adds 16 samples of latency)")
    return p


def config_from_args(args) -> EngineConfig:
    files = []
    for i, path in enumerate(args.impulse[:3]):
        level_db = args.impulse_level[i] if i < len(args.impulse_level) else 0.0
        files.append(ImpulseFileSpec(enabled=True, filename=path,
                                     level_steps=int(round(level_db * 10)),
                                     resample=args.resample))
    while len(files) < 3:
        files.append(ImpulseFileSpec())
    eq = EqSpec()
    if args.eq:
        mags = [int(round(float(v) * 10)) for v in args.eq.split(",")]
        if len(mags) != 31:
            raise SystemExit(f"--eq needs 31 values, got {len(mags)}")
        eq = EqSpec(enabled=True, mag_steps=tuple(mags),
                    level_steps=int(round(args.eq_level * 10)))
    out_fmt, _ = _SUBTYPE_FOR_FORMAT[args.out_format]
    delay = DelaySpec()
    if args.delay or args.subdelay:
        samples = (tuple(int(v) for v in args.delay.split(","))
                   if args.delay else (0,))
        substeps = (tuple(int(v) for v in args.subdelay.split(","))
                    if args.subdelay else (0,))
        delay = DelaySpec(enabled=True, samples=samples,
                          subsample_steps=substeps)
    return EngineConfig(
        filter=FilterSpec(block_length=args.block, n_partitions=1,
                          dtype=args.dtype),
        stream=StreamSpec(out_format=out_fmt, apply_dither=args.dither),
        chain=ChainSpec(eq=eq, files=tuple(files)),
        delay=delay,
        engine_mode=args.engine_mode,
    )


def dither_output(y: np.ndarray, fmt: SampleFormat, device) -> np.ndarray:
    """The output stage with a fresh dither state over a whole render
    ``y`` [C, T], in float64 on ``device``; returns the quantized samples
    at +-1 full scale (they round-trip exactly through the WAV writer)."""
    c = y.shape[0]
    dst = dth.init_dither_state(c, dtype=torch.float64, device=device)
    of = dth.init_overflow_stats(c, dtype=torch.float64, device=device)
    q, of, _ = fm.output_stage(
        torch.from_numpy(np.ascontiguousarray(y, dtype=np.float64)).to(device),
        fmt, of, dst)
    n_clipped = int(of.n_overflows.sum())
    if n_clipped:
        print(f"warning: {n_clipped} samples clipped during dither",
              file=sys.stderr)
    return q.cpu().numpy().astype(np.float64) / fmt.full_scale


def auto_attenuate(cfg: EngineConfig, device) -> EngineConfig:
    """Each enabled impulse file's level lowered by the noise probe's
    attenuation (run on ``device``), as the reference CLI does; prints the
    level applied."""
    files = []
    for f in cfg.chain.files:
        if f.enabled and f.filename:
            imp, _ = wavio.read(f.filename)
            att = calculate_attenuation(imp.T,
                                        block_length=cfg.filter.block_length,
                                        dtype=cfg.filter.dtype, device=device)
            steps = int(att * LEVEL_STEPS_PER_DB)
            print(f"auto-attenuate: {f.filename}: {att!r} dB, level "
                  f"{steps} steps")
            f = dataclasses.replace(f, level_steps=f.level_steps + steps)
        files.append(f)
    return dataclasses.replace(
        cfg, chain=dataclasses.replace(cfg.chain, files=tuple(files)))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else args.device
    cfg = config_from_args(args)
    audio, rate = wavio.read(args.input)
    if args.auto_attenuate:
        cfg = auto_attenuate(cfg, device)
    sp = StreamProcessor(cfg, device=device)
    server = None
    if args.serve is not None:
        store = ConfigStore(cfg, on_change=sp.reconfigure, device=device)
        server = ControlServer(store, port=args.serve)
        server.start()
    x = audio.T  # [C, T]
    try:
        y = sp.render(x, sample_rate=rate)
    finally:
        if server is not None:
            server.stop()
    if not sp._active:
        print("no chain configured; passing through", file=sys.stderr)
    out_fmt, subtype = _SUBTYPE_FOR_FORMAT[args.out_format]
    if args.dither and not out_fmt.isfloat:
        y = dither_output(y, out_fmt, sp.device)
    wavio.write(args.output, y.T, rate, subtype=subtype)
    of = sp.overflow_stats()
    if of is not None and int(of.n_overflows.sum()) > 0:
        print(f"warning: {int(of.n_overflows.sum())} overflowed samples",
              file=sys.stderr)
    print(f"rendered {x.shape[1]} frames x {x.shape[0]} ch @ {rate} Hz -> "
          f"{args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
