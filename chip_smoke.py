#!/usr/bin/env python3
"""Smoke test of bfir_tpu_torch on one CUDA GPU, at the flagship geometry.

Run from the root of the repository, on a machine with an NVIDIA Hopper
GPU and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. preflight: the card's name and power limit; refuses to run without CUDA;
2. build: compiles the kernels from ``bfir_tpu_torch/csrc`` (nvcc);
3. kernels: each of K1-K4 against its plain PyTorch version on the card,
   at the two-stage engine's shapes (64 channels, N = 1024, M = 8192), with
   the max error, and the device time per call (torch.profiler) and the
   CUDA-event median of kernel and plain;
4. session A: a 64-channel x 131072-tap impulse WAV streamed through
   ``StreamProcessor(..., device="cuda").process`` in uneven chunks; the
   two-stage engine with the int24 tail; worst-channel SNR against scipy;
5. session B: a mono impulse (shared planes) with the float32 tail; SNR,
   ``process_buffer`` against ``process``, and a mid-stream
   ``reconfigure`` that converges to the new filter.

Launch counters are zeroed just before session A and read after session B;
every kernel must have run on that path. The last two lines are a JSON
object describing the kernels and the ``{"ok": true, ...}`` result.
"""

import json
import os
import shutil
import subprocess
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "smoke")
C = 64            # channels
N = 1024          # block length
TAPS = 131072     # impulse length: P = 128 partitions
MIN_SNR_DB = 110.0
REL_TOL = 1e-5    # kernel vs plain: float32 sums in another order
DEVICE = "cuda"
# kernel -> (its CUDA source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "mac_hc": ("bfir_tpu_torch/csrc/mac_hc.cu",
               "bfir_tpu/kernels/spectrum_mac.py:436"),
    "mac_hc_tiled": ("bfir_tpu_torch/csrc/mac_hc.cu",
                     "bfir_tpu/kernels/spectrum_mac.py:508"),
    "mac_hc_tiled_int": ("bfir_tpu_torch/csrc/mac_hc.cu",
                         "bfir_tpu/kernels/spectrum_mac.py:758"),
    "irfft_split_hc_tail_balanced": ("bfir_tpu_torch/csrc/irfft_hc_tail.cu",
                                     "bfir_tpu/kernels/fft_fused.py:340"),
}


def log(msg):
    print(msg, flush=True)


def preflight():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this test needs "
                         "a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        raise SystemExit(f"chip_smoke: nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build():
    from bfir_tpu_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.load()
    log(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(os.path.basename(s) for s in cuda_lib.sources())})")


def _device_ms(fn, reps=20):
    """Device time (ms) per call of fn: the summed durations of the GPU
    work it launches, from torch.profiler, over ``reps`` calls. A host
    clock or events around one launch would also count the Python
    wrapper's launch latency, which exceeds the small kernels' run time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise SystemExit("chip_smoke: the profiler recorded no device time")
    return us / reps / 1e3


def _event_ms(fn, reps=20):
    """Median CUDA-event time (ms) of single calls of fn: device time plus
    whatever launch latency the host adds between the two events."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _time_pair(name, variant, kernel, plain):
    """Device ms per call of the kernel and of its plain version (logged
    beside their CUDA-event medians)."""
    ms = (_device_ms(kernel), _device_ms(plain))
    ev = (_event_ms(kernel), _event_ms(plain))
    log(f"kernel {name} [{variant}]: device {ms[0]:.4f} ms, plain "
        f"{ms[1]:.4f} ms per call (profiler, 20 calls); CUDA-event median "
        f"{ev[0]:.4f} ms, plain {ev[1]:.4f} ms")
    return ms


def _err(got, ref):
    import torch

    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    ab = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return ab, ab / scale


def check_kernels():
    """Each kernel against its plain version on the card. Returns
    {name: (max_abs_err, ms, plain_ms)}; launches here are not counted."""
    import torch

    from bfir_tpu_torch.kernels import fft_fused as FF
    from bfir_tpu_torch.kernels import spectrum_mac as K

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)

    def rn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    ph, pt, hh, ht = 16, 14, N, 8 * N  # head / tail partitions and widths
    out = {}

    def run(name, variant, kernel, plain, timed):
        ab, rel = _err(kernel(), plain())
        log(f"kernel {name} [{variant}]: max_abs_err {ab:.3e} "
            f"(rel {rel:.2e})")
        if not rel <= REL_TOL:
            raise SystemExit(f"chip_smoke: {name} [{variant}] disagrees with "
                             f"its plain version: rel err {rel:.2e}")
        prev = out.get(name, (0.0, None, None))
        ms = prev[1:]
        if timed:
            ms = _time_pair(name, variant, kernel, plain)
        out[name] = (max(prev[0], ab), *ms)

    for cs in (C, 1):
        ring, coeff = rn(ph, 2 * C, hh), rn(ph, 2 * cs, hh)
        run("mac_hc", f"f32, coeff rows {2 * cs}",
            lambda: K.mac_hc(ring, coeff, 5),
            lambda: K.mac_hc_plain(ring, coeff, 5), cs == C)
    for dt in (torch.float32, torch.bfloat16):
        for cs in (C, 1):
            ring, coeff = rn(pt, 2 * C, ht).to(dt), rn(pt, 2 * cs, ht).to(dt)
            run("mac_hc_tiled", f"{dt}, coeff rows {2 * cs}",
                lambda: K.mac_hc_tiled(ring, coeff, 3),
                lambda: K.mac_hc_plain(ring, coeff, 3),
                cs == C and dt == torch.float32)
    for bits in (24, 16):
        for cs in (C, 1):
            ring = K.quantize_planes(rn(pt, 2 * C, ht), bits)
            coeff = K.quantize_planes(rn(pt, 2 * cs, ht), bits)
            run("mac_hc_tiled_int", f"int{bits}, coeff rows {2 * cs}",
                lambda: K.mac_hc_tiled_int(ring, coeff, 9),
                lambda: K.mac_reference_hc_int(ring, coeff, 9),
                cs == C and bits == 24)
    hr, hi = rn(C, ht), rn(C, ht)
    run("irfft_split_hc_tail_balanced", f"[{C}, {ht}]",
        lambda: FF.irfft_split_hc_tail_balanced(hr, hi, 2 * ht),
        lambda: FF.irfft_split_hc_tail_plain(hr, hi, 2 * ht), True)
    return out


def _impulse(seed, rows):
    """A decaying-noise room response, unit energy per row, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(TAPS)
    h = rng.standard_normal((rows, TAPS)) * np.exp(-t / 16384.0)
    h /= np.sqrt((h ** 2).sum(axis=1, keepdims=True))
    return (0.5 * h).astype(np.float32)


def _write_wav(name, h):
    from bfir_tpu.io import wavio

    path = os.path.join(WORK, name)
    wavio.write(path, h.T, 44100, subtype="float32")
    return path


def _config(path, tail_store="auto"):
    from bfir_tpu.core.spec import (ChainSpec, EngineConfig, FilterSpec,
                                    ImpulseFileSpec)

    files = (ImpulseFileSpec(enabled=True, filename=path), ImpulseFileSpec(),
             ImpulseFileSpec())
    return EngineConfig(filter=FilterSpec(N, dtype="float32"),
                        chain=ChainSpec(files=files), nu_tail_store=tail_store)


def _worst_snr_db(y, x, h):
    """Worst-channel SNR (dB) of y against scipy's float64 convolution of
    the stream x with impulse rows h (one row: shared by all channels)."""
    from scipy import signal

    worst = np.inf
    for c in range(y.shape[0]):
        hh = h[0] if h.shape[0] == 1 else h[c]
        ref = signal.fftconvolve(x[c].astype(np.float64),
                                 hh.astype(np.float64))[: y.shape[1]]
        err = float(((y[c] - ref) ** 2).sum())
        worst = min(worst, 10 * np.log10(float((ref ** 2).sum())
                                         / max(err, 1e-300)))
    return worst


def _stream(sp, x, chunks):
    """Feed x [C, T] through sp.process in chunks of the given sizes (the
    rest in one final chunk); returns the concatenated output."""
    outs, a = [], 0
    for size in list(chunks) + [x.shape[1]]:
        b = min(a + size, x.shape[1])
        outs.append(sp.process(x[:, a:b]))
        a = b
        if a == x.shape[1]:
            break
    return np.concatenate(outs, axis=1)


def _timed_blocks(sp, x, what):
    """Wall ms per block of process() over the 64-block chunks x[:3]
    (median), then one profiled call over x[3] for the device-busy share.
    Returns (ms per block, outputs)."""
    times, outs = [], []
    for chunk in x[:3]:
        t0 = time.perf_counter()
        outs.append(sp.process(chunk))
        times.append((time.perf_counter() - t0) * 1e3 / (chunk.shape[1] // N))
    wall, busy, y = _device_busy(sp, x[3])
    outs.append(y)
    ms = float(np.median(times))
    log(f"{what}: process() {ms:.4f} ms/block (wall, 64-block calls, median "
        f"of 3, C={C}, N={N}, {TAPS} taps); profiled call: device busy "
        f"{busy:.3f} of {wall:.3f} ms wall ({100 * busy / wall:.1f}%)")
    return ms, outs


def _device_busy(sp, x):
    """One profiled process() call over x: (wall ms, device-busy ms), the
    busy time summed over the GPU work (kernels and copies) it ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        y = sp.process(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    return wall, busy, y


def _counts():
    from bfir_tpu_torch.kernels import fft_fused as FF
    from bfir_tpu_torch.kernels import spectrum_mac as K

    return {"mac_hc": K.mac_hc.launches,
            "mac_hc_tiled": K.mac_hc_tiled.launches,
            "mac_hc_tiled_int": K.mac_hc_tiled_int.launches,
            "irfft_split_hc_tail_balanced":
                FF.irfft_split_hc_tail_balanced.launches}


def _require_advanced(before, after, names, what):
    for name in names:
        if after[name] <= before[name]:
            raise SystemExit(f"chip_smoke: {what} did not launch {name}")
    log(f"{what}: launches " + ", ".join(
        f"{k} {after[k] - before[k]}" for k in after))


def _snr_gate(snr, what):
    log(f"{what}: worst-channel SNR vs scipy float64 {snr:.1f} dB "
        f"(bound {MIN_SNR_DB:.0f})")
    if not snr >= MIN_SNR_DB:
        raise SystemExit(f"chip_smoke: {what} SNR {snr:.1f} dB < "
                         f"{MIN_SNR_DB:.0f}")


def session_a(cache):
    from bfir_tpu_torch.engine.session import StreamProcessor

    h = _impulse(1, C)
    sp = StreamProcessor(_config(_write_wav("a.wav", h)), cache, device=DEVICE)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((C, 80 * N + 333)).astype(np.float32)
    t0 = time.perf_counter()
    y = _stream(sp, x, [1000, 37, 20000, 4567])
    log(f"session A: first process() calls incl. build and self-check "
        f"{time.perf_counter() - t0:.1f} s, {y.shape[1] // N} blocks")
    if sp._impl != "nonuniform":
        raise SystemExit(f"chip_smoke: session A engine {sp._impl!r}")
    if sp._nuspec.tail_store != "int24":
        raise SystemExit(f"chip_smoke: session A tail store "
                         f"{sp._nuspec.tail_store!r}")
    log(f"session A: engine nonuniform, {sp._nuspec}")
    more = rng.standard_normal((4, C, 64 * N)).astype(np.float32)
    ms, ys = _timed_blocks(sp, more, "session A (int24 tail)")
    xs = np.concatenate([x[:, :y.shape[1] + 333], *more], axis=1)
    ys = np.concatenate([y, *ys], axis=1)
    _snr_gate(_worst_snr_db(ys, xs, h), "session A")
    return ms


def session_b(cache):
    from bfir_tpu_torch.engine.session import StreamProcessor

    h = _impulse(3, 1)
    sp = StreamProcessor(_config(_write_wav("b.wav", h), "float32"), cache,
                         device=DEVICE)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((C, 72 * N + 500)).astype(np.float32)
    y = _stream(sp, x, [777, 5000, 30000])
    if sp._impl != "nonuniform" or sp._nuspec.tail_store != "float32":
        raise SystemExit(f"chip_smoke: session B engine {sp._impl!r} "
                         f"{sp._nuspec}")
    if sp._coeffs.head.shape[1] != 2:
        raise SystemExit("chip_smoke: session B did not build shared planes")
    log(f"session B: engine nonuniform, shared planes, {sp._nuspec}")
    more = rng.standard_normal((4, C, 64 * N)).astype(np.float32)
    ms, ys = _timed_blocks(sp, more, "session B (float32 tail, shared)")
    xs = np.concatenate([x[:, :y.shape[1] + 500], *more], axis=1)
    ys = np.concatenate([y, *ys], axis=1)
    _snr_gate(_worst_snr_db(ys, xs, h), "session B")

    # process_buffer on M-cycle-aligned input == process from the same state
    sp.reset()
    aligned = 64 * N
    yb = sp.process_buffer(x[:, :aligned])
    diff = float(np.abs(yb - y[:, :aligned]).max())
    log(f"session B: process_buffer vs process max abs diff {diff:.3e}")
    if not diff <= REL_TOL * float(np.abs(y[:, :aligned]).max()):
        raise SystemExit("chip_smoke: process_buffer disagrees with process")

    # mid-stream reconfigure converges to the new filter
    h2 = _impulse(5, 1)
    pre = rng.standard_normal((C, 3 * N + 100)).astype(np.float32)
    y_pre = sp.process(pre)
    sp.reconfigure(_config(_write_wav("b2.wav", h2), "float32"))
    if sp._pending_swap is None:
        raise SystemExit("chip_smoke: reconfigure did not queue a crossfade")
    nu = sp._nuspec
    settle = (nu.ratio * (nu.delay_blocks + 2) + nu.p_head) * N
    x2 = rng.standard_normal((C, settle + 32 * N)).astype(np.float32)
    y2 = sp.process(x2)
    if sp._nu_old is not None:
        raise SystemExit("chip_smoke: the crossfade did not complete")
    full = np.concatenate([x[:, :aligned], pre, x2], axis=1)
    t0 = aligned + y_pre.shape[1]
    ref_len = t0 + y2.shape[1]
    from scipy import signal

    worst = np.inf
    for c in range(C):
        ref = signal.fftconvolve(full[c].astype(np.float64),
                                 h2[0].astype(np.float64))[t0:ref_len]
        err = float(((y2[c, settle:] - ref[settle:]) ** 2).sum())
        worst = min(worst, 10 * np.log10(float((ref[settle:] ** 2).sum())
                                         / max(err, 1e-300)))
    _snr_gate(worst, "session B after reconfigure (past the settle span)")
    return ms


def main():
    preflight()
    from bfir_tpu.engine.cache import ArtifactCache

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    build()
    kernels = check_kernels()

    from bfir_tpu_torch.kernels import fft_fused as FF
    from bfir_tpu_torch.kernels import spectrum_mac as K

    for fn in (K.mac_hc, K.mac_hc_tiled, K.mac_hc_tiled_int,
               FF.irfft_split_hc_tail_balanced):
        fn.launches = 0  # count only the main path from here on
    cache = ArtifactCache(os.path.join(WORK, "profile"))
    c0 = _counts()
    session_a(cache)
    c1 = _counts()
    _require_advanced(c0, c1, ("mac_hc", "mac_hc_tiled_int",
                               "irfft_split_hc_tail_balanced"), "session A")
    session_b(cache)
    c2 = _counts()
    _require_advanced(c1, c2, ("mac_hc", "mac_hc_tiled",
                               "irfft_split_hc_tail_balanced"), "session B")
    for name, n in c2.items():
        if n == 0:
            raise SystemExit(f"chip_smoke: {name} never ran on the main path")

    rows = []
    for name, (err, ms, plain_ms) in kernels.items():
        src, rep = KERNEL_SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": c2[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    import torch

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
