#!/usr/bin/env python3
"""Smoke test of bfir_tpu_torch on one CUDA GPU, at the flagship geometry.

Run from the root of the repository, on a machine with an NVIDIA Hopper
GPU and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. preflight: the card's name and power limit; refuses to run without CUDA;
2. build: compiles the kernels from ``bfir_tpu_torch/csrc`` (one nvcc per
   source, side by side);
3. kernels: each of K1-K18 against its plain PyTorch version on the card,
   at the shapes its path gives it (64 channels, N = 1024, M = 8192, G = 8,
   the packed ring [128, 128, 1152] over its 1025 live lanes, the
   requantizer [64, 1024]), with the
   max error, the device time per call (torch.profiler) of kernel, plain
   version and, where one exists, the one PyTorch call computing the same
   function, and the least time the card could take (bytes over 3.35 TB/s
   or flops over 67 TFLOP/s float32, the larger); K9 must equal its plain
   version bit for bit, also at [64, 65536], [64, 20000] and (ragged)
   [65, 1001] against the plain loop on the CPU, and is timed in float32
   and float64 beside the latency of its serial chain (the operations of
   its SASS loop, each timed on the card by ``csrc/chain_latency.cu``),
   its plain version timed after every path (the trace of its 25602
   launches makes later traces lose events); K9's and K12's ptxas reports are logged and K9's SASS is written to
   ``build/smoke/quantize_kernel.sass``;
4. session A: a 64-channel x 131072-tap impulse WAV streamed through
   ``StreamProcessor(..., device="cuda").process`` in uneven chunks; the
   two-stage engine with the int24 tail; worst-channel SNR against scipy;
5. session B: a mono impulse (shared planes) with the float32 tail; SNR,
   ``process_buffer`` against ``process``, and a mid-stream
   ``reconfigure`` that converges to the new filter;
6. session C: ``engine_mode="nonuniform_split"`` streaming (int24 tail):
   SNR, ms/block, and the wall time per phase of the M-cycle;
7. session D: ``StreamProcessor.render`` over three dispatches (589 824
   frames): the G-batch bulk scan; SNR and M samples/s;
8. two further renders: ``BulkRenderer(..., nu_engine="split")`` at the
   flagship, and a 16384-tap filter through the batch engine;
9. the render CLI as a user runs it: ``python -m bfir_tpu_torch.cli.render``
   in a subprocess on a 2-channel WAV and a 131072-tap impulse WAV at
   ``--dtype float32``; SNR;
10. session E: raw S24 bytes through ``StreamProcessor.process_raw`` with
    the packed engine (K8), per-channel delays 7 c and hp-TPDF dither (K9):
    (a) float output against scipy shifted by the delays, (b) the dithered
    S24 output within 5 LSB plus (a)'s error and 0.5-1.5 LSB RMS, (c) a
    live reconfigure with new delays (a K8 crossfade, no rebuild), (d)
    ``FractionalDelayLine`` on the card against its CPU run; ms per block by
    phase (decode, engine, output stage, encode) and the device-busy share;
    the codec phase: the native host codec (``formats.decode``,
    ``encode_int``) equal byte for byte to the numpy one
    (``decode_plain``, ``encode_int_plain``) on session E's input and
    output bytes, and both timed per 1024-frame block in alternating
    rounds (the ``{"card": ..., "codec": ...}`` line before the kernel
    line); every gate decodes with the numpy codec;
11. session F: 160 blocks of seeded noise through ``step_split`` (K11),
    ``step_chunked`` with k = 4 (K10), ``step_hc2`` (K13) and
    ``step_hc_fused`` (K12), with ``step_hc`` (K1) beside them: SNR,
    the max difference from ``step_hc``, ms/block, kernels and copies per
    block and the device-busy share; the rings of ``step_hc2`` and
    ``step_hc_fused`` equal ``step_hc``'s bit for bit;
12. session G: 160 blocks of seeded noise through ``step_hc``'s data path
    (frame -> forward transform -> ring insert -> K1 -> inverse tail) with
    four transform pairs: (a) ``torch.fft`` (``step_hc`` itself, the
    yardstick), (b) K15 ``rfft_hc_fused`` + K16 ``irfft_hc_tail_fused``,
    (c) K18 ``rfft_hc_pallas`` + K17 ``irfft_hc_tail_pallas``, (d) K14
    through ``rfft_split_hc_balanced`` + K4; the same measurements as
    session F, against (a);
13. the render CLI again with ``--delay 0,100``, float32 and then
    ``--out-format pcm24 --dither``: gate (b) on the dithered WAV;
14. session H: the ``extended`` engine (native float64) at the flagship,
    ``filter.dtype="float64"``, ``engine_mode="auto"``: (a) 288 blocks
    streamed: wall and device ms/block, kernels and copies per block, busy
    share, peak device memory, worst-channel SNR >= 240 dB against scipy;
    (b) a live crossfade ``reconfigure``: the ramp block is the linear
    blend of the two filters' outputs, then the new filter alone; (c) S24
    in, dithered S24 out through ``process_raw`` at float64 (K9), gate (b)
    of session E; (d) ``render`` through ``process_buffer``, T frames, no
    K7 launch, >= 240 dB;
15. session I: the servers at the flagship (float32, auto: the
    nonuniform engine): one ``ConfigStore``, a ``ControlServer`` and an
    ``AudioServer`` on the card, two clients streaming 5 s of 64-channel
    FLOAT_LE at once in frames of 4096 frames; between two frames a control
    client sets a second impulse (``F1FN``, the attenuation probe on the
    card) and ``EQM0 50``; each client's output before the change and, past
    the settle span, after it against scipy; round trip per frame (p50,
    p99), frames/s and the probe's seconds;
16. session J: the three-stage engine at 64 ch x 655 360 taps (640
    partitions, where ``auto`` takes ``nonuniform3``), float32: (a) 960
    blocks streamed (uneven chunks, 64-block calls, then two super-cycles
    one block a call): SNR, wall and device ms/block, kernels and copies
    per block, busy share, peak device memory, the far-fire block's wall
    against its super-cycle's mean; (b) the same impulse and input
    through ``engine_mode="nonuniform"`` (auto's int24 tail), the other
    side of auto's choice; (c) ``process_buffer`` over two aligned
    super-cycles equal to ``process``; (d) a live ``reconfigure``: the
    staged transition in place (no rebuild), complete within a
    super-cycle, the last 32 of 560 blocks >= 110 dB against the new
    filter;
17. session K: the sharded engine (``engine_mode="sharded"``) at the
    flagship through ``StreamProcessor(..., mesh=...)``, the mesh's shards
    repeated on the one card: (a) a (1, 4) mesh, auto -> the two-stage
    local engine (head 16, tail 14 padded to 16; K1 per shard every
    block, K2 per shard + K4 every 8th): 288 blocks in uneven chunks and
    four 64-block calls, SNR, the max difference from single-device
    ``nonuniform`` (float32 tail) on the same input, wall and device
    ms/block, kernels and copies per block, busy share, peak memory, and
    the collective counter against the comm model (one ppermute and one
    psum per stage fire, 2·(C/c)·Hp·4 bytes each: 524 288 B a block and
    4 194 304 B each at every 8th; a mismatch fails); (b) the same on a
    (2, 2) mesh; (c) ``sharded_local="uniform"`` (hc local, K1) at (1,
    4); (d), a path of its own: ``sharded_local="nonuniform3"`` at session
    J's geometry through J's ``_long_stream`` (many far fires), the same
    gates; (e) a live reconfigure on (a), converged past the settle span;
    (f) ``process_buffer`` equal to ``process``; (g) ``mesh=None``, the
    default mesh over every visible GPU; then, after every path, (a)'s
    ``process()`` against single-device ``nonuniform`` and the sharded
    engines' macro steps against their step loops in 8 alternating
    rounds of 64 blocks;
18. session L: the sharded engine on meshes that span two processes: two
    worker processes (``session_l_worker``) join one gloo group through
    ``parallel.mesh.init_distributed``, each owning two shards on the one
    card, and run at the flagship (a) the two-stage local engine on a (1,
    4) and a (2, 2) mesh, (b) the hc local engine at (1, 4), (c)
    nonuniform3 at session J's 655 360 taps at (1, 4), 320 blocks each
    (128 one step a call, 192 through ``process_blocks``); each rank's
    collectives against the comm model, both ranks' outputs equal, SNR
    against scipy, the max relative difference from the one-process engine
    on the same mesh shape and input (<= 1e-6; bit-equality logged); each
    rank's wall and CUDA-event ms/block, peak memory and the bytes that
    crossed between the processes, beside the one-process engine's walls;
    where two cards or more are visible, (a) again under NCCL, one rank a
    card (else one line says it did not run); the workers' launch counts
    are this path's;
19. checkpoint: a complex-engine stream with K9's dither on the card,
    saved after 5 blocks (``engine.checkpoint``), loaded and resumed:
    outputs and dithered samples bit-equal to the uninterrupted run;
20. the render CLI at its default ``--dtype`` (float64: ``extended``)
    with ``--out-format float64``, >= 240 dB, and with ``--auto-attenuate``
    on a +12 dB impulse: output peak <= 1 and the level applied equal to
    the port's probe run on the card;
21. session M (after session L, a path of its own): (a)
    ``engine_mode="nonuniform_split"`` at N = 64, where the split
    schedule's bands do not fit and the session builds ``nonuniform``
    (int24 tail; head 16 x 64, tail 254 x 512), 64 ch x 131072 taps:
    about 2270 blocks in uneven chunks, 128-block calls and 32 M-cycles
    one block a call; worst channel >= 110 dB; wall ms/block in bulk and
    by phase in single-block calls against the 1.451 ms budget of a
    64-frame block at 44.1 kHz, launches a block, device ms/block (CUDA
    events over calls queued behind a spin kernel), peak memory; (b)
    ``ops/fft``'s ``fft``/``ifft`` along axis 0 at process_batch's [286,
    64, 1025] (padded to 512), ``cfft_split`` with ``cols``,
    ``fft0_split`` with ``rows``, ``ifft0_slice``, ``irfft_split_tail``
    and ``irfft_tail`` at [64, 2048] and [64, 16384], complex64 and
    complex128 against numpy float64 (<= 1e-5 and 1e-12 of the peak),
    device us a call; (c) ``BlockTimer.measure(state)`` waits for the card
    (p50 not below the CUDA-event span of the same calls) and
    ``utils.profiling.trace`` writes a trace; (d) ``step_nu(phase=)`` at 0
    and R - 1 equal to the counter's phase (<= 1e-6), each phase's
    CUDA-event ms a call.

Phase 3 also checks K4 at h = 1024, 8192 and 16384 on 64 and 129 rows of
planes with h and h + 128 lanes (timed at [64, 8192], logged at [64,
1024]), K10-K13 at the
flagship: K10 (k = 1, 4, 32) and K11 on the packed ring and coefficients
of K8's check, K12 and K13 on hc planes [128, 128, 1024] (K12 also with a
zero-padded basis, at Hp = 2048 and at 65 channels, untimed, with its
cooperative grid and split plans logged; K13's ring bit for bit), and
K2 also at session J's mid and far stages, [16, 128, 8192] and [8, 128,
65536] (times under "also"), K1 and K2 at session K's shard shapes at
ring position 0, [4, 128, 1024], [4, 128, 8192] and [2, 128, 65536]
(times under "also"), K1 and K3 at session M's head [16, 128, 128] and
int24 tail [254, 128, 512] (times under "also"), the FFT family K14-K18 timed at session G's
shape [64, 2048] (h = 1024)
beside ``torch.fft`` and at [64, 16384] (h = 8192): K15 and K18 at
h = 512, 1024, 8192 and 16384 on 64 and 129 rows, K14 in every mode
(forward, inverse, each tail-only) at h = 1024, 8192 and 16384 on 64 and
129 rows, K16 and K17 (K4's kernel) at every h they take on the card
(K17 512-16384, K16 1024-16384) on 64 and 129 rows and on lane-padded
planes (h + 128 lanes) on 64 rows, K17 also timed at [64, 1024] (h =
512).

The launch counters are zeroed just before each path (sessions A-K and
M, the two renders, the checkpoint; session L's in each worker process) and read
just after it; each path must have launched its kernels. The last two lines are a JSON object describing the card
(``nvidia-smi``'s name and power limit) and the kernels (K14-K18 with
their times at the tail shape as well, under "also": K14 at [64, 8192]
forward, the others at [64, 16384]; K2 at session J's two shapes and
session K's two shard shapes; K1 at session K's head shard and session
M's head; K3 at session M's tail), and the
``{"ok": true, ...}`` result. The line before them holds the card and
session E's codec numbers.
"""

import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "smoke")
C = 64            # channels
N = 1024          # block length
TAPS = 131072     # impulse length: P = 128 partitions
TAPS3 = 655360    # session J: P = 640, where auto takes the three-stage engine
N_M = 64          # session M: the block where nonuniform_split runs nonuniform
# session M's geometry at TAPS: head partitions, tail partitions, head and
# tail lanes (Hp = N_M rounded up to 128, and M = 8 N_M)
M_GEOM = (16, (TAPS - 16 * N_M) // (8 * N_M), 128, 8 * N_M)
MIN_SNR_DB = 110.0
# the extended (float64) engine's gate: a float64 overlap-save reads about
# 306 dB against scipy at small sizes; float32 engines read about 130
MIN_SNR64_DB = 240.0
REL_TOL = 1e-5    # kernel vs plain: float32 sums in another order
LSB24 = 2.0 ** -23  # one step of 24-bit output at +-1 full scale
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
CLOCK_HZ = 1.755e9         # H100 boost clock of the earlier estimates
# K9's serial chain from e0 to the next e0, as the SASS of csrc/dither_q.cu's
# loop shows it (dump_sass): operation -> how many, per sample
K9_CHAIN = {"float32": {"add": 5, "trunc": 1, "max": 2},
            "float64": {"add": 5, "trunc": 1, "select": 1}}
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
    "mac_hc_band": ("bfir_tpu_torch/csrc/mac_hc.cu",
                    "bfir_tpu/kernels/spectrum_mac.py:594"),
    "mac_hc_band_int": ("bfir_tpu_torch/csrc/mac_hc.cu",
                        "bfir_tpu/kernels/spectrum_mac.py:870"),
    "corr_mac": ("bfir_tpu_torch/csrc/corr_mac.cu",
                 "bfir_tpu/kernels/corr_mac.py:56"),
    "mac_packed": ("bfir_tpu_torch/csrc/mac_hc.cu",
                   "bfir_tpu/kernels/spectrum_mac.py:45"),
    "quantize_hp_tpdf": ("bfir_tpu_torch/csrc/dither_q.cu",
                         "bfir_tpu/kernels/dither_kernel.py:25"),
    "mac_chunked": ("bfir_tpu_torch/csrc/mac_variants.cu",
                    "bfir_tpu/kernels/spectrum_mac.py:113"),
    "mac_split": ("bfir_tpu_torch/csrc/mac_variants.cu",
                  "bfir_tpu/kernels/spectrum_mac.py:211"),
    "mac_tail_hc": ("bfir_tpu_torch/csrc/mac_tail_hc.cu",
                    "bfir_tpu/kernels/spectrum_mac.py:1016"),
    "mac_hc_insert": ("bfir_tpu_torch/csrc/mac_variants.cu",
                      "bfir_tpu/kernels/spectrum_mac.py:1101"),
    "cfft_balanced_fused": ("bfir_tpu_torch/csrc/fft_family.cu",
                            "bfir_tpu/kernels/fft_fused.py:340"),
    "rfft_hc_fused": ("bfir_tpu_torch/csrc/fft_family.cu",
                      "bfir_tpu/kernels/fft_fused.py:63"),
    "irfft_hc_tail_fused": ("bfir_tpu_torch/csrc/irfft_hc_tail.cu",
                            "bfir_tpu/kernels/fft_fused.py:215"),
    "irfft_hc_tail_pallas": ("bfir_tpu_torch/csrc/irfft_hc_tail.cu",
                             "bfir_tpu/kernels/fft_pallas.py:108"),
    "rfft_hc_pallas": ("bfir_tpu_torch/csrc/fft_family.cu",
                       "bfir_tpu/kernels/fft_pallas.py:226"),
}


def log(msg):
    print(msg, flush=True)


CARD = None  # nvidia-smi's "name, power.limit" of card 0, set by preflight


def preflight():
    global CARD
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this test needs "
                         "a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        raise SystemExit(f"chip_smoke: nvidia-smi failed: {smi.stderr}")
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
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


LEAD_CYCLES = 50_000_000  # a spin of about 25 ms at the H100's clocks
TRIES = 5  # traces taken at most before a timing gives up


def _traced(run):
    """(run(), the device events it caused, whether the trace is whole)
    from one torch.profiler trace. On the H100 the profiler loses device
    events at a trace's start in two ways: after one trace of tens of
    thousands of launches (K9's plain version) every later trace loses
    its first device event, and now and then the device clock reads
    milliseconds early, so that the events it places before the trace
    opened are dropped; a trace of that size, even alone in its process,
    now and then loses its last events. So the trace opens with a spin of
    about 25 ms and eight marker spin kernels, run() starts after them,
    and one more marker and a second 25 ms spin close it. The markers are
    left out of the events; the trace is whole when it holds events, a
    marker ends before the first and one starts after the last (a trace
    that is not is logged with the side it lacks)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(LEAD_CYCLES)
        for _ in range(8):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        y = run()
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spins = [e.time_range for e in events if "spin_kernel" in e.name]
    work = [e for e in events if "spin_kernel" not in e.name]
    opened = bool(work) and any(
        t.end <= min(e.time_range.start for e in work) for t in spins)
    closed = bool(work) and any(
        t.start >= max(e.time_range.end for e in work) for t in spins)
    if work and not (opened and closed):
        log(f"trace of {len(work)} device events lacks its "
            + " and ".join(w for w, ok in (("opening", opened),
                                           ("closing", closed)) if not ok)
            + " marker")
    return y, work, opened and closed


def _device_ms(fn, reps=20, tries=TRIES):
    """Device time (ms) per call of fn: the summed durations of the GPU
    work it launches, from torch.profiler, over ``reps`` calls. A host
    clock or events around one launch would also count the Python
    wrapper's launch latency, which exceeds the small kernels' run time.
    fn launches the same work on every call: the count of one call comes
    from a whole trace of one call, and a trace of ``reps`` calls counts
    only if it is whole and holds exactly ``reps`` times that many events.
    Each is taken again until it does, ``tries`` times at most; then the
    run stops."""
    fn()

    def whole_trace(calls, per_call=None):
        for _ in range(tries):
            _, events, whole = _traced(lambda: [fn() for _ in range(calls)])
            if whole and (per_call is None
                          or len(events) == calls * per_call):
                return events
            log(f"profiler recorded {len(events)} device events over "
                f"{calls} calls" + ("" if per_call is None else
                                    f" ({per_call} a call)")
                + ("" if whole else ", not whole") + "; tracing again")
        raise SystemExit(f"chip_smoke: no whole trace of {calls} calls in "
                         f"{tries} tries")

    events = whole_trace(reps, len(whole_trace(1)))
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


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


def _time_pair(name, variant, kernel, plain, library=None):
    """Device ms per call of the kernel, its plain version and the library
    call (None where there is none), logged beside the CUDA-event medians
    of kernel and plain."""
    ms = (_device_ms(kernel), _device_ms(plain),
          None if library is None else _device_ms(library))
    ev = (_event_ms(kernel), _event_ms(plain))
    lib = "" if library is None else f", library call {ms[2]:.4f} ms"
    log(f"kernel {name} [{variant}]: device {ms[0]:.4f} ms, plain "
        f"{ms[1]:.4f} ms{lib} per call (profiler, 20 calls); CUDA-event "
        f"median {ev[0]:.4f} ms, plain {ev[1]:.4f} ms")
    return ms


def _log_times(name, variant, kernel, plain, library, cost):
    """Times of a shape that no row records: ``_time_pair``, then the
    kernel's ratio to the library call and its bound from the call's
    (bytes, flops) ``cost``, logged. Returns (the three times, bound ms,
    what bounds it)."""
    ms = _time_pair(name, variant, kernel, plain, library)
    bound, by = _bound(*cost)
    lib = ("" if ms[2] is None
           else f"{ms[0] / ms[2]:.2f} x the library call's device time; ")
    log(f"kernel {name} [{variant}]: {lib}bound {bound:.5f} ms by {by} "
        f"({ms[0] / bound:.2f} x)")
    return ms, bound, by


def _bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` (each input read once, each output written once) and do
    ``flops`` float32 operations, at the H100's published peaks."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _nbytes(*planes):
    """Bytes of tensors and IntPlanes (every field)."""
    total = 0
    for p in planes:
        for t in (p if isinstance(p, tuple) else (p,)):
            if t is not None:
                total += t.numel() * t.element_size()
    return total


def _err(got, ref):
    import torch

    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    ab = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return ab, ab / scale


def check_kernels():
    """Each kernel against its plain version on the card. Returns {name:
    {"err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"}} with
    the times of the variant the main path runs (K7: its head call plus its
    tail call); launches here are not counted."""
    import torch

    from bfir_tpu_torch.kernels import fft_fused as FF
    from bfir_tpu_torch.kernels import spectrum_mac as K

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(7)

    def rn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    ph, pt, hh, ht = 16, 14, N, 8 * N  # head / tail partitions and widths
    bl = ht // 8  # one split-tail band
    out = {}

    def run(name, variant, kernel, plain, timed=None, library=None):
        """``timed``: (bytes, flops) of the call when it is the variant the
        main path runs; its times are then recorded (and added to an
        earlier timed variant's: K7's head and tail) and returned."""
        ab, rel = _err(kernel(), plain())
        log(f"kernel {name} [{variant}]: max_abs_err {ab:.3e} "
            f"(rel {rel:.2e})")
        if not rel <= REL_TOL:
            raise SystemExit(f"chip_smoke: {name} [{variant}] disagrees with "
                             f"its plain version: rel err {rel:.2e}")
        row = out.setdefault(name, {"err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                    "library_ms": None, "bound_ms": 0.0,
                                    "bytes": 0, "flops": 0})
        row["err"] = max(row["err"], ab)
        if timed is None:
            return
        ms, plain_ms, lib_ms = _time_pair(name, variant, kernel, plain,
                                          library)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        if lib_ms is not None:
            row["library_ms"] = lib_ms
        row["bytes"] += timed[0]
        row["flops"] += timed[1]
        row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flops"])
        log(f"kernel {name}: bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']} ({row['bytes'] / 1e6:.1f} MB, "
            f"{row['flops'] / 1e9:.2f} GFLOP)")
        return ms, plain_ms, lib_ms

    def mac_cost(ring, coeff, p, lanes, width):
        """Bytes and flops of a ring MAC over ``lanes`` of ``width``: the
        planes' share of those lanes (of block-scaled integer planes, the
        values' share and 4 bytes of scale a row: the kernel reads column
        0 of each row's [.., 128] scale plane), two float32 outputs, 8
        flops per (partition, channel, lane)."""
        share = lanes / width

        def plane(x):
            if isinstance(x, K.IntPlanes):
                return (int(_nbytes(x.hi, x.lo) * share)
                        + x.scale.numel() // 128 * 4)
            return int(_nbytes(x) * share)

        return (plane(ring) + plane(coeff) + 2 * C * lanes * 4,
                8 * p * C * lanes)

    def log_plan(name, variant, p, lanes, c=C):
        """Log the launch plan (``mac_hc_plan``) a ring MAC takes at P
        ``p``, ``c`` channels and ``lanes`` lanes (132 SMs on a CPU
        rehearsal); returns it."""
        sms = K._sm_count(dev) if dev.type == "cuda" else 132
        plan = K.mac_hc_plan(p, c, lanes, sms)
        log(f"kernel {name} [{variant}]: plan S {plan.slices} partition "
            f"slices, unroll {plan.unroll}, grid {plan.grid} of "
            f"{plan.width} x {plan.slices} threads")
        return plan

    def same_bits(name, variant, kernel):
        """Two calls of a sliced launch give the same bits."""
        a, b = kernel(), kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise SystemExit(f"chip_smoke: {name} [{variant}] gave other "
                             "bits on a second call")
        log(f"kernel {name} [{variant}]: two calls equal bit for bit")

    for cs in (C, 1):
        ring, coeff = rn(ph, 2 * C, hh), rn(ph, 2 * cs, hh)
        run("mac_hc", f"f32, coeff rows {2 * cs}",
            lambda: K.mac_hc(ring, coeff, 5),
            lambda: K.mac_hc_plain(ring, coeff, 5),
            mac_cost(ring, coeff, ph, hh, hh) if cs == C else None)
    log_plan("mac_hc", f"f32 [{ph}, {2 * C}, {hh}]", ph, hh)
    log_plan("mac_hc_tiled, mac_hc_tiled_int", f"[{pt}, {2 * C}, {ht}]", pt,
             ht)
    for dt in (torch.float32, torch.bfloat16):
        for cs in (C, 1):
            ring, coeff = rn(pt, 2 * C, ht).to(dt), rn(pt, 2 * cs, ht).to(dt)
            run("mac_hc_tiled", f"{dt}, coeff rows {2 * cs}",
                lambda: K.mac_hc_tiled(ring, coeff, 3),
                lambda: K.mac_hc_plain(ring, coeff, 3),
                mac_cost(ring, coeff, pt, ht, ht)
                if cs == C and dt == torch.float32 else None)
    # K2 at session J's mid and far stages: checked, times logged and kept
    # for the JSON line's "also"
    k2_also = []
    for p3, hp3 in ((16, 8 * N), (8, 64 * N)):
        ring, coeff = rn(p3, 2 * C, hp3), rn(p3, 2 * C, hp3)
        args = ("mac_hc_tiled", f"float32 [{p3}, {2 * C}, {hp3}], session J",
                lambda: K.mac_hc_tiled(ring, coeff, 3),
                lambda: K.mac_hc_plain(ring, coeff, 3))
        run(*args)
        log_plan(*args[:2], p3, hp3)
        ms, bound, by = _log_times(*args, None,
                                   mac_cost(ring, coeff, p3, hp3, hp3))
        k2_also.append({"shape": args[1], "ms": ms[0], "plain_ms": ms[1],
                        "library_ms": None, "bound_ms": bound,
                        "bound_by": by})
        del ring, coeff
    # K1 and K2 at session K's shard shapes on a (1, 4) mesh (4 of the
    # head's 16 partitions, 4 of the tail's 16, 2 of the far stage's 8),
    # at ring position 0 on the rolled ring: checked, times kept for "also"
    k1_also = []
    for name, p_l, hp_l, also in (("mac_hc", 4, N, k1_also),
                                  ("mac_hc_tiled", 4, 8 * N, k2_also),
                                  ("mac_hc_tiled", 2, 64 * N, k2_also)):
        ring, coeff = rn(p_l, 2 * C, hp_l), rn(p_l, 2 * C, hp_l)
        kern = getattr(K, name)
        args = (name, f"float32 [{p_l}, {2 * C}, {hp_l}] at pos 0, session "
                "K shard", lambda: kern(ring, coeff, 0),
                lambda: K.mac_hc_plain(ring, coeff, 0))
        run(*args)
        log_plan(*args[:2], p_l, hp_l)
        ms, bound, by = _log_times(*args, None,
                                   mac_cost(ring, coeff, p_l, hp_l, hp_l))
        also.append({"shape": args[1], "ms": ms[0], "plain_ms": ms[1],
                     "library_ms": None, "bound_ms": bound, "bound_by": by})
        del ring, coeff
    # K1 and K3 at session M's shapes (N = 64, M = 512): the head of the
    # smallest lane count K1 takes, [16, 128, 128], and the int24 tail of
    # 254 partitions, [254, 128, 512], one tile of all its lanes
    # K2 float32 at session M's tail shape, and K3 int24 at N = 128's tail
    # [126, 128, 1024]: "also" rows. Each sliced shape must give the same
    # bits in two calls; its plan is logged.
    mp_h, mp_t, mh_h, mh_t = M_GEOM
    ring, coeff = rn(mp_h, 2 * C, mh_h), rn(mp_h, 2 * C, mh_h)
    args = ("mac_hc", f"float32 [{mp_h}, {2 * C}, {mh_h}], session M head",
            lambda: K.mac_hc(ring, coeff, 5),
            lambda: K.mac_hc_plain(ring, coeff, 5))
    run(*args)
    log_plan(*args[:2], mp_h, mh_h)
    same_bits(*args[:3])
    ms, bound, by = _log_times(*args, None,
                               mac_cost(ring, coeff, mp_h, mh_h, mh_h))
    k1_also.append({"shape": args[1], "ms": ms[0], "plain_ms": ms[1],
                    "library_ms": None, "bound_ms": bound, "bound_by": by})
    coeff1 = rn(mp_h, 2, mh_h)
    run("mac_hc", f"float32 [{mp_h}, {2 * C}, {mh_h}], coeff rows 2, "
        "session M head", lambda: K.mac_hc(ring, coeff1, 0),
        lambda: K.mac_hc_plain(ring, coeff1, 0))
    ring, coeff = rn(mp_t, 2 * C, mh_t), rn(mp_t, 2 * C, mh_t)
    args = ("mac_hc_tiled", f"float32 [{mp_t}, {2 * C}, {mh_t}], session M "
            "tail shape", lambda: K.mac_hc_tiled(ring, coeff, 77, tile=mh_t),
            lambda: K.mac_hc_plain(ring, coeff, 77))
    run(*args)
    log_plan(*args[:2], mp_t, mh_t)
    same_bits(*args[:3])
    ms, bound, by = _log_times(*args, None,
                               mac_cost(ring, coeff, mp_t, mh_t, mh_t))
    k2_also.append({"shape": args[1], "ms": ms[0], "plain_ms": ms[1],
                    "library_ms": None, "bound_ms": bound, "bound_by": by})
    ringb = ring.to(torch.bfloat16)
    coeffb = rn(mp_t, 2, mh_t).to(torch.bfloat16)
    run("mac_hc_tiled", f"bf16 [{mp_t}, {2 * C}, {mh_t}], coeff rows 2, "
        "session M tail shape",
        lambda: K.mac_hc_tiled(ringb, coeffb, 1, tile=mh_t),
        lambda: K.mac_hc_plain(ringb, coeffb, 1))
    del ring, coeff, coeff1, ringb, coeffb
    k3_also = []
    for p3, hp3, where in ((mp_t, mh_t, "session M tail"),
                           ((TAPS - 16 * 128) // 1024, 1024, "N = 128 tail")):
        ring = K.quantize_planes(rn(p3, 2 * C, hp3), 24)
        coeff = K.quantize_planes(rn(p3, 2 * C, hp3), 24)
        args = ("mac_hc_tiled_int", f"int24 [{p3}, {2 * C}, {hp3}], {where}",
                lambda: K.mac_hc_tiled_int(ring, coeff, 77, tile=hp3),
                lambda: K.mac_reference_hc_int(ring, coeff, 77))
        run(*args)
        log_plan(*args[:2], p3, hp3)
        same_bits(*args[:3])
        cost = mac_cost(ring, coeff, p3, hp3, hp3)
        if hp3 == mh_t:
            whole = _nbytes(ring, coeff) + 2 * C * hp3 * 4
            log(f"kernel mac_hc_tiled_int [{args[1]}]: bytes {cost[0] / 1e6:.1f}"
                f" MB with 4 B of scale a row (what the kernel reads); "
                f"{whole / 1e6:.1f} MB with the whole [.., 128] scale planes,"
                " as counted before")
        ms, bound, by = _log_times(*args, None, cost)
        k3_also.append({"shape": args[1], "ms": ms[0], "plain_ms": ms[1],
                        "library_ms": None, "bound_ms": bound,
                        "bound_by": by})
        if hp3 == mh_t:  # the sliced path's other integer kinds, shared rows
            for bits in ((16, 16), (24, 16)):
                r16 = K.quantize_planes(rn(p3, 2 * C, hp3), bits[0])
                c16 = K.quantize_planes(rn(p3, 2, hp3), bits[1])
                run("mac_hc_tiled_int", f"int{bits[0]} ring, int{bits[1]} "
                    f"coeff rows 2 [{p3}, {2 * C}, {hp3}], {where}",
                    lambda: K.mac_hc_tiled_int(r16, c16, 3, tile=hp3),
                    lambda: K.mac_reference_hc_int(r16, c16, 3))
            del r16, c16
        del ring, coeff
    out["mac_hc"]["also"] = k1_also
    out["mac_hc_tiled"]["also"] = k2_also
    for bits in (24, 16):
        for cs in (C, 1):
            ring = K.quantize_planes(rn(pt, 2 * C, ht), bits)
            coeff = K.quantize_planes(rn(pt, 2 * cs, ht), bits)
            run("mac_hc_tiled_int", f"int{bits}, coeff rows {2 * cs}",
                lambda: K.mac_hc_tiled_int(ring, coeff, 9),
                lambda: K.mac_reference_hc_int(ring, coeff, 9),
                mac_cost(ring, coeff, pt, ht, ht)
                if cs == C and bits == 24 else None)
    out["mac_hc_tiled_int"]["also"] = k3_also
    # K4: timed at the tail-fire shape [64, 8192] (and logged at [64,
    # 1024]); checked at h = 1024, 8192 and 16384, on 64 and 129 rows, on
    # planes with h and h + 128 lanes
    for h, rows, lanes in [(h, rows, lanes) for h in (ht, N, 16 * N)
                           for rows in (C, 129) for lanes in (h, h + 128)]:
        hr, hi = rn(rows, lanes), rn(rows, lanes)
        main = (h, rows, lanes) == (ht, C, ht)
        spec = torch.complex(
            torch.cat([hr[:, :h], hi[:, :1]], 1),
            torch.cat([torch.zeros_like(hi[:, :1]), hi[:, 1:h],
                       torch.zeros_like(hi[:, :1])], 1))
        k4_flops = rows * (5 * h * np.log2(h) + 10 * h)  # FFT + tangle
        variant = f"[{rows}, {lanes}] planes, n {2 * h}"

        def kernel():
            return FF.irfft_split_hc_tail_balanced(hr, hi, 2 * h)

        def plain():
            return FF.irfft_split_hc_tail_plain(hr, hi, 2 * h)

        def library():
            return torch.fft.irfft(spec, n=2 * h)[:, h:]

        cost = (_nbytes(hr, hi) + rows * h * 4, k4_flops)
        run("irfft_split_hc_tail_balanced", variant, kernel, plain,
            cost if main else None, library=library)
        if (h, rows, lanes) == (N, C, N):
            _log_times("irfft_split_hc_tail_balanced", variant, kernel, plain,
                       library, cost)
    # K5 / K6: one band of the split tail, band 0 (lane-0 law) and band 3
    for cs in (C, 1):
        ring, coeff = rn(pt, 2 * C, ht), rn(pt, 2 * cs, ht)
        for band in (0, 3):
            run("mac_hc_band", f"f32, band {band}, coeff rows {2 * cs}",
                lambda: K.mac_hc_band(ring, coeff, 4, band * bl, bl),
                lambda: K.mac_reference_hc_band(ring, coeff, 4, band * bl, bl),
                mac_cost(ring, coeff, pt, bl, ht)
                if cs == C and band == 3 else None)
    for bits in (24, 16):
        for cs in (C, 1):
            ring = K.quantize_planes(rn(pt, 2 * C, ht), bits)
            coeff = K.quantize_planes(rn(pt, 2 * cs, ht), bits)
            for band in (0, 3):
                run("mac_hc_band_int",
                    f"int{bits}, band {band}, coeff rows {2 * cs}",
                    lambda: K.mac_hc_band_int(ring, coeff, 11, band * bl, bl),
                    lambda: K.mac_reference_hc_band_int(ring, coeff, 11,
                                                        band * bl, bl),
                    mac_cost(ring, coeff, pt, bl, ht)
                    if cs == C and bits == 24 and band == 3 else None)
    log_plan("mac_hc_band, mac_hc_band_int", f"band of {bl} lanes, P {pt}",
             pt, bl)
    # K5 and K6 with two channels, where the bands are sliced: band 0 (the
    # lane-0 law) and band 3, untimed
    ring2, coeff2 = rn(pt, 4, ht), rn(pt, 2, ht)
    ri2 = K.quantize_planes(ring2, 24)
    ci2 = K.quantize_planes(coeff2, 24)
    log_plan("mac_hc_band, mac_hc_band_int", f"2 channels, band of {bl} "
             f"lanes, P {pt}", pt, bl, 2)
    for band in (0, 3):
        run("mac_hc_band", f"f32 [{pt}, 4, {ht}], band {band}, coeff rows 2",
            lambda: K.mac_hc_band(ring2, coeff2, 4, band * bl, bl),
            lambda: K.mac_reference_hc_band(ring2, coeff2, 4, band * bl, bl))
        run("mac_hc_band_int", f"int24 [{pt}, 4, {ht}], band {band}, coeff "
            "rows 2", lambda: K.mac_hc_band_int(ri2, ci2, 6, band * bl, bl),
            lambda: K.mac_reference_hc_band_int(ri2, ci2, 6, band * bl, bl))
    del ring2, coeff2, ri2, ci2
    out["corr_mac"]["also"] = check_corr_mac(run, rn)
    # K8: the packed engine's MAC at the flagship, P = 128, Fp = 1152, over
    # the N + 1 live bins (the engine's rows are zero beyond them)
    pp, fp, nf = TAPS // N, 1152, N + 1
    ring, coeff = rn(pp, 2 * C, fp), rn(pp, 2 * C, fp)
    ring[..., nf:] = 0
    coeff[..., nf:] = 0
    run("mac_packed", f"f32 [{pp}, {2 * C}, {fp}], {nf} lanes",
        lambda: K.mac_packed(ring, coeff, 77, nf),
        lambda: K.mac_packed_plain(ring, coeff, 77, nf),
        mac_cost(ring, coeff, pp, nf, fp))
    log_plan("mac_packed", f"[{pp}, {2 * C}, {fp}]", pp,
             K._packed_lanes(fp, nf))
    log_ptxas("mac_hc_kernel")
    out["quantize_hp_tpdf"] = {}  # its row's place; checked last, below
    check_uniform_macs(run, mac_cost, ring, coeff)
    for name, at in check_fft_family(run).items():
        out[name]["also"] = at
    out["quantize_hp_tpdf"].update(check_quantizer())
    return out


def check_corr_mac(run, rn):
    """K7 at G = 8, the head call (P = 16, B = G*R = 64, Hp = N) and the
    tail call (P = 14, B = G, Hp = 8N), with per-channel and shared
    coefficients: each call timed alone (the row's times are their sum)
    and logged with its bytes, bound and share of it beside a ``copy_``
    that moves the same bytes, and the plan each shape takes; then,
    untimed, the edges: P = 40 (the register window walked three times),
    B = 1, a ragged last lane tile (Hp = 1000), bf16 history and bf16
    coefficients at both shapes, and few channels (B split). Returns the
    tail call's times for the row's "also"."""
    import torch

    from bfir_tpu_torch.kernels import corr_mac as CM

    def plan(hist, coeff, b):
        if hist.device.type != "cuda":
            return "plain version (CPU)"
        pl = CM.plan_for(hist, coeff, b)
        threads, lanes, stages = CM._VARIANTS[pl.variant]
        return (f"variant {pl.variant} ({threads} threads x {lanes} lanes, "
                f"{stages} stages, tile {pl.tile}), {pl.items} items "
                f"(B in {pl.nsplit} of {pl.b_chunk}), grid {pl.grid}; "
                f"streams {pl.streamed / 1e6:.2f} MB, inputs "
                f"{pl.inputs / 1e6:.2f} MB, re-read "
                f"{(pl.streamed - pl.inputs) / 1e6:.2f} MB")

    def check(where, p, hp, b, cs, hdt=torch.float32, cdt=torch.float32,
              timed=False, ch=C):
        hist = rn(p - 1 + b, 2 * ch, hp).to(hdt)
        coeff = rn(p, 2 * cs, hp).to(cdt)
        variant = (f"{where} hist [{p - 1 + b}, {2 * ch}, {hp}] {hdt}, "
                   f"coeff [{p}, {2 * cs}, {hp}] {cdt}")
        cost = (_nbytes(hist, coeff) + 2 * b * ch * hp * 4,
                8 * b * p * ch * hp)
        ms = run("corr_mac", variant, lambda: CM.corr_mac(hist, coeff, b),
                 lambda: CM.corr_mac_plain(hist, coeff, b),
                 cost if timed else None)
        log(f"kernel corr_mac [{variant}]: plan {plan(hist, coeff, b)}")
        if not timed:
            return None
        bound, by = _bound(*cost)
        # yardstick: a device-to-device copy that moves the same bytes,
        # half read and half written
        src = torch.empty(cost[0] // 8, device=hist.device)
        dst = torch.empty_like(src)
        copy_ms = _device_ms(lambda: dst.copy_(src))
        log(f"kernel corr_mac [{where}]: {ms[0]:.4f} ms for "
            f"{cost[0] / 1e6:.1f} MB, bound {bound:.4f} ms by {by}: "
            f"{100 * bound / ms[0]:.1f}% of the bound; a copy_ moving the "
            f"same bytes {copy_ms:.4f} ms ({cost[0] / copy_ms / 1e9:.3f} "
            f"TB/s), the kernel {100 * copy_ms / ms[0]:.1f}% of its rate")
        return {"shape": variant, "ms": ms[0], "plain_ms": ms[1],
                "library_ms": None, "bound_ms": bound, "bound_by": by}

    ph, pt, hh, ht = 16, 14, N, 8 * N
    head = check("head", ph, hh, 64, C, timed=True)
    tail = check("tail", pt, ht, 8, C, timed=True)
    log(f"kernel corr_mac: head {head['ms']:.4f} + tail {tail['ms']:.4f} = "
        f"{head['ms'] + tail['ms']:.4f} ms (the previous design's: "
        f"0.1732), bound {head['bound_ms']:.4f} + {tail['bound_ms']:.4f} = "
        f"{head['bound_ms'] + tail['bound_ms']:.4f} ms (0.0787)")
    for where, p, hp, b in (("head", ph, hh, 64), ("tail", pt, ht, 8)):
        check(where, p, hp, b, 1)
        for hdt, cdt in ((torch.bfloat16, torch.float32),
                         (torch.float32, torch.bfloat16),
                         (torch.bfloat16, torch.bfloat16)):
            check(where, p, hp, b, C, hdt, cdt)
    check("P 40", 40, hh, 64, C)
    check("B 1", ph, hh, 1, C)
    check("ragged", pt, 1000, 8, C)
    check("ragged, shared", ph, 1000, 64, 1)
    check("2 channels", ph, 256, 64, 2, ch=2)
    log_ptxas("corr_mac_kernel")
    return tail


def check_uniform_macs(run, mac_cost, ring, coeff):
    """K10-K13 at the flagship (P = 128): K10 and K11 on the packed ring
    and coefficients of K8's check, over the 1025 live bins (the doubled
    ring mirrors slot s at s + P); K12 and K13 on hc planes [128, 128,
    1024] with per-channel coefficients. K10's unrolled chunk sizes 1 and
    4 and its loop (k = 32), K12 with a zero-padded basis (blocks of 64,
    Hp = 128), at Hp = 2048 and at C = 65 with P = 5 (the last warp item
    and channel tile ragged) are checked untimed; K12's cooperative grid,
    each shape's split plan and its ptxas report are logged. K13's ring
    must equal its plain version's bit for bit."""
    import torch

    from bfir_tpu_torch.kernels import spectrum_mac as K

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(8)

    def rn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    pp, fp = ring.shape[0], ring.shape[-1]
    nf = N + 1
    ring2 = torch.cat([ring, ring])
    for k in (1, 4, 32):
        crk = K.chunk_reverse_coeffs(coeff, k)
        run("mac_chunked", f"f32 ring2 [{2 * pp}, {2 * C}, {fp}], k {k}, "
            f"{nf} lanes",
            lambda: K.mac_chunked(ring2, crk, 77, nf, k),
            lambda: K.mac_chunked_plain(ring2, crk, 77, nf, k),
            mac_cost(ring, crk, pp, nf, fp) if k == 4 else None)
    planes = [t.contiguous() for t in (ring[:, :C], ring[:, C:],
                                       coeff[:, :C], coeff[:, C:])]
    run("mac_split", f"f32 4 x [{pp}, {C}, {fp}], {nf} lanes",
        lambda: K.mac_split(*planes, 77, nf),
        lambda: K.mac_split_plain(*planes, 77, nf),
        mac_cost(tuple(planes[:2]), tuple(planes[2:]), pp, nf, fp))
    del ring2, planes

    hp = N  # hc lanes at the flagship: n_fft / 2
    ring, coeff, xpk = rn(pp, 2 * C, hp), rn(pp, 2 * C, hp), rn(2 * C, hp)
    rk, rp = ring.clone(), ring.clone()
    nbytes = (_nbytes(ring) * (pp - 1) // pp + _nbytes(coeff)
              + 2 * _nbytes(xpk) + 2 * C * hp * 4)
    run("mac_hc_insert", f"f32 [{pp}, {2 * C}, {hp}], slot 5",
        lambda: K.mac_hc_insert(rk, coeff, xpk, 5),
        lambda: K.mac_hc_insert_plain(rp, coeff, xpk, 5),
        (nbytes, 8 * pp * C * hp))
    if not (torch.equal(rk, rp) and torch.equal(rk[5], xpk)):
        raise SystemExit("chip_smoke: mac_hc_insert's ring differs from its "
                         "plain version's")
    log("kernel mac_hc_insert: the ring equals the plain version's bit for "
        "bit, slot 5 holds xpk")
    del rk, rp
    grid = K._tail_grid(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = []
    for n, p, h, ch in ((N, pp, hp, C), (64, 8, 128, C), (2048, 4, 2048, C),
                        (N, 5, hp, 65)):
        r, g = ((ring, coeff) if (h, ch) == (hp, C)
                else (rn(p, 2 * ch, h), rn(p, 2 * ch, h)))
        wr, wi = K._tail_basis(n, h, torch.float32, dev)
        run("mac_tail_hc", f"f32 [{p}, {2 * ch}, {h}], blocks of {n}",
            lambda: K.mac_tail_hc(r, g, wr, wi, 9),
            lambda: K.mac_tail_hc_plain(r, g, wr, wi, 9),
            (_nbytes(r, g, wr, wi) + C * h * 4,
             8 * p * C * h + 4 * C * h * h) if (h, ch) == (hp, C) else None)
        plans.append(f"C {ch}, Hp {h}: {K.mac_tail_plan(ch, h, grid)[:2]}")
    # the same launch with one partition: the product, the partial sums and
    # both barriers, and a MAC of 1/128 of the flagship's bytes
    r1, g1 = ring[:1].contiguous(), coeff[:1].contiguous()
    wr, wi = K._tail_basis(N, hp, torch.float32, dev)
    log(f"kernel mac_tail_hc [f32 [1, {2 * C}, {hp}]]: device "
        f"{_device_ms(lambda: K.mac_tail_hc(r1, g1, wr, wi, 0)):.4f} ms: "
        "all but the MAC of the flagship call")
    log(f"kernel mac_tail_hc: cooperative grid of {grid} blocks of 256 "
        f"threads, {grid / sms:g} a block per SM on {sms} SMs; (splits, k "
        "rows a split) " + "; ".join(plans))
    log_ptxas("mac_tail_hc_kernel")


def check_fft_family(run):
    """K14-K18 against their plain versions (``torch.fft``). Timed at the
    shape session G gives them, [64, 2048] (h = 1024), beside the one
    ``torch.fft`` call computing the same function, and at [64, 16384]
    (h = 8192); K17 also at its smallest, [64, 1024] (h = 512). K15 and
    K18 (one kernel on the register-radix core) are checked at h = 512,
    1024, 8192 and 16384 on 64 and 129 rows; K14 in every mode (forward,
    inverse, each tail-only) at h = 1024, 8192 and 16384 on 64 and 129
    rows; K16 and K17 (K4's kernel) at every h they take on the card, K17
    512-16384 and K16 1024-16384, on 64 and 129 rows and on lane-padded
    planes (h + 128 lanes) on 64 rows. Bound: bytes in and out once, or
    5 h log2 h float32 flops a row. Returns the times at [64, 16384]
    (K14: [64, 8192] forward) by kernel, for the JSON line's "also"."""
    import torch

    from bfir_tpu_torch.kernels import fft_fused as FF
    from bfir_tpu_torch.kernels import fft_pallas as FP

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(10)

    def rn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    forward = {"rfft_hc_fused": (FF.rfft_hc_fused, FF.rfft_hc_fused_plain),
               "rfft_hc_pallas": (FP.rfft_hc_pallas, FP.rfft_hc_pallas_plain)}
    inverse = {  # wrapper, plain version, smallest h on the card
        "irfft_hc_tail_fused": (FF.irfft_hc_tail_fused,
                                FF.irfft_hc_tail_fused_plain, 1024),
        "irfft_hc_tail_pallas": (FP.irfft_hc_tail_pallas,
                                 FP.irfft_hc_tail_pallas_plain, 512)}

    extra = {}

    def check(name, variant, kernel, plain, library, cost, at):
        """``run``, with the call's (bytes, flops) ``cost``; ``at``:
        "main" at session G's shape (the row's times), "tail" at the tail
        shape (times logged and kept for the JSON line), else None."""
        run(name, variant, kernel, plain, cost if at == "main" else None,
            library=library)
        if at == "tail":
            ms, bound, by = _log_times(name, variant, kernel, plain, library,
                                       cost)
            extra[name] = {"shape": variant, "ms": ms[0], "plain_ms": ms[1],
                           "library_ms": ms[2], "bound_ms": bound,
                           "bound_by": by}

    def at(rows, m, timed=True):
        """"main" at session G's shape, "tail" at [64, 16384], if timed."""
        shape = {(C, 2 * N): "main", (C, 16 * N): "tail"}.get((rows, m))
        return shape if timed else None

    for rows in (C, 129):
        for m in (N, 2 * N, 16 * N, 32 * N):
            h = m // 2
            x = rn(rows, m)
            cost = (2 * _nbytes(x), rows * 5 * h * np.log2(h))
            for name, (kernel, plain) in forward.items():
                check(name, f"[{rows}, {m}]", lambda: kernel(x),
                      lambda: plain(x, m), lambda: torch.fft.rfft(x), cost,
                      at(rows, m))

    for h in (512, 1024, 2048, 4096, 8192, 16384):
        m = 2 * h
        for name, (kernel, plain, h_min) in inverse.items():
            if h < h_min:
                continue
            for rows, lanes in ((C, h), (C, h + 128), (129, h)):
                hr, hi = rn(rows, lanes), rn(rows, lanes)
                spec = torch.complex(
                    torch.cat([hr[:, :h], hi[:, :1]], 1),
                    torch.cat([torch.zeros_like(hi[:, :1]), hi[:, 1:h],
                               torch.zeros_like(hi[:, :1])], 1))
                timed = lanes == h
                args = (name, f"[{rows}, {lanes}] planes, n {m}",
                        lambda: kernel(hr, hi, m), lambda: plain(hr, hi, m),
                        lambda: torch.fft.irfft(spec, n=m)[:, h:],
                        (_nbytes(hr, hi) + rows * h * 4,
                         rows * 5 * h * np.log2(h)))
                check(*args, at(rows, m, timed))
                if (rows, h, timed) == (C, 512, True):
                    _log_times(*args)

    # K14 in every mode at h = 1024, 8192 and 16384 on 64 and 129 rows
    for rows, h in ((r, h) for h in (N, 8 * N, 16 * N) for r in (C, 129)):
        zr, zi = rn(rows, h), rn(rows, h)
        zc = torch.complex(zr, zi)
        for inv, tail in ((False, False), (True, False), (True, True),
                          (False, True)):
            check("cfft_balanced_fused", f"[{rows}, {h}] "
                  f"{'inverse' if inv else 'forward'}"
                  f"{' tail' if tail else ''}",
                  lambda: FF.cfft_balanced_fused(zr, zi, h, inverse=inv,
                                                 tail_only=tail),
                  lambda: FF.cfft_balanced_fused_plain(
                      zr, zi, h, inverse=inv, tail_only=tail),
                  lambda: torch.fft.fft(zc),
                  (2 * _nbytes(zr, zi), rows * 5 * h * np.log2(h)),
                  at(rows, 2 * h, not (inv or tail)))
    return extra


def check_quantizer():
    """K9 against its plain version, bit for bit in all six outputs, at
    int24 and int16 limits on inputs that clip: [64, 1024] float32 and
    float64 against the plain loop on the card (timed at int24; float32 is
    the row), [64, 65536] and [64, 20000] float32 (session E's largest
    chunk; the kernel timed alone) and [65, 1001] float32 and float64
    (a ragged warp and rows of no whole 16-byte vectors: the scalar path)
    against the plain loop on the CPU (on the card it costs launches per
    sample). Logs each timed shape's bounds and the kernel's ptxas report,
    and writes its SASS (``dump_sass``). Returns the kernel's row of
    ``check_kernels``."""
    import torch

    from bfir_tpu_torch.kernels import dither_kernel as DK

    rng = np.random.default_rng(17)
    row = None
    lat, clock = chain_latency()
    f32, f64 = torch.float32, torch.float64
    cases = ((f32, C, 1024, DEVICE), (f64, C, 1024, DEVICE),
             (f32, C, 65536, "cpu"), (f32, C, 20000, "cpu"),
             (f32, 65, 1001, "cpu"), (f64, 65, 1001, "cpu"))
    for bits in (24, 16):
        imin, imax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        for dt, rows, t, plain_dev in cases:
            x, dv, e0, e1, nof, lg, ilg = _k9_inputs(rng, dt, rows, t, imax)

            def kernel():
                return DK.quantize_hp_tpdf(x, dv, e0, e1, imin, imax, nof,
                                           lg, ilg)

            def plain():
                on = [a.to(plain_dev) for a in (x, dv, e0, e1)]
                st = [a.to(plain_dev) for a in (nof, lg, ilg)]
                return DK.quantize_hp_tpdf_plain(*on, imin, imax, *st)

            got = [a.cpu() for a in kernel()]
            ref = [a.cpu() for a in plain()]
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            variant = (f"int{bits}, {str(dt)[6:]} [{rows}, {t}], plain on "
                       f"{plain_dev}")
            log(f"kernel quantize_hp_tpdf [{variant}]: bit-equal "
                f"{same}, {int(got[3].sum())} clipped samples")
            if not same or int(got[3].sum()) == 0:
                raise SystemExit(f"chip_smoke: quantize_hp_tpdf [{variant}] "
                                 "differs from its plain version (or did "
                                 "not clip)")
            if bits != 24 or t not in (1024, 20000):
                continue
            ms = _device_ms(kernel)
            # x and dv in, q out, the five state vectors in and out
            nbytes = (_nbytes(x, dv) + 2 * _nbytes(e0, e1, nof, lg, ilg)
                      + rows * t * 4)
            bound_ms, bound_by = _bound(nbytes, 10 * rows * t)
            # the serial chain: PERF.md's estimate of six dependent
            # operations of four cycles at 1.755 GHz, and the SASS chain
            # at the latencies and SM clock measured on this card
            chain_ms = t * 6 * 4 / CLOCK_HZ * 1e3
            name = str(dt)[6:]
            sass = sum(n * lat[name][op] for op, n in K9_CHAIN[name].items())
            log(f"kernel quantize_hp_tpdf [{variant}]: device {ms:.4f} ms"
                f" = {ms / t * 1e6:.2f} ns, {ms / t * clock / 1e3:.1f} SM "
                f"cycles a sample at {clock / 1e9:.3f} GHz; bound "
                f"{bound_ms:.5f} ms by {bound_by} ({nbytes / 1e6:.2f} MB); "
                f"serial-chain bounds {chain_ms:.4f} ms (6 dependent ops x "
                f"4 cycles at 1.755 GHz) and {t * sass / clock * 1e3:.4f} ms "
                f"(SASS chain {sass:.1f} cycles a sample: " + ", ".join(
                    f"{n} x {op} {lat[name][op]:.2f}"
                    for op, n in K9_CHAIN[name].items()) + ")")
            if row is None:
                # the plain version is timed by main() after every path,
                # in a process of its own (time_k9_plain)
                row = {"err": 0.0, "ms": ms, "library_ms": None,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "plain": variant}
    log_ptxas("quantize_kernel")
    dump_sass("quantize_kernel")
    return row


def _k9_inputs(rng, dt, rows, t, imax):
    """K9's arguments on the card, drawn from ``rng``: x [rows, t] that
    clips at +-(imax + 1), dither values, e0, e1 and zeroed statistics."""
    import torch

    npdt = np.float32 if dt == torch.float32 else np.float64
    byte = rng.integers(-128, 128, (rows, t + 1))
    args = [
        rng.uniform(-1.1, 1.1, (rows, t)) * (imax + 1),  # x clips
        0.5 + (np.diff(byte, axis=1) + 1.0) / 255.0,  # dither values
        rng.uniform(-1.5, 1.5, rows), rng.uniform(-1.5, 1.5, rows)]
    args = [torch.from_numpy(a.astype(npdt)) for a in args]
    stats = [torch.zeros(rows, dtype=torch.int32), torch.zeros(rows, dtype=dt),
             torch.zeros(rows, dtype=torch.int32)]
    return [a.to(DEVICE) for a in args + stats]


def time_k9_plain():
    """Run in a process of its own by main(): K9's plain version on the
    inputs of its row (check_quantizer's first case, the same seed), one
    call timed by the profiler and by CUDA events; prints them as the last
    line, a JSON object. Its 25602 launches make a trace that loses events
    after other traces in a long process (in this script's full run, the
    start of each of five traces at its end), so it runs where no other
    trace came before, after one small trace that starts the profiler,
    with up to 20 tries (each must still be whole, with the exact event
    count: 2 of 3 traces in one run lost their last events)."""
    import torch

    from bfir_tpu_torch.kernels import dither_kernel as DK

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    imin, imax = -(1 << 23), (1 << 23) - 1
    args = _k9_inputs(np.random.default_rng(17), torch.float32, C, 1024, imax)
    plain = functools.partial(DK.quantize_hp_tpdf_plain, *args[:4], imin,
                              imax, *args[4:])
    _traced(lambda: torch.cuda._sleep(1))
    print(json.dumps({"plain_ms": _device_ms(plain, 1, tries=20),
                      "event_ms": _event_ms(plain, 1)}), flush=True)


def chain_latency():
    """({"float32" | "float64": {op: cycles}}, SM clock in Hz): the latency
    of each operation on K9's serial chain on this card, one warp timing
    dependent repetitions with clock64() (``csrc/chain_latency.cu``: op
    then add, less the add alone), and the SM clock from the add chain's
    cycles over its CUDA-event time."""
    import torch

    from bfir_tpu_torch.kernels import cuda_lib

    lib = cuda_lib.load()
    iters = 16384
    lat, clock = {}, None
    for dt in (torch.float32, torch.float64):
        x = torch.tensor([0.3, 0.4, 0.5, 0.6, 0.37, 0.25], dtype=dt,
                         device=DEVICE)
        out = torch.empty(32, dtype=dt, device=DEVICE)
        cyc = torch.empty(32, dtype=torch.int64, device=DEVICE)
        per = []
        for kind in range(4):
            def call():
                err = lib.bfir_chain_latency(
                    kind, int(dt == torch.float64), x.data_ptr(),
                    out.data_ptr(), cyc.data_ptr(), iters, 0,
                    cuda_lib.stream_of(x))
                cuda_lib.check(err, "chain_latency")

            call()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            b.synchronize()
            per.append(int(cyc.max()) / (16 * iters))
            if clock is None:
                clock = int(cyc.max()) / (a.elapsed_time(b) * 1e-3)
        lat[str(dt)[6:]] = {"add": per[0], "trunc": per[1] - per[0],
                            "max": per[2] - per[0],
                            "select": per[3] - per[0]}
    log("K9 chain latencies (cycles; csrc/chain_latency.cu): " + "; ".join(
        f"{k}: " + ", ".join(f"{op} {v:.2f}" for op, v in d.items())
        for k, d in lat.items()) + f"; SM clock {clock / 1e9:.3f} GHz")
    return lat, clock


def log_ptxas(fragment):
    """Log ptxas's report (registers, spills, shared memory) of each entry
    function whose name holds ``fragment``, from the build's log."""
    from bfir_tpu_torch.kernels import cuda_lib

    path = os.path.join(cuda_lib.BUILD_DIR,
                        f"build-{cuda_lib._digest()}.log")
    name = spill = None
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1) if fragment in m.group(1) else None
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "Used" in line:
                log(f"ptxas {name}: {line.split(':', 1)[1].strip()}; {spill}")
                name = None


def dump_sass(fragment):
    """Write cuobjdump's SASS of the kernels whose name holds ``fragment``
    to ``WORK/<fragment>.sass`` and log each one's instruction count."""
    from torch.utils.cpp_extension import CUDA_HOME

    from bfir_tpu_torch.kernels import cuda_lib

    res = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                          "-sass", cuda_lib.library_path()],
                         capture_output=True, text=True, timeout=300)
    if res.returncode:
        raise SystemExit(f"chip_smoke: cuobjdump failed: {res.stderr[-2000:]}")
    funcs = [f for f in re.split(r"\n\s*Function : ", res.stdout)[1:]
             if fragment in f.split("\n", 1)[0]]
    path = os.path.join(WORK, f"{fragment}.sass")
    with open(path, "w") as f:
        f.write("".join(f"Function : {fn}\n" for fn in funcs))
    for fn in funcs:
        n = len(re.findall(r"/\*[0-9a-f]{4}\*/", fn))
        log(f"SASS {fn.split()[0]}: {n} instructions")
    log(f"SASS of {len(funcs)} functions written to {path}")


def _impulse(seed, rows, taps=TAPS, tau=16384.0):
    """A decaying-noise room response (amplitude time constant ``tau``
    samples), unit energy per row, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(taps)
    h = rng.standard_normal((rows, taps)) * np.exp(-t / tau)
    h /= np.sqrt((h ** 2).sum(axis=1, keepdims=True))
    return (0.5 * h).astype(np.float32)


def _write_wav(name, h):
    from bfir_tpu_torch.io import wavio

    path = os.path.join(WORK, name)
    wavio.write(path, h.T, 44100, subtype="float32")
    return path


def _config(path, tail_store="auto", mode="auto", dtype="float32", block=N):
    from bfir_tpu_torch.core.spec import (ChainSpec, EngineConfig,
                                          FilterSpec, ImpulseFileSpec)

    files = (ImpulseFileSpec(enabled=True, filename=path), ImpulseFileSpec(),
             ImpulseFileSpec())
    return EngineConfig(filter=FilterSpec(block, dtype=dtype),
                        chain=ChainSpec(files=files), nu_tail_store=tail_store,
                        engine_mode=mode)


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


def _timed_blocks(sp, x, what, counts=None, taps=TAPS):
    """Wall ms per block of process() over the 64-block chunks x[:3]
    (median), then one profiled call over x[3] for the device-busy share
    (its numbers into ``counts``, as ``_device_busy``). Returns (ms per
    block, outputs)."""
    times, outs = [], []
    for chunk in x[:3]:
        t0 = time.perf_counter()
        outs.append(sp.process(chunk))
        times.append((time.perf_counter() - t0) * 1e3 / (chunk.shape[1] // N))
    ms = float(np.median(times))
    log(f"{what}: process() {ms:.4f} ms/block (wall, 64-block calls, median "
        f"of 3, C={C}, N={N}, {taps} taps)")
    outs.append(_device_busy(lambda: sp.process(x[3]), what, counts))
    return ms, outs


def _device_busy(fn, what, counts=None):
    """One profiled call of fn: logs its wall ms, the device-busy ms (the
    GPU work it ran, kernels and copies, summed), how many kernels and
    copies (memcpy, memset) ran, and the largest device items by name;
    returns fn's result. ``counts``, a dict, receives "busy_ms",
    "wall_ms", "kernels" and "copies". fn moves a stream on, so it is not
    called again: where its trace is not whole (``_traced``), the device
    numbers are logged as not measured and are None in ``counts``."""
    import torch

    def timed():
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        return y, (time.perf_counter() - t0) * 1e3

    (y, wall), events, whole = _traced(timed)
    if not whole:
        log(f"{what}: profiled call: {wall:.3f} ms wall; device busy not "
            f"measured: the trace is not whole ({len(events)} device "
            "events)")
        if counts is not None:
            counts.update(busy_ms=None, wall_ms=wall, kernels=None,
                          copies=None)
        return y
    by_name = {}
    n_kernels = n_copies = 0
    for e in events:
        key = e.name[:48]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
        if e.name.startswith(("Memcpy", "Memset")):
            n_copies += 1
        else:
            n_kernels += 1
    busy = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"{what}: profiled call: device busy {busy:.3f} of {wall:.3f} ms "
        f"wall ({100 * busy / wall:.1f}%), {n_kernels} kernels and "
        f"{n_copies} copies; largest device items (ms): "
        + "; ".join(f"{k} {v / 1e3:.3f}" for k, v in top))
    if counts is not None:
        counts.update(busy_ms=busy, wall_ms=wall, kernels=n_kernels,
                      copies=n_copies)
    return y


def _kernels():
    """Every kernel wrapper of the port, by name."""
    from bfir_tpu_torch.kernels import corr_mac as CM
    from bfir_tpu_torch.kernels import dither_kernel as DK
    from bfir_tpu_torch.kernels import fft_fused as FF
    from bfir_tpu_torch.kernels import fft_pallas as FP
    from bfir_tpu_torch.kernels import spectrum_mac as K

    return {"mac_hc": K.mac_hc, "mac_hc_tiled": K.mac_hc_tiled,
            "mac_hc_tiled_int": K.mac_hc_tiled_int,
            "irfft_split_hc_tail_balanced": FF.irfft_split_hc_tail_balanced,
            "mac_hc_band": K.mac_hc_band,
            "mac_hc_band_int": K.mac_hc_band_int, "corr_mac": CM.corr_mac,
            "mac_packed": K.mac_packed,
            "quantize_hp_tpdf": DK.quantize_hp_tpdf,
            "mac_chunked": K.mac_chunked, "mac_split": K.mac_split,
            "mac_tail_hc": K.mac_tail_hc, "mac_hc_insert": K.mac_hc_insert,
            "cfft_balanced_fused": FF.cfft_balanced_fused,
            "rfft_hc_fused": FF.rfft_hc_fused,
            "irfft_hc_tail_fused": FF.irfft_hc_tail_fused,
            "irfft_hc_tail_pallas": FP.irfft_hc_tail_pallas,
            "rfft_hc_pallas": FP.rfft_hc_pallas}


def run_path(what, names, fn, *args):
    """Drive one path with every launch count set to 0 just before it and
    read just after; each kernel in ``names`` must have launched. Returns
    the counts."""
    for k in _kernels().values():
        k.launches = 0
    fn(*args)
    counts = {name: k.launches for name, k in _kernels().items()}
    for name in names:
        if counts[name] == 0:
            raise SystemExit(f"chip_smoke: {what} did not launch {name}")
    log(f"{what}: launches " + ", ".join(f"{k} {n}" for k, n in counts.items()
                                         if n))
    return counts


def _snr_gate(snr, what, bound=MIN_SNR_DB):
    log(f"{what}: worst-channel SNR vs scipy float64 {snr:.1f} dB "
        f"(bound {bound:.0f})")
    if not snr >= bound:
        raise SystemExit(f"chip_smoke: {what} SNR {snr:.1f} dB < "
                         f"{bound:.0f}")


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


def session_c(cache):
    """The split-tail schedule streaming at the flagship (int24 tail)."""
    from bfir_tpu_torch.engine.session import StreamProcessor

    h = _impulse(6, C)
    sp = StreamProcessor(_config(_write_wav("c.wav", h),
                                 mode="nonuniform_split"), cache,
                         device=DEVICE)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((C, 40 * N + 200)).astype(np.float32)
    t0 = time.perf_counter()
    y = _stream(sp, x, [3000, 9000])
    log(f"session C: first process() calls incl. build and self-check "
        f"{time.perf_counter() - t0:.1f} s, {y.shape[1] // N} blocks")
    if sp._impl != "nonuniform_split" or sp._nuspec.tail_store != "int24":
        raise SystemExit(f"chip_smoke: session C engine {sp._impl!r} "
                         f"{sp._nuspec}")
    log(f"session C: engine nonuniform_split, {sp._nuspec}")
    # one block per call (200 samples stay pending), from phase 0 on: the
    # wall time of each phase of the M-cycle
    ratio = sp._nuspec.ratio
    cycles = 8
    blocks = rng.standard_normal((cycles * ratio, C, N)).astype(np.float32)
    per_phase = [[] for _ in range(ratio)]
    outs = []
    for blk in blocks:
        phase = sp._nu_phase()
        t1 = time.perf_counter()
        outs.append(sp.process(blk))
        per_phase[phase].append((time.perf_counter() - t1) * 1e3)
    med = [float(np.median(v)) for v in per_phase]
    mean = float(np.mean(med))
    log("session C: process() wall ms per single-block call by phase "
        f"(median of {cycles}): " + ", ".join(f"{m:.4f}" for m in med)
        + f"; worst phase {max(med):.4f} ms = {max(med) / mean:.2f} x the "
        f"mean {mean:.4f} ms")
    more = rng.standard_normal((4, C, 64 * N)).astype(np.float32)
    ms, ys = _timed_blocks(sp, more, "session C (split, int24 tail)")
    xs = np.concatenate([x, blocks.transpose(1, 0, 2).reshape(C, -1), *more],
                        axis=1)
    ys = np.concatenate([y, *outs, *ys], axis=1)
    _snr_gate(_worst_snr_db(ys, xs[:, :ys.shape[1]], h), "session C")
    return ms


def session_d(cache):
    """StreamProcessor.render at the flagship: the G-batch bulk scan."""
    from bfir_tpu_torch.engine.session import StreamProcessor

    h = _impulse(8, C)
    sp = StreamProcessor(_config(_write_wav("d.wav", h)), cache,
                         device=DEVICE)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((C, 3 * 24 * 8 * N)).astype(np.float32)
    t0 = time.perf_counter()
    sp.render(x[:, :1000])
    log(f"session D: first render() incl. the streaming engine's build, the "
        f"render engine's build and both self-checks "
        f"{time.perf_counter() - t0:.1f} s")
    bulk = sp._bulk
    if (bulk.engine, bulk.nu_engine) != ("nonuniform", "gbatch"):
        raise SystemExit(f"chip_smoke: session D render engine "
                         f"{bulk.engine} {getattr(bulk, 'nu_engine', '')}")
    walls = []
    for _ in range(2):
        t1 = time.perf_counter()
        y = sp.render(x)
        walls.append(time.perf_counter() - t1)
    wall = min(walls)
    log(f"session D: render() of {x.shape[1]} frames x {C} ch, engine "
        f"{bulk.engine}/{bulk.nu_engine}, {bulk.nuspec}: {wall:.3f} s wall "
        f"(best of 2), {C * x.shape[1] / wall / 1e6:.1f} M samples/s, "
        f"{wall * 1e3 / (x.shape[1] / N):.4f} ms per {N}-frame block")
    _device_busy(lambda: sp.render(x), "session D (render)")
    _snr_gate(_worst_snr_db(y, x, h), "session D (render)")
    return C * x.shape[1] / wall / 1e6


def render_split():
    """BulkRenderer's split-tail scan at the flagship (float32 tail: K5)."""
    from bfir_tpu_torch.core.bulk import BulkRenderer

    h = _impulse(10, C)
    r = BulkRenderer(h, C, nu_engine="split", device=DEVICE)
    x = np.random.default_rng(11).standard_normal(
        (C, r.samples_per_dispatch + 5000)).astype(np.float32)
    t0 = time.perf_counter()
    y = r.render(x)
    wall = time.perf_counter() - t0
    log(f"render (split): {x.shape[1]} frames x {C} ch, {r.nuspec}: "
        f"{wall:.3f} s wall, {C * x.shape[1] / wall / 1e6:.1f} M samples/s")
    _snr_gate(_worst_snr_db(y, x, h), "render (split)")


def render_short():
    """A 16384-tap filter through the batch engine (torch.fft only)."""
    from bfir_tpu_torch.core.bulk import BulkRenderer

    rng = np.random.default_rng(12)
    t = np.arange(16384)
    h = rng.standard_normal((C, 16384)) * np.exp(-t / 4096.0)
    h = (0.5 * h / np.sqrt((h ** 2).sum(axis=1, keepdims=True))).astype(
        np.float32)
    r = BulkRenderer(h, C, device=DEVICE)
    if r.engine != "batch":
        raise SystemExit(f"chip_smoke: short render engine {r.engine}")
    x = rng.standard_normal((C, r.samples_per_dispatch + 3000)).astype(
        np.float32)
    t0 = time.perf_counter()
    y = r.render(x)
    wall = time.perf_counter() - t0
    log(f"render (batch, 16384 taps): {x.shape[1]} frames x {C} ch, "
        f"{r.spec}: {wall:.3f} s wall")
    _snr_gate(_worst_snr_db(y, x, h), "render (batch)")


def _run_cli(inp, ir, name, *flags, out_lines=None):
    """``python -m bfir_tpu_torch.cli.render`` in a subprocess (its
    default device, CUDA), with HOME inside the work directory so its
    artifact cache stays in the checkout; returns the output WAV [C, T]
    (and its stdout's lines into ``out_lines``)."""
    from bfir_tpu_torch.io import wavio

    out = os.path.join(WORK, f"cli_{name}.wav")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "bfir_tpu_torch.cli.render", inp, out,
         "--impulse", ir, *flags], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, HOME=WORK))
    wall = time.perf_counter() - t0
    if res.returncode:
        raise SystemExit(f"chip_smoke: the render CLI failed "
                         f"(exit {res.returncode}):\n{res.stderr[-3000:]}")
    log(f"render CLI {' '.join(flags) or '(defaults)'}: "
        f"{res.stdout.strip()}; {wall:.1f} s for the whole process (torch "
        "import, engine builds and self-checks included)")
    if out_lines is not None:
        out_lines.extend(res.stdout.splitlines())
    return wavio.read(out)[0].T


def render_cli():
    """Phase 9: the render CLI on a 2-channel WAV at float32; then phase
    13, the same input with ``--delay 0,100``, float32 and then dithered
    24-bit; then its float64 default (``extended`` on CUDA) and
    ``--auto-attenuate`` on a hot impulse."""
    from bfir_tpu_torch.io import wavio

    rng = np.random.default_rng(13)
    t = np.arange(TAPS)
    h = (rng.standard_normal((2, TAPS)) * np.exp(-t / 16384.0)
         * 0.01).astype(np.float32)
    x = (0.1 * rng.standard_normal((441000, 2))).astype(np.float32)
    ir, inp = (os.path.join(WORK, f"cli_{n}.wav") for n in ("ir", "in"))
    wavio.write(ir, h.T, 44100, subtype="float32")
    wavio.write(inp, x, 44100, subtype="float32")
    y = _run_cli(inp, ir, "out", "--dtype", "float32")
    _snr_gate(_worst_snr_db(y, x.T, h), "render CLI")

    delays = (0, 100)
    ref = _shifted_ref(x.T, h, delays, x.shape[0])
    yf = _run_cli(inp, ir, "delay", "--dtype", "float32", "--delay", "0,100")
    a_max = float(np.abs(yf - ref).max())
    _snr_gate(_shifted_snr_db(yf, ref), "render CLI --delay 0,100")
    yd = _run_cli(inp, ir, "dither", "--dtype", "float32", "--delay", "0,100",
                  "--out-format", "pcm24", "--dither")
    _dither_gate(yd, ref, a_max, "render CLI --delay 0,100 pcm24 --dither")
    render_cli_float64(x, h, inp, ir)


def render_cli_float64(x, h, inp, ir):
    """The render CLI at its default dtype, float64 (``extended`` on CUDA),
    held to the float64 gate; then ``--auto-attenuate`` on a hot impulse
    (+12 dB): the output peak stays within full scale, and the level the
    CLI applies is the port's probe run on the card here."""
    from bfir_tpu_torch.io import wavio
    from bfir_tpu_torch.ops.noise import calculate_attenuation

    y = _run_cli(inp, ir, "f64", "--out-format", "float64")
    _snr_gate(_worst_snr_db(y, x.T, h), "render CLI float64 (default dtype)",
              MIN_SNR64_DB)
    rng = np.random.default_rng(28)
    hot = (rng.standard_normal((2, TAPS)) * np.exp(-np.arange(TAPS) / 1000.0)
           * 1e-4)
    hot[:, 0] = 4.0
    xu = rng.uniform(-0.5, 0.5, (x.shape[0], 2)).astype(np.float32)
    ir_hot, inp_u = (os.path.join(WORK, f"cli_{n}.wav") for n in ("hot",
                                                                  "inu"))
    wavio.write(ir_hot, hot.T, 44100, subtype="float64")
    wavio.write(inp_u, xu, 44100, subtype="float32")
    lines = []
    ya = _run_cli(inp_u, ir_hot, "att", "--block", str(N), "--out-format",
                  "float64", "--auto-attenuate", out_lines=lines)
    said = [ln for ln in lines if ln.startswith("auto-attenuate:")]
    steps = int(said[0].split(" dB, level ")[1].split()[0])
    t0 = time.perf_counter()
    att = calculate_attenuation(hot, block_length=N, dtype="float64",
                                device=DEVICE)
    log(f"render CLI --auto-attenuate: {said[0]}; the probe here on the card "
        f"{att!r} dB in {time.perf_counter() - t0:.3f} s")
    if steps != int(att * 10):
        raise SystemExit(f"chip_smoke: --auto-attenuate applied {steps} "
                         f"steps, the probe on the card gives {att} dB")
    ref = _shifted_ref(xu.T, hot * 10 ** (steps / 200), [0, 0], xu.shape[0])
    peak = float(np.abs(ya).max())
    log(f"render CLI --auto-attenuate: output peak {peak:.4f} (bound 1.0; "
        f"{float(np.abs(ref).max()) * 10 ** (-steps / 200):.4f} without "
        "the attenuation)")
    if not peak <= 1.0:
        raise SystemExit(f"chip_smoke: --auto-attenuate output peak {peak}")
    _snr_gate(_shifted_snr_db(ya, ref), "render CLI --auto-attenuate",
              MIN_SNR64_DB)


def _shifted_ref(x, h, delays, length):
    """scipy's float64 convolution of x [C, T] with the rows of h, each
    channel delayed by its delay, cut to ``length``."""
    from scipy import signal

    ref = np.zeros((x.shape[0], length))
    for c in range(x.shape[0]):
        y = signal.fftconvolve(x[c].astype(np.float64),
                               h[c].astype(np.float64))
        d = delays[c]
        ref[c, d:] = y[: length - d]
    return ref


def _shifted_snr_db(y, ref):
    return min(10 * np.log10(float((ref[c] ** 2).sum())
                             / max(float(((y[c] - ref[c]) ** 2).sum()),
                                   1e-300))
               for c in range(y.shape[0]))


def _dither_gate(y, ref, a_max, what):
    """Gate (b): a dithered 24-bit output y against the float64 reference:
    max |error| within 5 LSB plus ``a_max`` (the undithered output's max
    error), RMS error between 0.5 and 1.5 LSB. The quantizer's own error is
    e0[t-1] - e0[t-2] - e0[t] with |e0| < 1.51 (at most 4.6 LSB), RMS about
    1.0 LSB; rounding without dither gives 0.29 LSB."""
    err = y - ref
    mx = float(np.abs(err).max()) / LSB24
    bound = 5.0 + a_max / LSB24
    rms = float(np.sqrt(np.mean(err ** 2))) / LSB24
    log(f"{what}: vs scipy float64: max |err| {mx:.3f} LSB (bound "
        f"{bound:.3f}), RMS {rms:.4f} LSB (bounds 0.5-1.5) over "
        f"{err.size} samples")
    if not (mx <= bound and 0.5 <= rms <= 1.5):
        raise SystemExit(f"chip_smoke: {what} fails gate (b): max {mx:.3f} "
                         f"LSB, RMS {rms:.4f} LSB")


def _raw_config(path, out_fmt, delays, dither, dtype="float32",
                mode="packed"):
    """S24 in, ``out_fmt`` out; ``delays`` None: no delay line."""
    from bfir_tpu_torch.core.spec import (ChainSpec, DelaySpec, EngineConfig,
                                          FilterSpec, ImpulseFileSpec,
                                          SampleFormat, StreamSpec)

    files = (ImpulseFileSpec(enabled=True, filename=path), ImpulseFileSpec(),
             ImpulseFileSpec())
    return EngineConfig(
        filter=FilterSpec(N, dtype=dtype),
        stream=StreamSpec(n_channels=C, sample_rate=44100,
                          in_format=SampleFormat.S24_LE,
                          out_format=SampleFormat[out_fmt],
                          apply_dither=dither),
        chain=ChainSpec(files=files),
        delay=(DelaySpec() if delays is None
               else DelaySpec(enabled=True, samples=tuple(delays))),
        engine_mode=mode)


def _raw_chunks(sp, raw, frames):
    """process_raw over consecutive chunks of ``raw`` of the given frame
    counts (S24: 3 bytes a sample); returns the output bytes of each."""
    outs, a = [], 0
    for f in frames:
        outs.append(sp.process_raw(raw[a:a + 3 * C * f]))
        a += 3 * C * f
    return outs


CODEC_ROUNDS = 8  # alternating rounds of the codec timing
CODEC = {}  # session E's codec numbers, printed before the kernel line


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())


def codec_check(raw, xi, out, per):
    """Session E's codec phase on its own bytes (C channels, S24_LE in and
    out): the native codec (``formats.decode``, ``encode_int``) against its
    plain numpy version, byte for byte, on the input bytes ``raw`` (made
    from ``xi`` by the plain encode) and the dithered output bytes ``out``
    of (b); then each side timed per N-frame block over every whole block
    of ``raw``, in CODEC_ROUNDS rounds that alternate which side runs
    first: decode to float32 as ``process_raw`` does, and encode_int of
    int32 [C, N] blocks. ``per`` is (b)'s ``raw_seconds`` and wall in
    ms/block.
    Returns the numbers for the JSON line."""
    from bfir_tpu_torch.core.spec import SampleFormat
    from bfir_tpu_torch.ops import formats as fm

    s24 = SampleFormat.S24_LE
    for what, data in (("input", raw), ("output", out)):
        if not _bits_equal(fm.decode(data, s24, C),
                           fm.decode_plain(data, s24, C)):
            raise SystemExit(f"chip_smoke: the native decode of session "
                             f"E's {what} differs from the plain one")
    q_out = np.round(fm.decode_plain(out, s24, C) * 2 ** 23).astype(np.int32)
    for what, q, want in (("input", xi, raw), ("output", q_out, out)):
        if (fm.encode_int(q, s24) != want
                or fm.encode_int_plain(q, s24) != want):
            raise SystemExit(f"chip_smoke: the native encode_int of session "
                             f"E's {what} differs from the plain one")
    fb = 3 * C * N
    blocks = [raw[i * fb:(i + 1) * fb] for i in range(len(raw) // fb)]
    qs = [np.ascontiguousarray(xi[:, i * N:(i + 1) * N])
          for i in range(len(blocks))]
    ops = {
        "decode": (blocks, {
            "native": lambda b: fm.decode(b, s24, C, dtype=np.float32),
            "plain": lambda b: fm.decode_plain(b, s24, C,
                                               dtype=np.float32)}),
        "encode_int": (qs, {
            "native": lambda q: fm.encode_int(q, s24),
            "plain": lambda q: fm.encode_int_plain(q, s24)})}
    result = {"format": "S24_LE", "channels": C, "frames_per_block": N,
              "blocks": len(blocks), "rounds": CODEC_ROUNDS,
              "equal": True, "session_e_b_ms_per_block": per}
    for op, (items, fns) in ops.items():
        times = {side: [] for side in fns}
        for side in fns:  # warm: first calls build and page in
            fns[side](items[0])
        for r in range(CODEC_ROUNDS):
            for side in (("native", "plain") if r % 2 == 0
                         else ("plain", "native")):
                t0 = time.perf_counter()
                for it in items:
                    fns[side](it)
                times[side].append((time.perf_counter() - t0) * 1e3
                                   / len(items))
        won = sum(a < b for a, b in zip(times["native"], times["plain"]))
        row = {"native_won": won}
        for side, v in times.items():
            row[f"{side}_ms"] = float(np.median(v))
            row[f"{side}_range_ms"] = [float(min(v)), float(max(v))]
        result[op] = row
        log(f"session E codec: {op} per {N}-frame block of {C} ch S24_LE: "
            f"native {row['native_ms']:.4f} ms (range "
            f"{row['native_range_ms'][0]:.4f}-{row['native_range_ms'][1]:.4f})"
            f", plain {row['plain_ms']:.4f} ms (range "
            f"{row['plain_range_ms'][0]:.4f}-{row['plain_range_ms'][1]:.4f})"
            f", median of {CODEC_ROUNDS} alternating rounds over "
            f"{len(items)} blocks; native faster in {won} of "
            f"{CODEC_ROUNDS}")
    log("session E codec: native and plain bytes equal on the input and "
        "the dithered output, both ways")
    return result


def session_e(cache):
    """Raw PCM through process_raw at the flagship: S24 in, the packed
    engine (K8), per-channel delays 7 c, S24 out with hp-TPDF dither (K9)."""
    import torch

    from bfir_tpu_torch.core.spec import SampleFormat
    from bfir_tpu_torch.engine.session import StreamProcessor
    from bfir_tpu_torch.kernels import spectrum_mac as K
    from bfir_tpu_torch.ops import delay as DL
    from bfir_tpu_torch.ops import formats as fm

    s24, f32 = SampleFormat.S24_LE, SampleFormat.FLOAT_LE
    h = _impulse(14, C)
    path = _write_wav("e.wav", h)
    delays = [7 * c for c in range(C)]
    rng = np.random.default_rng(15)
    total = 96 * N + 333
    # 0.1 RMS input: the output peak stays near 0.3 of full scale
    xi = np.clip(np.round(0.1 * rng.standard_normal((C, total)) * 2 ** 23),
                 -2 ** 23, 2 ** 23 - 1).astype(np.int32)
    raw = fm.encode_int_plain(xi, s24)
    x = xi / 2.0 ** 23
    chunks = [1000, 37, 20000, 4567, 9000, 17 * N + 5, 777]
    chunks.append(total - sum(chunks))

    # (a) the same config with float output: the engine's own error
    sp_a = StreamProcessor(_raw_config(path, "FLOAT_LE", delays, False),
                           cache, device=DEVICE)
    ya = fm.decode_plain(b"".join(_raw_chunks(sp_a, raw, chunks)), f32,
                         C)
    if sp_a._impl != "packed" or tuple(sp_a._coeffs.shape) != (
            TAPS // N, 2 * C, N + 128):
        raise SystemExit(f"chip_smoke: session E engine {sp_a._impl!r}")
    ref = _shifted_ref(x, h, delays, ya.shape[1])
    a_max = float(np.abs(ya - ref).max())
    log(f"session E (a): packed engine, FLOAT_LE out, {ya.shape[1] // N} "
        f"blocks, max |err| {a_max:.3e} ({a_max / LSB24:.3f} LSB24)")
    _snr_gate(_shifted_snr_db(ya, ref), "session E (a), delays shifted")

    # (b) dithered S24 out, timed by phase; the last chunk profiled
    sp = StreamProcessor(_raw_config(path, "S24_LE", delays, True), cache,
                         device=DEVICE)
    t0 = time.perf_counter()
    outs = _raw_chunks(sp, raw, chunks[:1])
    log(f"session E (b): first process_raw() incl. build and self-check "
        f"{time.perf_counter() - t0:.1f} s")
    sp.raw_seconds = dict.fromkeys(sp.raw_seconds, 0.0)
    t0 = time.perf_counter()
    outs += _raw_chunks(sp, raw[3 * C * chunks[0]:], chunks[1:-1])
    wall = time.perf_counter() - t0
    n_blocks = sum(len(o) for o in outs[1:]) // (3 * C * N)
    per = {k: v * 1e3 / n_blocks for k, v in sp.raw_seconds.items()}
    log(f"session E (b): process_raw() {wall * 1e3 / n_blocks:.4f} ms/block "
        f"wall over {n_blocks} blocks in {len(chunks) - 2} calls: "
        + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
        + f" ms/block (C={C}, N={N}, {TAPS} taps, packed, S24 dithered)")
    last = raw[3 * C * sum(chunks[:-1]):]
    outs.append(_device_busy(lambda: sp.process_raw(last),
                             f"session E (b), {chunks[-1]} frames"))
    yb = fm.decode_plain(b"".join(outs), s24, C)
    if yb.shape != ya.shape:
        raise SystemExit(f"chip_smoke: session E (b) shape {yb.shape}")
    _dither_gate(yb, ref, a_max, "session E (b) dithered S24")
    n_of = int(sp.overflow_stats().n_overflows.sum())
    if n_of:
        raise SystemExit(f"chip_smoke: session E clipped {n_of} samples")
    CODEC.update(codec_check(raw, xi, b"".join(outs),
                             dict(per, wall=wall * 1e3 / n_blocks)))

    # (c) a live reconfigure to a second filter and reversed delays
    h2 = _impulse(16, C)
    delays2 = [7 * (C - 1 - c) for c in range(C)]
    state = sp._state
    sp.reconfigure(_raw_config(_write_wav("e2.wav", h2), "S24_LE", delays2,
                               True))
    if sp._pending_swap is None or sp._state.ring is not state.ring:
        raise SystemExit("chip_smoke: session E reconfigure rebuilt")
    x2i = np.clip(np.round(0.1 * rng.standard_normal((C, 24 * N + 100))
                           * 2 ** 23), -2 ** 23, 2 ** 23 - 1).astype(np.int32)
    raw2 = fm.encode_int_plain(x2i, s24)
    k8 = K.mac_packed.launches
    outs2 = _raw_chunks(sp, raw2, [N])  # completes exactly one block
    if K.mac_packed.launches - k8 != 2 or len(outs2[0]) != 3 * C * N:
        raise SystemExit(f"chip_smoke: the crossfade block launched K8 "
                         f"{K.mac_packed.launches - k8} times")
    if (sp._delay_vecs[0].tolist() != delays2
            or sp._state.ring is not state.ring):
        raise SystemExit("chip_smoke: the new delays did not apply live")
    outs2 += _raw_chunks(sp, raw2[3 * C * N:], [5000, 24 * N + 100 - N - 5000])
    y2 = fm.decode_plain(b"".join(outs2), s24, C)
    full = np.concatenate([x, x2i / 2.0 ** 23], axis=1)
    t_sw = yb.shape[1]
    ref2 = _shifted_ref(full, h2, delays2, t_sw + y2.shape[1])[:, t_sw:]
    settle = N + max(delays2)  # the crossfade block, then the old history
    log(f"session E (c): reconfigure: crossfade block launched K8 twice, "
        f"delays changed live; {y2.shape[1]} frames after the change, gated "
        f"from frame {settle}")
    _dither_gate(y2[:, settle:], ref2[:, settle:], a_max,
                 "session E (c) after reconfigure")

    # (d) the fractional delay line on the card against its CPU run
    subs = rng.integers(-15, 16, C)
    lines = {d: DL.FractionalDelayLine(C, max(delays), device=d)
             for d in (DEVICE, "cpu")}
    states = {d: line.init_state() for d, line in lines.items()}
    worst = 0.0
    for blk in rng.standard_normal((4, C, N)).astype(np.float32):
        ys = {}
        for d, line in lines.items():
            states[d], ys[d] = line(states[d], torch.from_numpy(blk).to(d),
                                    torch.tensor(delays), torch.tensor(subs))
        rel = float((ys[DEVICE].cpu() - ys["cpu"]).abs().max()
                    / ys["cpu"].abs().max())
        worst = max(worst, rel)
    log(f"session E (d): FractionalDelayLine on the card vs the CPU: max rel "
        f"err {worst:.2e} (bound 1e-5)")
    if not worst <= 1e-5:
        raise SystemExit("chip_smoke: FractionalDelayLine differs on CUDA")


def _drive_steps(what, engines, x, ref, check=None):
    """160 blocks of x [C, 160 N] through each engine of ``engines`` ({name:
    (step, init, coefficients, kwargs, kernels)}, the first the yardstick),
    on the card, the input already there and the outputs left there. Per
    engine: each wrapper named in ``kernels`` must have launched, the
    worst-channel SNR of its output against ``ref`` (scipy float64), the
    max difference from the yardstick's output, a profile of blocks
    144-159 (device busy ms, kernels and copies per block), and the wall ms
    per block: over blocks 8-143, then over 32 more blocks of each stream
    in each of 8 rounds that take the engines in turn, in forward and
    reverse order alternately (the host clock drifts within a run); the
    rounds give a median and a range. ``check(states)`` runs after the 160
    blocks, before the rounds."""
    import torch

    blocks, warm, prof, rounds, again = 160, 8, 16, 8, 32
    xd = torch.from_numpy(x).to(torch.device(DEVICE))
    states, walls, y0 = {}, {}, None
    first = next(iter(engines))

    def run_blocks(name, a, b, outs=None):
        """Blocks a..b-1 of x through engine ``name``, continuing its
        stream; returns the wall ms per block (synchronised)."""
        step, _, co, kw, _ = engines[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(a, b):
            states[name], y = step(states[name], *co,
                                   xd[:, i * N:(i + 1) * N], **kw)
            if outs is not None:
                outs.append(y)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (b - a)

    for name, (_, init, _, _, names) in engines.items():
        before = {k: w.launches for k, w in _kernels().items()}
        states[name], outs = init(), []
        run_blocks(name, 0, warm, outs)
        walls[name] = [run_blocks(name, warm, blocks - prof, outs)]
        counts = {}
        _device_busy(lambda: run_blocks(name, blocks - prof, blocks, outs),
                     f"{what} {name}, blocks {blocks - prof}-{blocks - 1}",
                     counts)
        launched = {k: w.launches - before[k] for k, w in _kernels().items()}
        for k in names:
            if launched[k] < blocks:
                raise SystemExit(f"chip_smoke: {what} {name} launched {k} "
                                 f"{launched[k]} times in {blocks} blocks")
        y = torch.cat(outs, dim=1)
        if y0 is None:
            y0 = y
        diff = float((y - y0).abs().max() / y0.abs().max())
        yn = y.cpu().numpy()
        if yn.shape != x.shape or not np.isfinite(yn).all():
            raise SystemExit(f"chip_smoke: {what} {name} gave "
                             f"{yn.shape} or non-finite values")
        if counts["busy_ms"] is None:
            device = "device not measured"
        else:
            dev_ms = counts["busy_ms"] / prof
            device = (f"{counts['kernels'] / prof:.2f} kernels and "
                      f"{counts['copies'] / prof:.2f} copies per block, "
                      f"device {dev_ms:.4f} ms/block = "
                      f"{100 * dev_ms / walls[name][0]:.1f}% of that wall")
        log(f"{what} {name}: {walls[name][0]:.4f} ms/block wall (blocks "
            f"{warm}-{blocks - prof - 1}, C={C}, N={N}, {TAPS} taps), "
            f"{device}; max |y - {first}| / max|{first}| {diff:.3e}; "
            "launches " + ", ".join(f"{k} {n}" for k, n in launched.items()
                                    if n))
        _snr_gate(_shifted_snr_db(yn, ref), f"{what} {name}")
        del outs, y
    if check is not None:
        check(states)
    order = list(engines)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            walls[name].append(run_blocks(name, 0, again))
    log(f"{what}: ms/block wall over {rounds} rounds of {again} blocks "
        "per engine (median, min-max): " + "; ".join(
            f"{name} {np.median(w[1:]):.4f} ({min(w[1:]):.4f}-"
            f"{max(w[1:]):.4f})" for name, w in walls.items()))


def _noise_and_ref(impulse_seed, x_seed):
    """A flagship impulse, 160 blocks of seeded noise and scipy's float64
    convolution of the two."""
    h = _impulse(impulse_seed, C)
    x = np.random.default_rng(x_seed).standard_normal((C, 160 * N)).astype(
        np.float32)
    return h, x, _shifted_ref(x, h, [0] * C, x.shape[1])


def session_f():
    """The uniform-step family at the flagship, step_hc beside the four
    other uniform steps (``_drive_steps``; 160 blocks run past P = 128,
    so the rings and the doubled ring's mirror wrap). step_hc2's and
    step_hc_fused's rings must equal step_hc's bit for bit after the 160
    blocks."""
    import torch

    from bfir_tpu_torch.core.spec import FilterSpec
    from bfir_tpu_torch.kernels import spectrum_mac as K

    dev = torch.device(DEVICE)
    spec = FilterSpec(N, n_partitions=TAPS // N, dtype="float32")
    h, x, ref = _noise_and_ref(18, 19)
    hc = K.hc_coeffs(h, spec, C, device=dev)
    pk = K.pack_coeffs(h, spec, C, device=dev)
    split = K.split_coeffs(h, spec, device=dev)
    hc_state = functools.partial(K.init_hc_state, spec, C, device=dev)
    engines = {
        "step_hc": (K.step_hc, hc_state, (hc,), {}, ("mac_hc",)),
        "step_split": (K.step_split, functools.partial(
            K.init_split_state, spec, C, device=dev), split, {},
            ("mac_split",)),
        "step_chunked": (K.step_chunked, functools.partial(
            K.init_doubled_state, spec, C, device=dev),
            (K.chunk_reverse_coeffs(pk, 4),), {"k": 4}, ("mac_chunked",)),
        "step_hc2": (K.step_hc2, hc_state, (hc,), {}, ("mac_hc_insert",)),
        "step_hc_fused": (K.step_hc_fused, hc_state, (hc,), {},
                          ("mac_tail_hc",)),
    }
    del pk

    def rings_equal(states):
        for name in ("step_hc2", "step_hc_fused"):
            if not torch.equal(states[name].ring, states["step_hc"].ring):
                raise SystemExit(f"chip_smoke: session F {name}'s ring "
                                 "differs from step_hc's")
        log("session F: step_hc2's and step_hc_fused's rings equal "
            "step_hc's bit for bit after 160 blocks")

    _drive_steps("session F", engines, x, ref, rings_equal)


def _transform_step(forward, inverse):
    """``step_hc``'s data path with its two transforms swapped: the frame
    [prev | block] through ``forward`` to halfcomplex planes, the planes
    into ring slot pos, K1, the tail through ``inverse``."""
    import torch

    from bfir_tpu_torch.kernels import spectrum_mac as K

    def step(state, coeff_pk, block):
        p, c2, _ = state.ring.shape
        n = block.shape[-1]
        frame = torch.cat([state.prev_block, block], dim=-1)
        hr, hi = forward(frame)
        pos = state.blockcounter % p
        state.ring[pos, :c2 // 2] = hr
        state.ring[pos, c2 // 2:] = hi
        yr, yi = K.mac_hc(state.ring, coeff_pk, pos)
        return (K.HcState(state.ring, frame[:, n:], state.blockcounter + 1),
                inverse(yr, yi, 2 * n))

    return step


def session_g():
    """The FFT family on the step_hc data path at the flagship (n = 2048,
    h = Hp = 1024): (a) step_hc itself, torch.fft both ways (the
    yardstick); (b) K15 + K16; (c) K18 + K17; (d) K14 through
    rfft_split_hc_balanced + K4; each with K1 between (``_drive_steps``).
    The reference's law test (tests/test_kernels.py::
    test_fused_roundtrip_convolution_law) at full width."""
    import torch

    from bfir_tpu_torch.core.spec import FilterSpec
    from bfir_tpu_torch.kernels import fft_fused as FF
    from bfir_tpu_torch.kernels import fft_pallas as FP
    from bfir_tpu_torch.kernels import spectrum_mac as K

    dev = torch.device(DEVICE)
    spec = FilterSpec(N, n_partitions=TAPS // N, dtype="float32")
    h, x, ref = _noise_and_ref(20, 21)
    hc = K.hc_coeffs(h, spec, C, device=dev)
    init = functools.partial(K.init_hc_state, spec, C, device=dev)
    engines = {
        "(a) step_hc, torch.fft": (K.step_hc, init, (hc,), {}, ("mac_hc",)),
        "(b) K15 + K16": (
            _transform_step(FF.rfft_hc_fused, FF.irfft_hc_tail_fused), init,
            (hc,), {}, ("mac_hc", "rfft_hc_fused", "irfft_hc_tail_fused")),
        "(c) K18 + K17": (
            _transform_step(FP.rfft_hc_pallas, FP.irfft_hc_tail_pallas), init,
            (hc,), {}, ("mac_hc", "rfft_hc_pallas", "irfft_hc_tail_pallas")),
        "(d) K14 + K4": (
            _transform_step(FF.rfft_split_hc_balanced,
                            FF.irfft_split_hc_tail_balanced), init, (hc,), {},
            ("mac_hc", "cfft_balanced_fused",
             "irfft_split_hc_tail_balanced")),
    }
    _drive_steps("session G", engines, x, ref)


def _window_ref(x, h, t0, length):
    """scipy's float64 convolution of the stream x [C, T] with the rows of
    h, samples [t0, t0 + length), from the input window that reaches them."""
    from scipy import signal

    a = max(0, t0 - h.shape[1])
    seg = x[:, a:t0 + length].astype(np.float64)
    return np.stack([signal.fftconvolve(seg[c], h[c].astype(np.float64))[
        t0 - a:t0 - a + length] for c in range(x.shape[0])])


def session_h(cache):
    """The extended engine (native float64) at the flagship: 64 ch x
    131072 taps, filter.dtype float64, engine_mode auto. (a) streaming;
    (b) a live crossfade reconfigure; (c) S24 in, dithered S24 out through
    process_raw (K9 at float64); (d) render() through process_buffer."""
    import torch

    from bfir_tpu_torch.core.spec import SampleFormat
    from bfir_tpu_torch.engine.session import StreamProcessor
    from bfir_tpu_torch.kernels import corr_mac as CM
    from bfir_tpu_torch.ops import formats as fm

    h = _impulse(22, C)
    path = _write_wav("h.wav", h)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sp = StreamProcessor(_config(path, dtype="float64"), cache,
                         device=DEVICE)
    rng = np.random.default_rng(23)
    x = rng.standard_normal((C, 32 * N + 123))
    t0 = time.perf_counter()
    y = _stream(sp, x, [1000, 37, 20000])
    log(f"session H: first process() calls incl. build and self-check "
        f"{time.perf_counter() - t0:.1f} s, {y.shape[1] // N} blocks")
    if sp._impl != "extended" or sp._coeffs.dtype != torch.float64:
        raise SystemExit(f"chip_smoke: session H engine {sp._impl!r}")
    if y.dtype != np.float64:
        raise SystemExit(f"chip_smoke: session H output {y.dtype}")
    more = rng.standard_normal((4, C, 64 * N))
    counts = {}
    ms, ys = _timed_blocks(sp, more, "session H (a) extended", counts)
    peak = torch.cuda.max_memory_allocated() - base
    xs = np.concatenate([x, *more], axis=1)
    ys = np.concatenate([y, *ys], axis=1)
    if counts["busy_ms"] is None:
        device = "device not measured"
    else:
        dev_ms = counts["busy_ms"] / 64
        device = (f"device {dev_ms:.4f} ms/block, "
                  f"{counts['kernels'] / 64:.2f} kernels and "
                  f"{counts['copies'] / 64:.2f} copies per block, busy "
                  f"{100 * counts['busy_ms'] / counts['wall_ms']:.1f}%")
    log(f"session H (a): {ys.shape[1] // N} blocks, wall {ms:.4f} ms/block, "
        f"{device}; peak device memory {peak / 2 ** 20:.1f} MiB above the "
        f"{base / 2 ** 20:.1f} MiB before the session (C={C}, N={N}, "
        f"{TAPS} taps, float64)")
    _snr_gate(_worst_snr_db(ys, xs, h), "session H (a) extended",
              MIN_SNR64_DB)

    # (b) a live crossfade to a second filter: the ramp block blends the
    # two filters' outputs linearly, then the new filter alone
    h2 = _impulse(24, C)
    ring = sp._state.ring
    sp.reconfigure(_config(_write_wav("h2.wav", h2), dtype="float64"))
    if sp._pending_swap is None:
        raise SystemExit("chip_smoke: session H reconfigure queued no "
                         "crossfade")
    x2 = rng.standard_normal((C, 8 * N))
    y2 = sp.process(x2)
    if sp._pending_swap is not None or sp._state.ring is not ring:
        raise SystemExit("chip_smoke: session H crossfade rebuilt or did not "
                         "run")
    full = np.concatenate([xs, x2], axis=1)
    t_sw = ys.shape[1]  # the stream's output so far (123 frames pend)
    old = _window_ref(full, h, t_sw, N)
    new = _window_ref(full, h2, t_sw, y2.shape[1])
    ramp = np.arange(N) / (N - 1)
    blend = old * (1 - ramp) + new[:, :N] * ramp
    diff = new[:, :N] - old
    big = np.abs(diff) > 0.1 * np.abs(diff).std()
    w = (y2[:, :N] - old)[big] / diff[big]
    w_err = float(np.abs(w - np.broadcast_to(ramp, diff.shape)[big]).max())
    log(f"session H (b): crossfade block: mixing weight against the linear "
        f"ramp max |err| {w_err:.2e} over {int(big.sum())} samples (bound "
        "1e-9)")
    if not w_err <= 1e-9:
        raise SystemExit("chip_smoke: session H crossfade is not the ramp")
    _snr_gate(_shifted_snr_db(y2[:, :N], blend),
              "session H (b) crossfade block vs the blend", MIN_SNR64_DB)
    _snr_gate(_shifted_snr_db(y2[:, N:], new[:, N:]),
              "session H (b) after the crossfade, new filter", MIN_SNR64_DB)

    # (c) raw S24 in, dithered S24 out at float64 (K9 at float64); the
    # same input through FLOAT64_LE out gives the engine's own error
    s24, f64 = SampleFormat.S24_LE, SampleFormat.FLOAT64_LE
    total = 40 * N + 77
    xi = np.clip(np.round(0.1 * rng.standard_normal((C, total)) * 2 ** 23),
                 -2 ** 23, 2 ** 23 - 1).astype(np.int32)
    raw = fm.encode_int_plain(xi, s24)
    xr = xi / 2.0 ** 23
    chunks = [3000, 17 * N + 5, total - 3000 - 17 * N - 5]
    sp_f = StreamProcessor(_raw_config(path, "FLOAT64_LE", None, False,
                                       "float64", "auto"), cache,
                           device=DEVICE)
    yf = fm.decode_plain(b"".join(_raw_chunks(sp_f, raw, chunks)), f64,
                         C)
    ref = _shifted_ref(xr, h, [0] * C, yf.shape[1])
    a_max = float(np.abs(yf - ref).max())
    log(f"session H (c): FLOAT64_LE out, engine {sp_f._impl}, "
        f"{yf.shape[1] // N} blocks, max |err| {a_max:.3e}")
    _snr_gate(_shifted_snr_db(yf, ref), "session H (c) float64 raw",
              MIN_SNR64_DB)
    del sp_f
    sp_d = StreamProcessor(_raw_config(path, "S24_LE", None, True,
                                       "float64", "auto"), cache,
                           device=DEVICE)
    yd = fm.decode_plain(b"".join(_raw_chunks(sp_d, raw, chunks)), s24,
                         C)
    if (sp_d._impl != "extended"
            or sp_d._dither_state.e0.dtype != torch.float64):
        raise SystemExit(f"chip_smoke: session H (c) engine {sp_d._impl!r}")
    _dither_gate(yd, ref, a_max, "session H (c) dithered S24, float64")
    del sp_d

    # (d) render(): process_buffer, flushed to T frames, no bulk engine
    sp.reset()
    k7 = CM.corr_mac.launches
    xd = rng.standard_normal((C, 24 * N + 500))
    t0 = time.perf_counter()
    yr = sp.render(xd)
    wall = time.perf_counter() - t0
    if (yr.shape != xd.shape or sp._bulk is not None
            or CM.corr_mac.launches != k7):
        raise SystemExit(f"chip_smoke: session H render gave {yr.shape}, "
                         f"bulk {sp._bulk}, K7 launches "
                         f"{CM.corr_mac.launches - k7}")
    log(f"session H (d): render() {xd.shape[1]} frames through "
        f"process_buffer in {wall:.3f} s wall, no K7 launch")
    _snr_gate(_worst_snr_db(yr, xd, h2), "session H (d) render",
              MIN_SNR64_DB)
    return ms


CLIENT_SECONDS = 5.0   # audio a session I client streams, at 44.1 kHz
CLIENT_FRAMES = 4096   # frames per wire frame


def _audio_client(port, x, gate, rts, errors):
    """Stream x [C, T] as FLOAT_LE wire frames of CLIENT_FRAMES frames, one
    reply awaited each; after frame ``gate[0]`` wait twice on the barrier
    ``gate[1]`` (the control change happens between). Fills ``rts`` with
    (frame, round-trip ms, frames back) and returns the output
    [C, <= T]."""
    import socket
    import struct

    from bfir_tpu_torch.core.spec import SampleFormat
    from bfir_tpu_torch.ops import formats as fm

    f32 = SampleFormat.FLOAT_LE
    outs = []
    try:
        sk = socket.create_connection(("127.0.0.1", port), timeout=300)
        sk.sendall((json.dumps({"channels": x.shape[0], "sample_rate": 44100,
                                "in_format": "float_le",
                                "out_format": "float_le"}) + "\n").encode())
        f = sk.makefile("rb")
        hdr = json.loads(f.readline().decode())
        if not hdr.get("ok"):
            raise RuntimeError(f"header refused: {hdr}")
        frame_bytes = 4 * x.shape[0]
        for k, a in enumerate(range(0, x.shape[1], CLIENT_FRAMES)):
            raw = fm.encode_float(x[:, a:a + CLIENT_FRAMES], f32)
            t0 = time.perf_counter()
            sk.sendall(struct.pack("<I", len(raw)) + raw)
            (n,) = struct.unpack("<I", f.read(4))
            outs.append(f.read(n))
            rts.append((k, (time.perf_counter() - t0) * 1e3,
                        n // frame_bytes))
            if k == gate[0]:
                gate[1].wait()
                gate[1].wait()
        sk.sendall(struct.pack("<I", 0))
        (n,) = struct.unpack("<I", f.read(4))
        f.read(n)
        sk.close()
    except Exception as e:  # reported by the caller
        errors.append(repr(e))
        gate[1].abort()
    return (fm.decode_plain(b"".join(outs), f32, x.shape[0]) if outs
            else None)


def session_i(cache):
    """The servers at the flagship: one ConfigStore, a ControlServer and an
    AudioServer on the card (64 ch x 131072 taps, float32, auto, so the
    nonuniform engine); two clients stream at once, and between two of
    their frames a control client sets a second impulse (F1FN, the
    attenuation probe on the card) and an EQ band."""
    import socket
    import threading

    from bfir_tpu_torch.cli.audio_server import AudioServer
    from bfir_tpu_torch.cli.server import ControlServer
    from bfir_tpu_torch.cli.store import ConfigStore
    from bfir_tpu_torch.core.spec import level_steps_to_linear
    from bfir_tpu_torch.ops.noise import calculate_attenuation

    h = _impulse(25, C)
    h2 = _impulse(26, C)
    path, path2 = _write_wav("i.wav", h), _write_wav("i2.wav", h2)
    cfg = _config(path)
    store = ConfigStore(cfg, device=DEVICE)
    audio = AudioServer(cfg, host="127.0.0.1", port=0, store=store,
                        cache=cache, device=DEVICE)
    ctl = ControlServer(store, host="127.0.0.1", port=0, default_dir=WORK)
    rng = np.random.default_rng(27)
    n_in = int(CLIENT_SECONDS * 44100)
    xs = [(0.1 * rng.standard_normal((C, n_in))).astype(np.float32)
          for _ in range(2)]
    n_frames = -(-n_in // CLIENT_FRAMES)
    switch = n_frames // 2 - 1  # the change comes after this frame
    barrier = threading.Barrier(3, timeout=600)
    rts = [[], []]
    errors, ys = [], [None, None]
    audio.start()
    ctl.start()
    try:
        def client(i):
            ys[i] = _audio_client(audio.port, xs[i], (switch, barrier),
                                  rts[i], errors)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        barrier.wait()
        sessions = list(audio._sessions)
        with socket.create_connection(("127.0.0.1", ctl.port),
                                      timeout=300) as sk:
            replies, secs = [], []
            for cmd in (f"F1FN {path2}", "EQM0 50", "EQM0"):
                t0 = time.perf_counter()
                sk.sendall(cmd.encode() + b"\r")
                buf = b""
                while not buf.endswith(b"\r"):
                    chunk = sk.recv(4096)
                    if not chunk:
                        break
                    buf += chunk
                secs.append(time.perf_counter() - t0)
                replies.append(buf[:-1].decode())
        barrier.wait()
        for t in threads:
            t.join(600)
    finally:
        audio.stop()
        ctl.stop()
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"chip_smoke: session I client errors {errors}")
    if replies != ["OK", "OK", "50"]:
        raise SystemExit(f"chip_smoke: session I control replies {replies}")
    if (len(sessions) != 2 or any(s._impl != "nonuniform" for s in sessions)
            or store.device.type != DEVICE):
        raise SystemExit("chip_smoke: session I sessions "
                         f"{[s._impl for s in sessions]}")
    steps = store.get_file_level(1)
    t0 = time.perf_counter()
    att = calculate_attenuation(h2, block_length=N, dtype="float32",
                                device=DEVICE)
    probe_s = time.perf_counter() - t0
    log(f"session I: F1FN round trip {secs[0]:.3f} s (the probe on the card "
        f"and both sessions' reconfigure), EQM0 50 {secs[1]:.3f} s; the "
        f"probe alone {probe_s:.3f} s on the card, {att:.4f} dB; level set "
        f"{steps} steps")
    if steps != int(att * 10):
        raise SystemExit(f"chip_smoke: session I level {steps} != probe "
                         f"{att:.4f} dB")
    nu = sessions[0]._nuspec
    settle = (nu.ratio * (nu.delay_blocks + 2) + nu.p_head) * N
    t_sw = (switch + 1) * CLIENT_FRAMES
    g2 = level_steps_to_linear(steps)
    for i in range(2):
        y, x = ys[i], xs[i]
        times = [ms for k, ms, _ in rts[i][1:]]
        rate = sum(n for _, _, n in rts[i][1:]) / (sum(times) / 1e3)
        log(f"session I client {i}: {y.shape[1]} frames x {C} ch back of "
            f"{n_in} sent in {n_frames} wire frames of {CLIENT_FRAMES}; "
            f"round trip per frame p50 {np.percentile(times, 50):.3f} ms, "
            f"p99 {np.percentile(times, 99):.3f} ms over frames 1-"
            f"{n_frames - 1} (frame 0, with the session's build and "
            f"self-check, {rts[i][0][1] / 1e3:.2f} s); {rate:.0f} frames/s "
            f"over those frames ({rate / 44100:.1f} x real time)")
        _snr_gate(_worst_snr_db(y[:, :t_sw], x, h),
                  f"session I client {i} before the change")
        after = _window_ref(x, h2 * g2, t_sw + settle,
                            y.shape[1] - t_sw - settle)
        _snr_gate(_shifted_snr_db(y[:, t_sw + settle:], after),
                  f"session I client {i} after the change (from frame "
                  f"{settle} on)")


def _long_stream(sp, what, x, more, singles, fires, spike):
    """Stream x [C, T] through sp.process in uneven chunks, then the
    64-block chunks ``more`` (``_timed_blocks``: wall ms/block and one
    profiled call), then two super-cycles (64 blocks) of ``singles``
    [B, C, N] one block per call from a super-cycle boundary on, the wall
    of each call classed by ``fires(blockcounter)``. Logs each class's
    median wall and the ``spike`` class's mean wall in each super-cycle
    against the super-cycle's mean. Returns (ms/block, profiled-call
    counts, input, output)."""
    import torch

    y = _stream(sp, x, [1000, 37, 20000, 4567, 100000])
    counts = {}
    ms, ys = _timed_blocks(sp, more, what, counts, taps=TAPS3)
    align = (-sp._state.head.blockcounter) % 64
    ys.append(sp.process(singles[:align].transpose(1, 0, 2).reshape(C, -1)))
    walls = []
    for blk in singles[align:align + 128]:
        kind = fires(sp._state.head.blockcounter)
        t0 = time.perf_counter()
        ys.append(sp.process(blk))
        walls.append((kind, (time.perf_counter() - t0) * 1e3))
    torch.cuda.synchronize()
    by_kind = {}
    for kind, w in walls:
        by_kind.setdefault(kind, []).append(w)
    ratios = []
    for cycle in (walls[:64], walls[64:]):
        mean = float(np.mean([w for _, w in cycle]))
        ratios.append(float(np.mean([w for k, w in cycle if k == spike]))
                      / mean)
    log(f"{what}: process() wall ms per single-block call (median over 2 "
        "super-cycles): " + ", ".join(
            f"{k} {np.median(v):.4f} ({len(v)} blocks)"
            for k, v in by_kind.items())
        + f"; {spike} blocks = {ratios[0]:.2f}, {ratios[1]:.2f} x their "
        f"super-cycle's mean wall ({np.mean([w for _, w in walls]):.4f} ms "
        "over both)")
    used = 128 + align
    xs = np.concatenate([x, *more, singles[:used].transpose(1, 0, 2).reshape(
        C, -1)], axis=1)
    return ms, counts, xs, np.concatenate([y, *ys], axis=1)


def _device_line(counts, blocks=64):
    if counts["busy_ms"] is None:
        return "device not measured"
    return (f"device {counts['busy_ms'] / blocks:.4f} ms/block, "
            f"{counts['kernels'] / blocks:.2f} kernels and "
            f"{counts['copies'] / blocks:.2f} copies per block, busy "
            f"{100 * counts['busy_ms'] / counts['wall_ms']:.1f}%")


_J = {}  # session J's impulse and inputs, and each engine's processor


def _j_inputs():
    """Session J's impulse (written as a WAV) and inputs, made once."""
    if not _J:
        tau = TAPS3 / 5.0  # the far stage (taps >= 147 456) holds 10% of it
        rng = np.random.default_rng(31)
        _J.update(
            h=_impulse(30, C, TAPS3, tau), tau=tau, rng=rng,
            x=rng.standard_normal((C, 576 * N + 321)).astype(np.float32),
            more=rng.standard_normal((4, C, 64 * N)).astype(np.float32),
            singles=rng.standard_normal((192, C, N)).astype(np.float32))
        _J["path"] = _write_wav("j.wav", _J["h"])
    return _J


def _j_stream(cache, tag, mode):
    """One engine of session J: built under ``mode``, its engine and
    geometry asserted, then ``_long_stream``: wall and device ms/block, the
    fire blocks' walls, peak device memory, SNR against scipy float64.
    Returns (processor, output)."""
    import torch

    from bfir_tpu_torch.engine.session import StreamProcessor

    j = _j_inputs()
    what = f"session J {tag}"
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sp = StreamProcessor(_config(j["path"], mode=mode), cache, device=DEVICE)
    t0 = time.perf_counter()
    sp.process(j["x"][:, :N])
    log(f"{what}: first process() call incl. build and self-check "
        f"{time.perf_counter() - t0:.1f} s")
    nu = sp._nuspec
    if mode == "auto":
        geom = ((nu.p_head, nu.block_length), (nu.inner.p_head, nu.m1),
                (nu.inner.p_tail, nu.inner.m), nu.inner.tail_store)
        want = ((16, N), (16, 8 * N), (8, 64 * N), "float32")
        fires = (lambda cnt: "far fire" if cnt % 64 == 63
                 else "mid fire" if cnt % 8 == 7 else "head only")
        spike, impl = "far fire", "nonuniform3"
    else:
        geom = ((nu.p_head, nu.block_length), (nu.p_tail, nu.m),
                nu.tail_store)
        want = ((16, N), (78, 8 * N), "int24")
        fires = (lambda cnt: "tail fire" if cnt % 8 == 7
                 else "head only")
        spike, impl = "tail fire", "nonuniform"
    if sp._impl != impl or geom != want:
        raise SystemExit(f"chip_smoke: {what} engine {sp._impl!r} {nu}")
    log(f"{what}: engine {sp._impl}, {nu}")
    sp.reset()
    ms, counts, xs, ys = _long_stream(sp, what, j["x"], j["more"],
                                      j["singles"], fires, spike)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"{what}: {ys.shape[1] // N} blocks, wall {ms:.4f} ms/block, "
        f"{_device_line(counts)}; peak device memory "
        f"{peak / 2 ** 20:.1f} MiB above the {base / 2 ** 20:.1f} MiB "
        f"before the session (C={C}, N={N}, {TAPS3} taps)")
    _snr_gate(_worst_snr_db(ys, xs, j["h"]), what)
    return sp, ys


def session_j(cache):
    """The three-stage engine at 64 ch x 655 360 taps (640 partitions, the
    threshold where auto takes it), float32: (a) streaming: SNR, wall and
    device ms/block, the far-fire block's wall; (c) process_buffer over two
    super-cycles equals process; (d) a live reconfigure: the staged
    transition in place, converged. The processor stays in ``_J`` for
    ``session_j_rounds``."""
    sp, y = _j_stream(cache, "(a) nonuniform3", "auto")
    j = _J
    x, rng = j["x"], j["rng"]

    # (c) two super-cycles through process_buffer
    sp.reset()
    yb = sp.process_buffer(x[:, :128 * N])
    diff = float(np.abs(yb - y[:, :128 * N]).max())
    log(f"session J (c): process_buffer (2 super-cycles) vs process "
        f"max abs diff {diff:.3e}")
    if not diff <= REL_TOL * float(np.abs(y[:, :128 * N]).max()):
        raise SystemExit("chip_smoke: session J process_buffer disagrees "
                         "with process")

    # (d) a live reconfigure: the staged transition runs in place
    h2 = _impulse(32, C, TAPS3, j["tau"])
    state = sp._state
    far_ring = state.tail.tail.ring
    sp.reconfigure(_config(_write_wav("j2.wav", h2)))
    if sp._pending_swap is None or sp._state is not state:
        raise SystemExit("chip_smoke: session J reconfigure queued no "
                         "transition, or rebuilt")
    x2 = rng.standard_normal((C, 560 * N)).astype(np.float32)
    outs, done_at = [], None
    t0 = time.perf_counter()
    for k in range(0, 560, 8):
        outs.append(sp.process(x2[:, k * N:(k + 8) * N]))
        if done_at is None and sp._nu_old is None:
            done_at = k + 8
    wall = time.perf_counter() - t0
    y2 = np.concatenate(outs, axis=1)
    if (done_at is None or done_at > 72 or sp._nu3_stage is not None
            or sp._state.tail.tail.ring is not far_ring):
        raise SystemExit(f"chip_smoke: session J transition did not complete "
                         f"in place within a super-cycle (done after "
                         f"{done_at} blocks)")
    log(f"session J (d): transition complete after <= {done_at} blocks (in "
        f"8-block calls), 560 blocks in {wall:.3f} s wall, no rebuild")
    full = np.concatenate([x[:, :128 * N], x2], axis=1)
    t_end = 128 * N + y2.shape[1]
    ref = _window_ref(full, h2, t_end - 32 * N, 32 * N)
    _snr_gate(_shifted_snr_db(y2[:, -32 * N:], ref),
              "session J (d) the last 32 blocks, new filter")
    j["sp (a)"] = sp


def session_j_two_stage(cache):
    """Session J (b): the same impulse through the two-stage engine (auto's
    int24 tail), the other side of auto's choice at 640 partitions. The
    processor stays in ``_J`` for ``session_j_rounds``."""
    _J["sp (b)"], _ = _j_stream(cache, "(b) nonuniform", "nonuniform")


def session_j_rounds():
    """Wall ms/block of session J's two engines, and of the two-stage
    engine's bulk scans, in 8 rounds of 64 blocks that take the candidates in turn, in
    forward and reverse order alternately (the host clock drifts within a
    run); the rounds give a median and a range. (1) ``process()`` in
    64-block host calls, the three-stage engine against the two-stage one;
    (2) the two-stage ``process_buffer``'s scans on device input from an
    M-cycle boundary: ``process_blocks_nu_fast`` against the step loop.
    Timing only: these launches are not a path's."""
    import torch

    from bfir_tpu_torch.core import nonuniform as NU
    from bfir_tpu_torch.engine.session import _scan

    rounds, blocks = 8, 64
    sp3, sp2 = _J.pop("sp (a)"), _J.pop("sp (b)")
    rng = np.random.default_rng(33)
    xh = rng.standard_normal((C, blocks * N)).astype(np.float32)
    xd = torch.from_numpy(xh.reshape(C, blocks, N).transpose(1, 0, 2).copy()
                          ).to(torch.device(DEVICE))

    for blk in xd[:(-sp2._state.head.blockcounter) % 8]:
        sp2._state, _ = NU.step_nu(sp2._state, sp2._coeffs, blk)

    def bulk(sp, scan):
        def run():
            sp._state, y = scan(sp._state, sp._coeffs, xd)
            return y
        return run

    groups = {
        "process()": {"nonuniform3": lambda: sp3.process(xh),
                      "nonuniform (int24 tail)": lambda: sp2.process(xh)},
        "two-stage scan": {
            "process_blocks_nu_fast": bulk(sp2, NU.process_blocks_nu_fast),
            "step_nu loop": bulk(sp2, lambda st, co, xb: _scan(
                NU.step_nu, st, co, xb))},
    }
    for group, fns in groups.items():
        _alternate(f"session J rounds, {group}", fns, rounds, blocks, TAPS3)
    del sp3, sp2
    torch.cuda.empty_cache()


def _alternate(what, fns, rounds, blocks, taps):
    """Wall ms/block of the two candidates ``fns`` (name -> a call over
    ``blocks`` blocks) in ``rounds`` rounds that take them in turn, forward
    and reverse alternately, after one warm-up call each; logs the median,
    the range and the rounds the first one won. Returns {name: walls}."""
    import torch

    walls = {name: [] for name in fns}
    for fn in fns.values():  # warm-up
        fn()
    order = list(fns)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3 / blocks)
    first, second = walls.values()
    wins = sum(a < b for a, b in zip(first, second))
    log(f"{what}: ms/block wall over {rounds} rounds of {blocks} blocks "
        f"each (median, min-max; C={C}, N={N}, {taps} taps): " + "; ".join(
            f"{name} {np.median(w):.4f} ({min(w):.4f}-{max(w):.4f})"
            for name, w in walls.items())
        + f"; {order[0]} faster in {wins} of {rounds} rounds")
    return walls


_K = {}  # session K's processors and inputs, for session_k_rounds


def _launch_counts():
    return {name: k.launches for name, k in _kernels().items()}


def _k_phase(what, names, fn, *args):
    """fn(*args) inside a path, with the launches it adds logged; each
    kernel in ``names`` must be among them."""
    before = _launch_counts()
    res = fn(*args)
    got = {k: n - before[k] for k, n in _launch_counts().items()
           if n != before[k]}
    for name in names:
        if not got.get(name):
            raise SystemExit(f"chip_smoke: {what} did not launch {name}")
    log(f"{what}: launches " + ", ".join(f"{k} {n}" for k, n in got.items()))
    return res


def _uncounted(fn, *args):
    """fn(*args) inside a path with the launch counts it adds taken back: a
    comparison run, not the path's."""
    saved = _launch_counts()
    try:
        return fn(*args)
    finally:
        for name, k in _kernels().items():
            k.launches = saved[name]


def _k_stages(eng, st):
    """(stage block counters, stage block lengths) of a sharded engine's
    state: each counter counts its stage's fires."""
    if eng.local_impl == "nonuniform3":
        nu = eng.nuspec
        return ((st.head.blockcounter, st.tail.head.blockcounter,
                 st.tail.tail.blockcounter), (N, nu.m1, nu.inner.m))
    if eng.local_impl == "nonuniform":
        return ((st.head.blockcounter, st.tail.blockcounter),
                (N, eng.nuspec.m))
    return (st.blockcounter,), (N,)


def _comm_gate(what, eng, state, fn, *args):
    """fn(*args) (plain streaming blocks on sharded engine ``eng``, whose
    current state ``state()`` returns) with the collective counter reset
    before it and held after it to the comm model (parallel/COMM_MODEL.md):
    one ppermute and one psum per stage fire, each of 2·(C/c)·Hp·4 bytes,
    the fires counted from the block range (every R-th block, every
    r1·r2-th for the far stage). Any mismatch fails the run. On a mesh
    that spans processes the counts are this process's. Returns fn's
    result."""
    from bfir_tpu_torch.parallel import mesh as M

    c_l = C // eng.mesh.shape["c"]
    cnt0, widths = _k_stages(eng, state())
    M.reset_comm_counts()
    res = fn(*args)
    got = M.comm_counts()
    cnt1, _ = _k_stages(eng, state())
    blocks = range(cnt0[0], cnt1[0])
    period = [1, 8, 64][:len(widths)]
    fires = [sum(1 for k in blocks if k % q == q - 1) for q in period]
    if [b - a for a, b in zip(cnt0, cnt1)] != fires:
        raise SystemExit(f"chip_smoke: {what} stage fires "
                         f"{[b - a for a, b in zip(cnt0, cnt1)]} != {fires}")
    sizes = [2 * c_l * (-(-w // 128) * 128) * 4 for w in widths]
    want = {"calls": sum(fires),
            "bytes": sum(f * b for f, b in zip(fires, sizes))}
    log(f"{what}: collectives over {len(blocks)} blocks: ppermute "
        f"{got['ppermute']['calls']} calls {got['ppermute']['bytes']} B, psum "
        f"{got['psum']['calls']} calls {got['psum']['bytes']} B; the model "
        f"{want['calls']} calls {want['bytes']} B each (per collective: "
        + ", ".join(f"{b} B x {f}" for b, f in zip(sizes, fires))
        + f"; {want['bytes'] / len(blocks):.0f} B a block)")
    if got != {"ppermute": want, "psum": want}:
        raise SystemExit(f"chip_smoke: {what} collectives {got} differ from "
                         f"the comm model {want}")
    return res


def _k_session(cache, what, path, mesh, local="auto"):
    """A sharded session of ``path`` at the flagship: built by its first
    process() call (self-check included), reset. Returns (processor, device
    memory before it)."""
    import dataclasses

    import torch

    from bfir_tpu_torch.engine.session import StreamProcessor

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(_config(path, mode="sharded"),
                              sharded_local=local)
    sp = StreamProcessor(cfg, cache, device=DEVICE, mesh=mesh)
    t0 = time.perf_counter()
    sp.process(np.zeros((C, N), np.float32))
    eng = sp._sharded
    log(f"{what}: first process() call incl. build and self-check "
        f"{time.perf_counter() - t0:.1f} s; mesh {eng.mesh.shape['c']} x "
        f"{eng.mesh.shape['p']} of {[str(d) for d in eng.mesh.devices.flat]}, "
        f"local engine {eng.local_impl}, {eng.nuspec or eng.spec}")
    sp.reset()
    return sp, base


def _k_measure(what, sp, base, x, more, h, taps=TAPS):
    """Stream x in uneven chunks, then ``_timed_blocks`` over ``more``
    (wall and device ms/block) under the comm gate; SNR against scipy and
    peak device memory. Returns (output of x, wall ms/block)."""
    import torch

    y = _stream(sp, x, [1000, 37, 20000, 4567])
    counts = {}
    ms, ys = _comm_gate(what, sp._sharded, lambda: sp._state, _timed_blocks,
                        sp, more, what, counts, taps)
    peak = torch.cuda.max_memory_allocated() - base
    xs = np.concatenate([x, *more], axis=1)
    log(f"{what}: {xs.shape[1] // N} blocks, wall {ms:.4f} ms/block, "
        f"{_device_line(counts)}; peak device memory "
        f"{peak / 2 ** 20:.1f} MiB above the {base / 2 ** 20:.1f} MiB "
        f"before the session (C={C}, N={N}, {taps} taps)")
    _snr_gate(_worst_snr_db(np.concatenate([y, *ys], axis=1), xs, h), what)
    return y, ms


def _k_ring_copies(sp):
    """Bytes a block that the out-of-place ring advance copies (read and
    written once each), all shards, amortized over the stage cadences."""
    eng = sp._sharded
    st = sp._state
    rings = ([st.head.ring, st.tail.ring] if eng.local_impl == "nonuniform"
             else [st.spectra_ring])
    total = 0.0
    for ring, q in zip(rings, (1, 8)):
        total += sum(t.numel() * t.element_size() for t in ring.flat) / q
    return total


def session_k(cache):
    """The sharded engine at the flagship (64 ch x 131072 taps, N = 1024,
    float32) through ``StreamProcessor(..., engine_mode="sharded",
    mesh=...)``, the mesh's shards repeated on the one card: (a) (1, 4),
    auto -> the two-stage local engine (head 16, tail 14 padded to 16; K1
    every block, K2 + K4 every 8th): SNR, the difference from
    single-device ``nonuniform`` (float32 tail) on the same input, wall
    and device ms/block, peak memory, the comm gate; (b) the same on a (2,
    2) mesh; (c) ``sharded_local="uniform"`` (hc local, K1) at (1, 4);
    (f) ``process_buffer`` equals ``process``; (e) a live reconfigure on
    (a), converged past the settle span; (g) ``mesh=None``, every visible
    GPU. Session K (d), the three-stage local engine, is a path of its own
    (``session_k_nu3``)."""
    import torch

    from bfir_tpu_torch.engine.session import StreamProcessor

    h = _impulse(50, C)
    path = _write_wav("k.wav", h)
    rng = np.random.default_rng(51)
    x = rng.standard_normal((C, 288 * N + 333)).astype(np.float32)
    more = rng.standard_normal((4, C, 64 * N)).astype(np.float32)
    nu_kernels = ("mac_hc", "mac_hc_tiled", "irfft_split_hc_tail_balanced")
    _K.update(path=path, h=h)

    def nu_mesh(tag, c_s, p_s):
        what = f"session K ({tag}) sharded {c_s} x {p_s}"
        sp, base = _k_session(cache, what, path, _k_mesh(c_s, p_s))
        nu = sp._nuspec
        p_tail = -(-(TAPS - 16 * N) // (8 * N))  # 14 at the flagship
        if (sp._sharded.local_impl != "nonuniform"
                or (nu.p_head, nu.p_tail, nu.m, nu.tail_store)
                != (16, -(-p_tail // p_s) * p_s, 8 * N, "float32")):
            raise SystemExit(f"chip_smoke: {what} built "
                             f"{sp._sharded.local_impl} {nu}")
        y, ms = _k_phase(what, nu_kernels, _k_measure, what, sp, base, x,
                         more, h)
        log(f"{what}: the out-of-place ring advance copies "
            f"{_k_ring_copies(sp) / 1e6:.1f} MB a block over all shards "
            "(read + written: twice that in traffic)")
        return sp, y

    sp_a, y_a = nu_mesh("a", 1, 4)

    # the same input through single-device nonuniform (float32 tail)
    def single():
        sp1 = StreamProcessor(_config(path, "float32", mode="nonuniform"),
                              cache, device=DEVICE)
        return sp1, _stream(sp1, x, [1000, 37, 20000, 4567])

    sp1, y1 = _uncounted(single)
    diff = float(np.abs(y_a - y1).max())
    rel = diff / float(np.abs(y1).max())
    log(f"session K (a): max |sharded - single-device nonuniform (float32 "
        f"tail)| {diff:.3e} (rel {rel:.2e}) over {y1.shape[1] // N} blocks")
    if not rel <= REL_TOL:
        raise SystemExit("chip_smoke: session K (a) differs from the "
                         "single-device engine")

    # (f) process_buffer over 64 aligned blocks == process from the start
    sp_a.reset()
    aligned = 64 * N
    yb = sp_a.process_buffer(x[:, :aligned])
    diff = float(np.abs(yb - y_a[:, :aligned]).max())
    log(f"session K (f): process_buffer vs process max abs diff {diff:.3e}")
    if not diff <= REL_TOL * float(np.abs(y_a[:, :aligned]).max()):
        raise SystemExit("chip_smoke: session K process_buffer disagrees "
                         "with process")

    # (e) a live reconfigure: the two-phase crossfade converges
    h2 = _impulse(52, C)
    pre = rng.standard_normal((C, 3 * N + 100)).astype(np.float32)
    y_pre = sp_a.process(pre)
    state = sp_a._state
    sp_a.reconfigure(_config(_write_wav("k2.wav", h2), mode="sharded"))
    if sp_a._pending_swap is None:
        raise SystemExit("chip_smoke: session K reconfigure queued no "
                         "crossfade")
    nu = sp_a._nuspec
    settle = (nu.ratio * (nu.delay_blocks + 2) + nu.p_head) * N
    x2 = rng.standard_normal((C, settle + 32 * N)).astype(np.float32)
    y2 = _k_phase("session K (e)", ("mac_hc", "mac_hc_tiled"),
                  sp_a.process, x2)
    if sp_a._nu_old is not None or sp_a._state is state:
        raise SystemExit("chip_smoke: session K crossfade did not complete")
    full = np.concatenate([x[:, :aligned], pre, x2], axis=1)
    t0 = aligned + y_pre.shape[1]
    ref = _window_ref(full, h2, t0 + settle, y2.shape[1] - settle)
    _snr_gate(_shifted_snr_db(y2[:, settle:], ref),
              "session K (e) after reconfigure (past the settle span)")
    _K.update(sp_a=sp_a, sp1=sp1)

    nu_mesh("b", 2, 2)

    what = "session K (c) sharded 1 x 4, uniform local"
    sp_c, base = _k_session(cache, what, path, _k_mesh(1, 4), "uniform")
    if sp_c._sharded.local_impl != "hc":
        raise SystemExit(f"chip_smoke: {what} built "
                         f"{sp_c._sharded.local_impl}")
    _k_phase(what, ("mac_hc",), _k_measure, what, sp_c, base,
             x[:, :96 * N], more, h)
    log(f"{what}: the out-of-place ring advance copies "
        f"{_k_ring_copies(sp_c) / 1e6:.1f} MB a block over all shards")
    del sp_c

    what = "session K (g) mesh=None"
    t0 = time.perf_counter()
    cfg = _config(path, mode="sharded")
    sp_g = StreamProcessor(cfg, cache, device=DEVICE)
    y_g = _k_phase(what, nu_kernels, _stream, sp_g, x[:, :96 * N], [5000])
    mesh = sp_g._sharded.mesh
    log(f"{what}: the default mesh is {mesh.shape['c']} x "
        f"{mesh.shape['p']} over {torch.cuda.device_count()} visible GPU(s) "
        f"({[str(d) for d in mesh.devices.flat]}), local engine "
        f"{sp_g._sharded.local_impl}; {time.perf_counter() - t0:.1f} s")
    if mesh.devices.size != torch.cuda.device_count():
        raise SystemExit(f"chip_smoke: {what} mesh {mesh}")
    _snr_gate(_worst_snr_db(y_g, x[:, :y_g.shape[1]], h), what)
    torch.cuda.empty_cache()


def _k_mesh(c_s, p_s):
    from bfir_tpu_torch.parallel import mesh as M

    return M.make_mesh(c_s, p_s, devices=[DEVICE] * (c_s * p_s))


def session_k_nu3(cache):
    """Session K (d): ``sharded_local="nonuniform3"`` at session J's
    geometry (64 ch x 655 360 taps) on a (1, 4) mesh: J's inputs through
    ``_long_stream`` (uneven chunks, 64-block calls, two super-cycles one
    block a call; many far fires) under the comm gate; SNR, wall and device
    ms/block, peak memory. The processor stays in ``_K`` for the rounds."""
    import torch

    j = _j_inputs()
    what = "session K (d) sharded 1 x 4, nonuniform3"
    sp, base = _k_session(cache, what, j["path"], _k_mesh(1, 4),
                          "nonuniform3")
    nu = sp._nuspec
    geom = ((nu.p_head, nu.block_length), (nu.inner.p_head, nu.m1),
            (nu.inner.p_tail, nu.inner.m), nu.inner.tail_store)
    if (sp._sharded.local_impl != "nonuniform3"
            or geom != ((16, N), (16, 8 * N), (8, 64 * N), "float32")):
        raise SystemExit(f"chip_smoke: {what} built "
                         f"{sp._sharded.local_impl} {nu}")
    fires = (lambda cnt: "far fire" if cnt % 64 == 63
             else "mid fire" if cnt % 8 == 7 else "head only")
    ms, counts, xs, ys = _comm_gate(what, sp._sharded, lambda: sp._state,
                                    _long_stream, sp, what, j["x"],
                                    j["more"], j["singles"], fires,
                                    "far fire")
    peak = torch.cuda.max_memory_allocated() - base
    far = ys.shape[1] // (64 * N)
    log(f"{what}: {ys.shape[1] // N} blocks ({far} far fires), wall "
        f"{ms:.4f} ms/block, {_device_line(counts)}; peak device memory "
        f"{peak / 2 ** 20:.1f} MiB above the {base / 2 ** 20:.1f} MiB before "
        f"the session (C={C}, N={N}, {TAPS3} taps)")
    if far < 2:
        raise SystemExit(f"chip_smoke: {what} ran {far} far fires")
    _snr_gate(_worst_snr_db(ys, xs, j["h"]), what)
    _K["sp_d"] = sp


def session_k_rounds():
    """Wall ms/block in 8 alternating rounds of 64 blocks (``_alternate``;
    timing only, these launches are not a path's): (1) ``process()`` of
    session K (a) (the sharded two-stage engine on a (1, 4) mesh) against
    the same filter on single-device ``nonuniform`` (float32 tail); (2) the
    sharded engines' ``process_blocks`` on device input from a cycle
    boundary, their macro steps against their step loops: the two-stage
    engine (K a) and the three-stage one (K d)."""
    import torch

    sp_a, sp1, sp_d = _K.pop("sp_a"), _K.pop("sp1"), _K.pop("sp_d")
    rng = np.random.default_rng(53)
    blocks = 64
    xh = rng.standard_normal((C, blocks * N)).astype(np.float32)
    xd = torch.from_numpy(xh.reshape(C, blocks, N).transpose(1, 0, 2).copy()
                          ).to(torch.device(DEVICE))
    _alternate("session K rounds, process()",
               {"sharded 1 x 4 nonuniform": lambda: sp_a.process(xh),
                "nonuniform (float32 tail)": lambda: sp1.process(xh)},
               8, blocks, TAPS)

    def bulk(sp, macro):
        eng = sp._sharded
        cyc = eng._cycle_len()
        for blk in xd[:(-sp._state.head.blockcounter) % cyc]:
            sp._state, _ = eng.step(sp._state, sp._coeffs, blk)

        def run():
            if macro:
                sp._state, y = eng.process_blocks(sp._state, sp._coeffs, xd)
                return y
            for blk in xd:
                sp._state, y = eng.step(sp._state, sp._coeffs, blk)
            return y
        return run

    for tag, sp, taps in (("two-stage (K a)", sp_a, TAPS),
                          ("three-stage (K d)", sp_d, TAPS3)):
        _alternate(f"session K rounds, sharded {tag} bulk",
                   {"process_blocks (macro steps)": bulk(sp, True),
                    "step loop": bulk(sp, False)}, 8, blocks, taps)
    del sp_a, sp1, sp_d
    torch.cuda.empty_cache()


# Session L: the sharded engine on meshes that span two processes
L_BLOCKS = 320      # blocks a phase: 2 x 64 one step a call, then 192
                    # through process_blocks
L_TIMEOUT = 120.0   # seconds a worker waits on its peer before it fails
L_REL_TOL = 1e-6    # against the one-process engine on the same mesh shape
_NU_KERNELS = ("mac_hc", "mac_hc_tiled", "irfft_split_hc_tail_balanced")
# (tag, mesh shape, local engine, the kernels its phase must launch)
L_PHASES = (("a", (1, 4), "nonuniform", _NU_KERNELS),
            ("a", (2, 2), "nonuniform", _NU_KERNELS),
            ("b", (1, 4), "hc", ("mac_hc",)),
            ("c", (1, 4), "nonuniform3", _NU_KERNELS))


def _l_inputs(local):
    """A phase's impulse (session K's; session J's 655 360 taps for
    nonuniform3) and its blocks [L_BLOCKS, C, N]."""
    h = (_impulse(30, C, TAPS3, TAPS3 / 5.0) if local == "nonuniform3"
         else _impulse(50, C, TAPS))
    rng = np.random.default_rng(54)
    return h, rng.standard_normal((L_BLOCKS, C, N)).astype(np.float32)


def _l_engine(mesh, local, h):
    from bfir_tpu_torch.core.spec import FilterSpec
    from bfir_tpu_torch.parallel import sharded as SH

    eng = SH.ShardedEngine(FilterSpec(N, h.shape[1] // N, "float32"), C,
                           mesh, local_impl=local)
    return eng, eng.prepare_coeffs(h)


def _l_drive(eng, co, x, holder):
    """Blocks x [B, C, N] (host) through ``eng`` from ``holder["st"]``: the
    first 64 one ``step`` a call (the first calls of every kernel, plan and
    connection among them), the next 64 the same, the rest through
    ``process_blocks`` (the macro steps). Returns (outputs [B, C, N] on the
    host, wall ms/block of each part, CUDA-event span ms/block of each
    part)."""
    import torch

    xs = torch.from_numpy(x)
    outs, wall, span = [], [], []
    for part, macro in ((xs[:64], False), (xs[64:128], False),
                        (xs[128:], True)):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        if macro:
            holder["st"], y = eng.process_blocks(holder["st"], co, part)
        else:
            ys = []
            for blk in part:
                holder["st"], y = eng.step(holder["st"], co, blk)
                ys.append(y)
            y = torch.stack(ys)
        e1.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3 / len(part))
        span.append(e0.elapsed_time(e1) / len(part))
        outs.append(y.cpu().numpy())
    return np.concatenate(outs), wall, span


def _l_phases(backend):
    return L_PHASES if backend == "gloo" else L_PHASES[:2]


def _l_file(backend, tag, shape):
    return os.path.join(WORK, f"l_{backend}_{tag}_{shape[0]}x{shape[1]}.npy")


def session_l_worker(port, rank, backend, geometry):
    """One rank of session L, in a process of its own (``session_l``
    starts two): joins the group (``init_distributed`` with ``backend``;
    under gloo each rank owns two shards on the first card, under NCCL on
    card ``rank``), zeroes the launch counts, drives every phase of
    ``_l_phases`` on ``make_mesh`` over both ranks under the comm gate,
    and prints its numbers as the last line, a JSON object. Rank 0 saves
    each phase's output for the parent's gates. ``geometry``: the parent's
    C, N, TAPS, TAPS3, DEVICE and WORK."""
    import hashlib

    import torch

    from bfir_tpu_torch.parallel import mesh as M

    global C, N, TAPS, TAPS3, DEVICE, WORK
    C, N, TAPS, TAPS3, DEVICE, WORK = (
        geometry[k] for k in ("C", "N", "TAPS", "TAPS3", "DEVICE", "WORK"))
    card = f"{DEVICE}:{rank if backend == 'nccl' else 0}"
    M.init_distributed(f"localhost:{port}", 2, rank, backend=backend,
                       local_device_ids=[card, card], timeout=L_TIMEOUT)
    try:
        for k in _kernels().values():
            k.launches = 0
        phases = {}
        for tag, shape, local, names in _l_phases(backend):
            what = (f"session L ({tag}) {backend} {shape[0]} x {shape[1]} "
                    f"{local}, rank {rank}")
            h, x = _l_inputs(local)
            eng, co = _l_engine(M.make_mesh(*shape), local, h)
            holder = {"st": eng.init_state()}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y, wall, span = _k_phase(what, names, _comm_gate, what, eng,
                                     lambda: holder["st"], _l_drive, eng, co,
                                     x, holder)
            cross = M.cross_process_bytes()
            phases[f"{tag} {shape[0]}x{shape[1]}"] = {
                "wall_ms": wall, "span_ms": span,
                "peak_mib": (torch.cuda.max_memory_allocated() - base)
                / 2 ** 20,
                "cross": cross, "sha256": hashlib.sha256(
                    y.tobytes()).hexdigest()}
            log(f"{what}: {eng.mesh}; cross-process bytes {cross}")
            if rank == 0:
                np.save(_l_file(backend, tag, shape), y)
            del eng, co, holder
            torch.cuda.empty_cache()
        launches = {n: k.launches for n, k in _kernels().items()
                    if k.launches}
        print(json.dumps({"rank": rank, "phases": phases,
                          "launches": launches}), flush=True)
    finally:
        M.shutdown_distributed()


def _l_workers(backend):
    """Both ranks of ``backend``'s run; their logs relayed. A worker that
    fails or outlasts its time fails the run. Returns the two reports."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    geometry = dict(C=C, N=N, TAPS=TAPS, TAPS3=TAPS3, DEVICE=DEVICE,
                    WORK=WORK)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke."
         f"session_l_worker({port}, {rank}, {backend!r}, {geometry!r})"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    reports = []
    try:
        for rank, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=900)
            lines = out.strip().splitlines()
            for line in lines[:-1]:
                log(f"  [rank {rank}] {line}")
            if proc.returncode or not lines:
                raise SystemExit(f"chip_smoke: session L rank {rank} "
                                 f"({backend}) failed, exit "
                                 f"{proc.returncode}:\n{out[-3000:]}")
            reports.append(json.loads(lines[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"session L ({backend}): both ranks done in "
        f"{time.perf_counter() - t0:.1f} s")
    return reports


def _l_one_process(shape, local, h, x):
    """The one-process sharded engine on the same mesh shape (its shards
    repeating the card, as session K's) over the same blocks."""
    from bfir_tpu_torch.parallel import mesh as M

    eng, co = _l_engine(M.make_mesh(*shape, devices=[DEVICE] * 4), local, h)
    return _l_drive(eng, co, x, {"st": eng.init_state()})


def _l_times(ph):
    """A phase's walls and CUDA-event spans, ms/block, by part."""
    return ", ".join(
        f"{part} wall {w:.4f} span {e:.4f}" for part, w, e in zip(
            ("one step a call (first 64, warm-up)", "one step a call",
             "process_blocks"), ph["wall_ms"], ph["span_ms"])) + " ms/block"


def session_l():
    """The sharded engine on meshes that span two processes, at the
    flagship (64 ch x 131072 taps, N = 1024, float32): two worker processes
    (``session_l_worker``) under ``init_distributed(..., backend="gloo")``,
    each owning two shards on the card, run (a) the two-stage local engine
    on a (1, 4) and a (2, 2) mesh, (b) the hc local engine at (1, 4) and
    (c) nonuniform3 at session J's 655 360 taps at (1, 4), each 128 blocks
    one step a call and 192 through ``process_blocks``, under the comm gate
    on each rank. Gates: both ranks' outputs equal, worst-channel SNR
    against scipy, the max relative difference from the one-process engine
    on the same mesh shape and input (bit-equality logged). Logged: each
    rank's wall and CUDA-event ms/block, peak memory and the bytes that
    crossed between the processes, beside the one-process engine's walls.
    Where two cards or more are visible, (a)
    runs again under NCCL, one rank a card. Returns the workers' launch
    counts, summed."""
    import torch

    backends = ["gloo"]
    if torch.cuda.device_count() >= 2:
        backends.append("nccl")
    else:
        log("session L: the NCCL phase did not run: "
            f"{torch.cuda.device_count()} visible GPU, and NCCL refuses two "
            "ranks on one card")
    total, refs = {}, {}
    for backend in backends:
        reports = _l_workers(backend)
        for rep in reports:
            for name, n in rep["launches"].items():
                total[name] = total.get(name, 0) + n
        for tag, shape, local, _ in _l_phases(backend):
            key = f"{tag} {shape[0]}x{shape[1]}"
            what = (f"session L ({tag}) {backend} {shape[0]} x {shape[1]} "
                    f"{local}")
            for rep in reports:
                ph = rep["phases"][key]
                log(f"{what}, rank {rep['rank']}: {_l_times(ph)}; peak device "
                    f"memory {ph['peak_mib']:.1f} MiB; "
                    "cross-process bytes a block sent/received: " + ", ".join(
                        f"{k} {v['sent'] / L_BLOCKS:.0f}/"
                        f"{v['received'] / L_BLOCKS:.0f}"
                        for k, v in ph["cross"].items()))
            if reports[0]["phases"][key]["sha256"] != \
                    reports[1]["phases"][key]["sha256"]:
                raise SystemExit(f"chip_smoke: {what}: the ranks' outputs "
                                 "differ")
            y = np.load(_l_file(backend, tag, shape))
            h, x = _l_inputs(local)
            if (shape, local) not in refs:
                ref, wall, span = _uncounted(_l_one_process, shape, local, h,
                                             x)
                refs[shape, local] = ref
                log(f"{what}: the one-process engine on the same mesh shape: "
                    + _l_times({"wall_ms": wall, "span_ms": span}))
            ref = refs[shape, local]
            rel = float(np.abs(y - ref).max()) / float(np.abs(ref).max())
            log(f"{what}: max |multi-process - one-process| / max|one-process|"
                f" {rel:.3e} (bound {L_REL_TOL:g}), "
                f"{'bit-equal' if np.array_equal(y, ref) else 'not bit-equal'}"
                f" over {L_BLOCKS} blocks")
            if not rel <= L_REL_TOL:
                raise SystemExit(f"chip_smoke: {what} differs from the "
                                 "one-process engine")
            xs = x.transpose(1, 0, 2).reshape(C, -1)
            _snr_gate(_worst_snr_db(y.transpose(1, 0, 2).reshape(C, -1), xs,
                                    h), what)
    del refs
    torch.cuda.empty_cache()
    return total


def checkpoint_resume():
    """A complex-engine stream on the card with K9's dither: saved after 5
    blocks (``engine.checkpoint``), loaded and resumed; outputs and
    dithered samples bit-equal to the uninterrupted run, so the CUDA
    generator's state crosses the file."""
    import torch

    from bfir_tpu_torch.core import convolver as cv
    from bfir_tpu_torch.core.spec import FilterSpec
    from bfir_tpu_torch.engine import checkpoint as CK
    from bfir_tpu_torch.ops import dither as dth

    spec = FilterSpec(N, TAPS // N, "float32")
    co = cv.coeffs_to_spectra(_impulse(40, C), spec, device=DEVICE)
    rng = np.random.default_rng(41)
    x = (0.1 * rng.standard_normal((10, C, N))).astype(np.float32)

    def run(st, dst, of, blocks):
        ys, qs = [], []
        for blk in blocks:
            st, y = cv.step(st, co, torch.from_numpy(blk).to(DEVICE))
            q, dst, of = dth.quantize_hp_tpdf(y * 2.0 ** 23, -2.0 ** 23,
                                              2.0 ** 23 - 1, dst, of)
            ys.append(y.cpu().numpy())
            qs.append(q.cpu().numpy())
        return st, dst, of, np.concatenate(ys, 1), np.concatenate(qs, 1)

    st, dst, of, _, _ = run(cv.init_state(spec, C, device=DEVICE),
                            dth.init_dither_state(C, seed=11, device=DEVICE),
                            dth.init_overflow_stats(C, device=DEVICE), x[:5])
    path = os.path.join(WORK, "checkpoint.npz")
    CK.save_state(path, st, dst, of)
    _, _, of_a, ya, qa = run(st, dst, of, x[5:])
    st_b, dst_b, of_b = CK.load_state(path, device=DEVICE)
    if dst_b.generator.device.type != torch.device(DEVICE).type:
        raise SystemExit("chip_smoke: checkpoint generator not on the card")
    _, _, of_b, yb, qb = run(st_b, dst_b, of_b, x[5:])
    same = (np.array_equal(ya, yb) and np.array_equal(qa, qb)
            and all(torch.equal(a, b) for a, b in zip(of_a, of_b)))
    log(f"checkpoint: saved after 5 blocks, resumed for 5 ({C} ch, P "
        f"{TAPS // N}, K9 dither): outputs and dithered samples "
        f"{'bit-equal' if same else 'DIFFER'}; {os.path.getsize(path)} "
        "bytes")
    if not same:
        raise SystemExit("chip_smoke: checkpoint resume differs")


M_BUDGET_MS = N_M / 44.1  # one 64-frame block at 44.1 kHz: 1.451 ms
M_REL_F32, M_REL_F64 = 1e-5, 1e-12  # session M (b): error over the peak
M_PHASE_TOL = 1e-6  # session M (d): pinned against the counter's phase


def _queued_ms(fn, reps=8, what="call"):
    """Device ms per call of fn from CUDA events, with the host's launch
    latency out of the span: a spin kernel holds the stream while the host
    queues ``reps`` calls between two events. The spin must outlast the
    queueing (the first event still pending when the last call is queued).
    A full launch queue (about a thousand kernels and copies) blocks the
    host until the spin ends, so ``reps`` x fn's launches stay below it;
    where the spin ended first, the calls are queued again behind a spin 4
    x longer, ``TRIES`` times at most, and then the time is not measured
    (None). fn must not wait on the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = LEAD_CYCLES
    for _ in range(TRIES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        early = a.query()
        b.synchronize()
        if not early:
            return a.elapsed_time(b) / reps
        log(f"{what}: the spin ended before {reps} calls were queued; "
            "queueing again behind a longer spin")
        cycles *= 4
    log(f"{what}: device time not measured (the spin never outlasted "
        "the queueing)")
    return None


def _ms(v, digits=4):
    return "not measured" if v is None else f"{v:.{digits}f}"


def _m_stepper(sp, blocks):
    """A fresh two-stage state on sp's geometry and coefficients, and a
    function that steps it one block of ``blocks`` (device, [B, C, N],
    cycled) per call through ``step_nu``; it returns the state holder."""
    from bfir_tpu_torch.core import nonuniform as NU

    held = {"st": NU.init_nu_state(sp._nuspec, C, device=DEVICE), "i": 0}

    def step(phase=None):
        blk = blocks[held["i"] % blocks.shape[0]]
        held["st"], held["y"] = NU.step_nu(held["st"], sp._coeffs, blk,
                                           phase)
        held["i"] += 1

    return held, step


def session_m(cache):
    """``engine_mode="nonuniform_split"`` at N = 64 (the block where the
    split schedule's bands do not fit, so the session builds ``nonuniform``)
    at the flagship width, then the reference API the port gained with it:
    (a) streaming, (b) the ``ops/fft`` transforms, (c) ``BlockTimer`` and
    ``trace``, (d) ``step_nu(phase=)``."""
    m = session_m_stream(cache)
    session_m_fft()
    session_m_profiling(m)
    session_m_phases(m)


def session_m_stream(cache):
    """(a) 64 ch x 131072 taps at N = 64, float32: the engine and geometry
    gated, about 2270 blocks streamed (uneven chunks, 128-block calls, then
    32 M-cycles one block a call), worst channel >= 110 dB; wall ms/block in
    bulk and single-block calls by phase against the real-time budget,
    launches a block, device ms/block (CUDA events), peak memory."""
    import torch

    from bfir_tpu_torch.engine.session import StreamProcessor

    what = "session M (a)"
    h = _impulse(50, C)
    cfg = _config(_write_wav("m.wav", h), mode="nonuniform_split",
                  block=N_M)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sp = StreamProcessor(cfg, cache, device=DEVICE)
    rng = np.random.default_rng(51)
    x = rng.standard_normal((C, 1500 * N_M + 29)).astype(np.float32)
    t0 = time.perf_counter()
    y = _stream(sp, x, [1000, 37, 20000, 4567, 50000])
    log(f"{what}: first process() calls incl. build and self-check "
        f"{time.perf_counter() - t0:.1f} s, {y.shape[1] // N_M} blocks")
    nu = sp._nuspec
    geom = ((nu.p_head, nu.block_length), (nu.p_tail, nu.m), nu.tail_store)
    want = ((M_GEOM[0], N_M), (M_GEOM[1], M_GEOM[3]), "int24")
    if sp._impl != "nonuniform" or geom != want:
        raise SystemExit(f"chip_smoke: {what} engine {sp._impl!r} {nu}")
    log(f"{what}: engine_mode nonuniform_split at N = {N_M} built "
        f"{sp._impl}, {nu}")
    more = rng.standard_normal((4, C, 128 * N_M)).astype(np.float32)
    times, outs = [], []
    for chunk in more[:3]:
        t1 = time.perf_counter()
        outs.append(sp.process(chunk))
        times.append((time.perf_counter() - t1) * 1e3 / 128)
    bulk = float(np.median(times))
    counts = {}
    outs.append(_device_busy(lambda: sp.process(more[3]), what, counts))
    # one block a call, from phase 0 on, each wall classed by its phase
    ratio = nu.ratio
    pend = sp._pending.shape[1]
    k = (-sp._state.head.blockcounter) % ratio or (ratio if pend else 0)
    lead = rng.standard_normal((C, k * N_M - pend)).astype(np.float32)
    outs.append(sp.process(lead))
    if sp._nu_phase() != 0 or sp._pending.shape[1]:
        raise SystemExit(f"chip_smoke: {what} not at a cycle boundary")
    singles = rng.standard_normal((32 * ratio, C, N_M)).astype(np.float32)
    per_phase = [[] for _ in range(ratio)]
    launched = {name: f.launches for name, f in _kernels().items()}
    for blk in singles:
        phase = sp._nu_phase()
        t1 = time.perf_counter()
        outs.append(sp.process(blk))
        per_phase[phase].append((time.perf_counter() - t1) * 1e3)
    per_block = {name: (f.launches - launched[name]) / len(singles)
                 for name, f in _kernels().items()
                 if f.launches > launched[name]}
    med = [float(np.median(v)) for v in per_phase]
    mean = float(np.mean(med))
    stream = np.concatenate(
        [x, *more, lead, singles.transpose(1, 0, 2).reshape(C, -1)], axis=1)
    ys = np.concatenate([y, *outs], axis=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"{what}: process() wall {bulk:.4f} ms/block in 128-block calls "
        f"(median of 3), {_device_line(counts, 128)}; single-block calls by "
        f"phase (median of 32): " + ", ".join(f"{v:.4f}" for v in med)
        + f" ms, worst {max(med):.4f} = {max(med) / mean:.2f} x the mean "
        f"{mean:.4f}; budget {M_BUDGET_MS:.4f} ms a {N_M}-frame block at "
        f"44.1 kHz: bulk {bulk / M_BUDGET_MS:.2f} x, worst phase "
        f"{max(med) / M_BUDGET_MS:.2f} x; kernel launches a block "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_block.items())
        + f"; peak device memory {peak / 2 ** 20:.1f} MiB above the "
        f"{base / 2 ** 20:.1f} MiB before the session")
    dev_blocks = torch.from_numpy(singles[:64]).to(DEVICE)
    _, step = _m_stepper(sp, dev_blocks)
    dev_ms = _queued_ms(step, reps=2 * ratio, what="step_nu")
    log(f"{what}: step_nu device {_ms(dev_ms)} ms/block (CUDA events over "
        f"{2 * ratio} queued blocks, 2 tail fires)")
    _snr_gate(_worst_snr_db(ys, stream[:, :ys.shape[1]], h), what)
    log(f"{what}: {ys.shape[1] // N_M} blocks streamed, "
        f"{ys.shape[1] / TAPS:.2f} filter lengths")
    if ys.shape[1] // N_M < 2200:
        raise SystemExit(f"chip_smoke: {what} streamed too few blocks")
    return sp


def session_m_fft():
    """(b) ``ops/fft``'s generic and leading-axis transforms on the card at
    the engines' shapes, complex64 and complex128, each against numpy's
    float64 transform of the same input (error over the peak <= 1e-5 and
    1e-12), with each call's device us (CUDA events, queued calls)."""
    import torch

    from bfir_tpu_torch.core import convolver as cv
    from bfir_tpu_torch.ops import fft as F

    rng = np.random.default_rng(52)
    p, b = TAPS // N, 32
    rows, ln = b + 2 * (p - 1), cv.batch_fft_len(b, p)  # 286 -> 512

    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    big = cplx(rows, C, N + 1)       # process_batch's [L, C, F]
    full = cplx(ln, C, N + 1)        # its padded block-axis spectrum
    wide = cplx(C, 2 * N)
    half = {n: np.fft.rfft(rng.standard_normal((C, n)), axis=-1)
            for n in (2 * N, 16 * N)}
    sel = (p - 1, b)  # process_batch keeps rows [P - 1, P - 1 + B)
    cases = [
        (f"fft axis 0 {list(big.shape)} n {ln}", (big,),
         lambda y: F.fft(y, n=ln, axis=0),
         lambda: np.fft.fft(big, n=ln, axis=0)),
        (f"ifft axis 0 {list(full.shape)}", (full,),
         lambda y: F.ifft(y, axis=0), lambda: np.fft.ifft(full, axis=0)),
        (f"cfft_split {list(wide.shape)} cols (1000, 48)",
         (wide.real, wide.imag),
         lambda r, i: torch.complex(*F.cfft_split(r, i, cols=(1000, 48))),
         lambda: np.fft.fft(wide, axis=-1)[:, 1000:1048]),
        (f"fft0_split {list(big.shape)} n {ln} inverse rows {sel}",
         (big.real, big.imag),
         lambda r, i: torch.complex(*F.fft0_split(r, i, n=ln, inverse=True,
                                                  rows=sel)),
         lambda: np.fft.ifft(big, n=ln, axis=0)[sel[0]:sum(sel)]),
        (f"ifft0_slice {list(full.shape)} {sel}", (full,),
         lambda y: F.ifft0_slice(y, *sel),
         lambda: np.fft.ifft(full, axis=0)[sel[0]:sum(sel)]),
    ]
    for n, y in half.items():
        cases += [
            (f"irfft_split_tail {list(y.shape)} n {n}", (y.real, y.imag),
             lambda r, i, n=n: F.irfft_split_tail(r, i, n=n),
             lambda y=y, n=n: np.fft.irfft(y, n=n, axis=-1)[:, n // 2:]),
            (f"irfft_tail {list(y.shape)} n {n}", (y,),
             lambda y, n=n: F.irfft_tail(y, n=n),
             lambda y=y, n=n: np.fft.irfft(y, n=n, axis=-1)[:, n // 2:])]
    for name, args, fn, ref in cases:
        want = ref()
        peak = float(np.abs(want).max())
        for tol, cdt, rdt in ((M_REL_F32, np.complex64, np.float32),
                              (M_REL_F64, np.complex128, np.float64)):
            dev = [F.from_numpy_complex(
                a.astype(cdt if np.iscomplexobj(a) else rdt), device=DEVICE)
                for a in args]
            got = F.to_numpy(fn(*dev))
            if got.shape != want.shape:
                raise SystemExit(f"chip_smoke: session M (b) {name} shape "
                                 f"{got.shape} != {want.shape}")
            rel = float(np.abs(got - want).max()) / peak
            ms = _queued_ms(lambda: fn(*dev), what=name)
            log(f"session M (b): {name} {np.dtype(cdt).name}: error "
                f"{rel:.2e} of the peak (bound {tol:.0e}), device "
                f"{_ms(None if ms is None else ms * 1e3, 2)} us a call "
                "(CUDA events, 8 queued calls)")
            if not rel <= tol:
                raise SystemExit(f"chip_smoke: session M (b) {name} "
                                 f"{np.dtype(cdt).name} error {rel:.2e}")
            del dev


def session_m_profiling(sp):
    """(c) ``utils.profiling`` on the card: ``BlockTimer.measure(state)``
    around 64 ``step_nu`` calls waits for the device (its p50 is not below
    the CUDA-event span of the same calls; ``measure()`` without a result
    logged beside it), and ``trace`` around 8 steps writes a trace file
    (its CUDA kernel events counted, not gated: the profiler loses
    events)."""
    import torch

    from bfir_tpu_torch.utils import profiling as P

    rng = np.random.default_rng(53)
    blocks = torch.from_numpy(rng.standard_normal(
        (64, C, N_M)).astype(np.float32)).to(DEVICE)
    held, step = _m_stepper(sp, blocks)
    step()
    torch.cuda.synchronize()
    waits, bare, spans = P.BlockTimer(), P.BlockTimer(), []
    for _ in range(64):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with waits.measure(held["st"]):
            a.record()
            step()
            b.record()
        spans.append(a.elapsed_time(b))
    for _ in range(64):
        with bare.measure():
            step()
    torch.cuda.synchronize()
    p_wait, p_bare = waits.percentiles()[50] * 1e3, bare.percentiles()[50] * 1e3
    span = float(np.median(spans))
    log(f"session M (c): BlockTimer.measure(state) around step_nu p50 "
        f"{p_wait:.4f} ms, CUDA-event span of the same calls {span:.4f} ms "
        f"(median), measure() without a result p50 {p_bare:.4f} ms "
        f"(64 calls each)")
    if not p_wait >= span:
        raise SystemExit("chip_smoke: session M (c) BlockTimer.measure(result)"
                         " stopped before the device")
    log_dir = os.path.join(WORK, "trace")
    with P.trace(log_dir) as prof:
        for _ in range(8):
            step()
        torch.cuda.synchronize()
    files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    if len(files) != 1 or not os.path.getsize(files[0]):
        raise SystemExit(f"chip_smoke: session M (c) trace wrote {files}")
    from torch.autograd import DeviceType

    n_dev = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    log(f"session M (c): trace of 8 step_nu calls: "
        f"{os.path.basename(files[0])}, {os.path.getsize(files[0])} bytes, "
        f"{n_dev} CUDA kernel events (not gated)")


def session_m_phases(sp):
    """(d) ``step_nu(phase=)`` on the card: two states stepped alike, one
    pinned at phase 0 and later R - 1, the other on its counter, give the
    same block (<= 1e-6 of the peak); then each pinned phase's CUDA-event
    ms a call (single calls, and 8 queued calls: device only)."""
    import torch

    from bfir_tpu_torch.core import nonuniform as NU

    rng = np.random.default_rng(54)
    ratio = sp._nuspec.ratio
    blocks = torch.from_numpy(rng.standard_normal(
        (3 * ratio, C, N_M)).astype(np.float32)).to(DEVICE)
    a = NU.init_nu_state(sp._nuspec, C, device=DEVICE)
    b = NU.init_nu_state(sp._nuspec, C, device=DEVICE)
    for i in range(3 * ratio):
        phase = i % ratio
        pin = phase if phase in (0, ratio - 1) and i >= 2 * ratio else None
        a, ya = NU.step_nu(a, sp._coeffs, blocks[i])
        b, yb = NU.step_nu(b, sp._coeffs, blocks[i], phase=pin)
        if pin is None:
            continue
        rel = float((ya - yb).abs().max()) / float(ya.abs().max())
        log(f"session M (d): step_nu(phase={pin}) against the counter's "
            f"phase {phase}: max difference {rel:.2e} of the peak")
        if not rel <= M_PHASE_TOL:
            raise SystemExit(f"chip_smoke: session M (d) phase {pin} "
                             f"differs: {rel:.2e}")
    single, queued = [], []
    for k in range(ratio):
        held, step = _m_stepper(sp, blocks)
        single.append(_event_ms(lambda: step(k)))
        queued.append(_queued_ms(lambda: step(k), what=f"step_nu phase {k}"))
    log("session M (d): step_nu(phase=k) CUDA-event ms a call, k = 0.."
        f"{ratio - 1}: single calls (median of 20) "
        + ", ".join(f"{v:.4f}" for v in single) + "; device, 8 queued "
        "calls: " + ", ".join(_ms(v) for v in queued)
        + f"; budget {M_BUDGET_MS:.4f} ms")
    # the fire phase's tail MAC (K3 on the session's int24 tail) alone, on
    # the stepped state's ring: its share of the fire phase's device time
    ring = held["st"].tail.ring
    tail_ms = _uncounted(_queued_ms, lambda: NU._tail_mac(
        ring, sp._coeffs.tail, 0), 8, "tail MAC")
    fire = queued[-1]
    share = ("not measured" if None in (tail_ms, fire)
             else f"{100 * tail_ms / fire:.1f}%")
    log(f"session M (d): the tail MAC (K3 on the int24 tail "
        f"{list(ring.hi.shape)}) alone {_ms(tail_ms)} ms device (8 queued "
        f"calls), {share} of the fire phase's {_ms(fire)} ms")


def main():
    preflight()
    from bfir_tpu_torch.engine.cache import ArtifactCache

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    build()
    kernels = check_kernels()

    cache = ArtifactCache(os.path.join(WORK, "profile"))
    paths = [
        ("session A", ("mac_hc", "mac_hc_tiled_int",
                       "irfft_split_hc_tail_balanced"), session_a, cache),
        ("session B", ("mac_hc", "mac_hc_tiled",
                       "irfft_split_hc_tail_balanced"), session_b, cache),
        ("session C", ("mac_hc", "mac_hc_band_int",
                       "irfft_split_hc_tail_balanced"), session_c, cache),
        ("session D", ("corr_mac", "irfft_split_hc_tail_balanced"),
         session_d, cache),
        ("render (split)", ("mac_hc", "mac_hc_band",
                            "irfft_split_hc_tail_balanced"), render_split),
        ("render (batch)", (), render_short),
        ("session E", ("mac_packed", "quantize_hp_tpdf"), session_e, cache),
        ("session F", ("mac_hc", "mac_split", "mac_chunked", "mac_hc_insert",
                       "mac_tail_hc"), session_f),
        ("session G", ("mac_hc", "cfft_balanced_fused", "rfft_hc_fused",
                       "irfft_hc_tail_fused", "irfft_hc_tail_pallas",
                       "rfft_hc_pallas", "irfft_split_hc_tail_balanced"),
         session_g),
        ("session H", ("quantize_hp_tpdf",), session_h, cache),
        ("session I", ("mac_hc", "mac_hc_tiled_int",
                       "irfft_split_hc_tail_balanced"), session_i, cache),
        ("session J", ("mac_hc", "mac_hc_tiled",
                       "irfft_split_hc_tail_balanced"), session_j, cache),
        ("session J (b)", ("mac_hc", "mac_hc_tiled_int",
                           "irfft_split_hc_tail_balanced"),
         session_j_two_stage, cache),
        ("session K", ("mac_hc", "mac_hc_tiled",
                       "irfft_split_hc_tail_balanced"), session_k, cache),
        ("session K (d)", ("mac_hc", "mac_hc_tiled",
                           "irfft_split_hc_tail_balanced"), session_k_nu3,
         cache),
        ("checkpoint", ("quantize_hp_tpdf",), checkpoint_resume),
    ]
    total = dict.fromkeys(kernels, 0)
    for what, names, fn, *args in paths:
        counts = run_path(what, names, fn, *args)
        for name, n in counts.items():
            total[name] += n
    # session L's paths run in its worker processes, each counting its own
    for name, n in session_l().items():
        total[name] += n
    for name, n in run_path("session M", ("mac_hc", "mac_hc_tiled_int"),
                            session_m, cache).items():
        total[name] += n
    for name, n in total.items():
        if n == 0:
            raise SystemExit(f"chip_smoke: {name} never ran on the main paths")
    session_j_rounds()
    session_k_rounds()
    render_cli()
    # K9's plain version launches 25602 kernels a call: a trace of that
    # many makes later traces lose events (_traced), so it is timed after
    # every other trace, over one call, in a process of its own
    k9 = kernels["quantize_hp_tpdf"]
    variant = k9.pop("plain")
    res = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.time_k9_plain()"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    out = res.stdout.strip().splitlines()
    for line in out[:-1]:
        log(f"time_k9_plain: {line}")
    if res.returncode or not out:
        raise SystemExit(f"chip_smoke: timing K9's plain version failed "
                         f"(exit {res.returncode}):\n{res.stderr[-3000:]}")
    got = json.loads(out[-1])
    k9["plain_ms"] = got["plain_ms"]
    log(f"kernel quantize_hp_tpdf [{variant}]: plain {k9['plain_ms']:.4f} "
        f"ms (profiler, 1 call, a process of its own), CUDA-event "
        f"{got['event_ms']:.4f} ms; the kernel {k9['ms']:.4f} ms")

    rows = []
    for name, k in kernels.items():
        src, rep = KERNEL_SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": total[name],
                     "max_abs_err": k["err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
        if "also" in k:  # the same kernel timed at a second shape
            rows[-1]["also"] = k["also"]
    import torch

    if not CODEC:
        raise SystemExit("chip_smoke: session E's codec phase did not run")
    print(json.dumps({"card": CARD, "codec": CODEC}), flush=True)
    print(json.dumps({"card": CARD, "kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
