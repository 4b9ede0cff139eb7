"""The cinema deployment's path (64 speaker feeds, 65 536 taps, N = 128,
float32, 48 kHz: ``nonuniform`` with a float32 head of 16 partitions and
an int24 tail of 62 partitions of 8N) at a small size with the same
ratios: 4 ch x 4096 taps at N = 16, a 16-partition head and a
30-partition tail of 128. ``engine_mode`` and the tail tier are forced,
since ``auto`` on the CPU builds ``complex``, so the CPU runs the card's
path through the kernels' plain versions. The session is held to a plain
float64 linear convolution, and its engine's spans and fire counter are
checked."""

import numpy as np
import pytest
import torch

from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

N = 16
TAPS = 4096
CHANNELS = 4
RATE = 48000
FRAMES = 2 * TAPS + 40 * N
# float32 transforms and MACs read about 1.9e-7 against the float64
# convolution at this size, and the int24 tail's block-scaled rounding
# (2^-23 of each row's scale) adds little to that (about 2.1e-7 in all);
# int16's 2^-15 rounding reads about 2.3e-5. The tolerance sits a decade
# from each.
REL_TOL = 2e-6


def _impulse(tmp_path, seed):
    """A decaying-noise room response [C, TAPS], float32, each row of L2
    norm 0.5 (the benchmark's law at a small size), and its WAV."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((CHANNELS, TAPS)) * np.exp(
        -np.arange(TAPS) / 512.0)
    h = (0.5 * h / np.linalg.norm(h, axis=1, keepdims=True)).astype(
        np.float32)
    path = str(tmp_path / f"h{seed}.wav")
    wavio.write(path, h.T, RATE, subtype="float32")
    return h, path


def _session(tmp_path, wav, store):
    cfg = TS.EngineConfig(
        filter=TS.FilterSpec(N, dtype="float32"),
        stream=TS.StreamSpec(n_channels=CHANNELS, sample_rate=RATE),
        chain=TS.ChainSpec(files=(
            TS.ImpulseFileSpec(enabled=True, filename=wav),
            TS.ImpulseFileSpec(), TS.ImpulseFileSpec())),
        engine_mode="nonuniform", nu_tail_store=store)
    return StreamProcessor(cfg, ArtifactCache(str(tmp_path / "cache")),
                           device="cpu")


def _linear(x, h):
    """The first x.shape[1] outputs of each row's linear convolution, in
    float64 through NumPy's FFT."""
    nfft = 1 << (x.shape[1] + h.shape[1]).bit_length()
    spec = (np.fft.rfft(x.astype(np.float64), nfft)
            * np.fft.rfft(h.astype(np.float64), nfft))
    return np.fft.irfft(spec, nfft)[:, :x.shape[1]]


def _one_block(total):
    return [N] * (total // N)


def _uneven(total):
    sizes, out = (5, 37, 16, 100, 1, 64), []
    while sum(out) < total:
        out.append(min(sizes[len(out) % len(sizes)], total - sum(out)))
    return out


def _rel_err(tmp_path, store, chunks, seed=1):
    h, wav = _impulse(tmp_path, seed)
    sp = _session(tmp_path, wav, store)
    x = (0.1 * np.random.default_rng(seed + 100).standard_normal(
        (CHANNELS, FRAMES))).astype(np.float32)
    outs, t = [], 0
    for k in chunks(FRAMES):
        outs.append(sp.process(x[:, t:t + k], RATE))
        t += k
    y = np.concatenate(outs, axis=1)
    assert sp._impl == "nonuniform"
    assert sp._nuspec == NU.NuSpec(N, 8, 16, 30, "float32", store, "float32")
    assert y.shape == x.shape
    want = _linear(x, h)
    return float(np.max(np.sqrt(((y - want) ** 2).sum(axis=1)
                                / (want ** 2).sum(axis=1))))


@pytest.mark.parametrize("chunks", [_one_block, _uneven])
@pytest.mark.parametrize("seed", [1, 2])
def test_int24_tail_is_the_linear_convolution(tmp_path, chunks, seed):
    assert _rel_err(tmp_path, "int24", chunks, seed) < REL_TOL


@pytest.mark.parametrize("chunks", [_one_block, _uneven])
def test_int16_tail_fails_the_same_tolerance(tmp_path, chunks):
    assert _rel_err(tmp_path, "int16", chunks) > REL_TOL


def _traced_call(tmp_path, tracer):
    """A session built by one untraced block, then one 16-block call (two
    cycles of the tail, from phase 1) with ``tracer`` on the session."""
    _, wav = _impulse(tmp_path, 3)
    sp = _session(tmp_path, wav, "int24")
    x = (0.1 * np.random.default_rng(7).standard_normal(
        (CHANNELS, 17 * N))).astype(np.float32)
    sp.process(x[:, :N], RATE)
    sp.tracer = tracer
    sp.process(x[:, N:], RATE)
    return sp


def test_spans_and_fire_counter_inside_engine_step(tmp_path):
    tr = P.Tracer()
    _traced_call(tmp_path, tr)
    spans = tr.spans
    assert tr.dropped == 0 and tr.counters["session.blocks"] == 16
    heads = [s for s in spans if s.name == "engine.head"]
    tails = [s for s in spans if s.name == "engine.tail"]
    assert len(heads) == 16 and len(tails) == 2
    assert tr.counters["engine.tail_fires"] == 2
    for s in heads + tails:
        parent = spans[s.parent]
        assert parent.name == "engine.step"
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    # the fires fall on the cycle's last phase
    steps = [i for i, s in enumerate(spans) if s.name == "engine.step"]
    fired = [k for k, i in enumerate(steps)
             if any(spans[t].parent == i for t in range(len(spans))
                    if spans[t].name == "engine.tail")]
    assert fired == [6, 14]  # blocks 7 and 15 of the stream


def test_no_tracer_records_nothing(tmp_path):
    tr = P.Tracer()
    sp = _traced_call(tmp_path, tr)
    spans, counters = len(tr.spans), dict(tr.counters)
    sp.tracer = None
    seen = []
    head, fire = NU._head, NU._fire

    def spy_head(*a):
        seen.append(P.current())
        return head(*a)

    def spy_fire(*a):
        seen.append(P.current())
        return fire(*a)

    NU._head, NU._fire = spy_head, spy_fire
    try:
        sp.process(np.zeros((CHANNELS, 16 * N), np.float32), RATE)
    finally:
        NU._head, NU._fire = head, fire
    # 16 head steps and 2 fires ran, each with no tracer current
    assert len(seen) == 18 and all(t is None for t in seen)
    assert len(tr.spans) == spans and tr.counters == counters
