"""The float output's overflow count in ``StreamProcessor``: one host pass
a drain over the fetched samples of its good blocks, held bit for bit
against the per-block device count (``ops.formats.count_float_overflow``)
over the same outputs, on the CPU: several drains and one-block calls,
float32 and float64, a NaN or Inf inside a good block, a NaN abort, a
crossfade, ``process_buffer``, ``render``, the one array that takes a
drain's magnitudes, a checkpoint, ``reset``, the warnings' per-block
reads, the pass counter, and the integer output stage after a change of
output format."""

import dataclasses

import numpy as np
import pytest
import torch

from bfir_tpu_torch import convert
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine import checkpoint as ck
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.ops import dither as dth
from bfir_tpu_torch.ops import formats as fm
from bfir_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

N = 64
TAPS = 300
CHANNELS = 2
COUNT = fm.count_float_overflow  # the per-block device count, kept


def _impulse(path, seed=3, gain=3.0):
    """A decaying noise impulse whose first tap alone is ``gain``: noise
    at 0.5 full scale overflows."""
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((CHANNELS, TAPS))
         * np.exp(-np.arange(TAPS) / 60.0) * 0.2).astype(np.float32)
    h[:, 0] = gain
    wavio.write(str(path), h.T, 44100, subtype="float32")
    return str(path)


def _config(wav, dtype="float64", out_format=TS.SampleFormat.FLOAT_LE,
            **kw):
    return TS.EngineConfig(
        filter=TS.FilterSpec(block_length=N, dtype=dtype),
        stream=TS.StreamSpec(n_channels=CHANNELS, sample_rate=44100,
                             out_format=out_format),
        chain=TS.ChainSpec(files=(
            TS.ImpulseFileSpec(enabled=True, filename=wav),
            TS.ImpulseFileSpec(), TS.ImpulseFileSpec())), **kw)


def _session(tmp_path, dtype="float64", **kw):
    wav = _impulse(tmp_path / "h.wav")
    return StreamProcessor(_config(wav, dtype, **kw),
                           ArtifactCache(str(tmp_path / "cache")),
                           device="cpu")


def _noise(frames, seed, dtype="float64", level=0.5):
    rng = np.random.default_rng(seed)
    return (level * rng.standard_normal((CHANNELS, frames))).astype(dtype)


def _zero(dtype):
    return dth.init_overflow_stats(CHANNELS, dtype=getattr(torch, dtype),
                                   device="cpu")


def _replay(outputs, of, blocks=True):
    """``of`` advanced by the device count over ``outputs`` ([C, T] host
    arrays), one call a block (as the drains did) or one an array (as
    ``process_buffer`` and ``render`` did)."""
    for y in outputs:
        parts = ([y[:, i:i + N] for i in range(0, y.shape[1], N)]
                 if blocks else [y])
        for part in parts:
            of = COUNT(torch.from_numpy(np.ascontiguousarray(part)), of)
    return of


def _assert_bits(got, want):
    """Each field equal bit for bit, dtype included (NaN payloads too)."""
    for g, w in zip(got, want):
        w = w.numpy() if torch.is_tensor(w) else np.asarray(w)
        assert g.dtype == w.dtype
        assert g.tobytes() == w.tobytes(), (g, w)


@pytest.fixture
def no_device_count(monkeypatch):
    """The float ``process`` path must not reach the device count."""
    def refuse(*a, **k):
        raise AssertionError("count_float_overflow called")

    monkeypatch.setattr(fm, "count_float_overflow", refuse)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("calls", [
    [150 * N, 3 * N + 5, 70 * N],  # drains of 32 blocks, then the rest
    [N] * 6,  # one-block calls: a drain each
    [N - 7, 2 * N + 3, 40, 100 * N + 9],  # uneven calls
])
def test_stats_equal_the_per_block_device_count(tmp_path, no_device_count,
                                                dtype, calls):
    sp = _session(tmp_path, dtype)
    outs = [sp.process(_noise(t, seed, dtype))
            for seed, t in enumerate(calls)]
    assert sum(o.shape[1] for o in outs) == sum(calls) // N * N
    got = sp.overflow_stats()
    assert int(got.n_overflows.min()) > 0 and float(got.largest.min()) > 1
    _assert_bits(got, _replay(outs, _zero(dtype)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("level", [0.5, 0.01])  # 0.01: only the Infs overflow
def test_nan_and_inf_inside_a_good_block_count_as_the_device_does(
        tmp_path, no_device_count, dtype, level):
    """A NaN or an Inf past a block's first sample: the guard lets the
    block through; the peak turns NaN or Inf and the Infs count, in a NaN
    channel too."""
    sp = _session(tmp_path, dtype)
    outs = [sp.process(_noise(N, 0, dtype, level))]  # builds
    step, stepped = sp._step, []

    def poisoned(st, co, x):
        st, out = step(st, co, x)
        stepped.append(None)
        if len(stepped) in (3, 40):
            out = out.clone()
            out[0, 5] = float("nan")  # a NaN peak still counts the Inf
            out[0, 7] = float("inf")
            out[1, 13:15] = torch.tensor([1.0, -1.0])  # full scale: no count
        if len(stepped) == 40:
            out[1, 9] = float("inf")
            out[1, 11] = float("-inf")
        return st, out

    sp._step = poisoned
    outs += [sp.process(_noise(t, s, dtype, level))
             for s, t in ((1, 10 * N), (2, 50 * N))]
    assert not sp._failed and sum(o.shape[1] for o in outs) == 61 * N
    got = sp.overflow_stats()
    assert np.isnan(got.largest[0]) and np.isposinf(got.largest[1])
    _assert_bits(got, _replay(outs, _zero(dtype)))


def test_a_nan_abort_stops_the_count_at_the_bad_block(tmp_path,
                                                      no_device_count):
    sp = _session(tmp_path)
    first = sp.process(_noise(5 * N, 0))
    x = _noise(60 * N, 1)  # one drain, at the end of the call
    x[:, 45 * N] = np.nan  # block 45 of the call: its whole output is NaN
    y = sp.process(x)
    assert sp._failed and y.shape == x.shape
    np.testing.assert_array_equal(y[:, 45 * N:], x[:, 45 * N:])
    assert np.isfinite(y[:, :45 * N]).all()
    _assert_bits(sp.overflow_stats(),
                 _replay([first, y[:, :45 * N]], _zero("float64")))
    stats = sp.overflow_stats()
    sp.process(_noise(3 * N, 2))  # passthrough: nothing more counted
    _assert_bits(sp.overflow_stats(), stats)


def test_the_crossfade_block_is_counted(tmp_path, no_device_count):
    sp = _session(tmp_path)
    outs = [sp.process(_noise(40 * N, 0))]
    wav2 = _impulse(tmp_path / "h2.wav", seed=5, gain=-4.0)
    sp.reconfigure(_config(wav2))
    assert sp._pending_swap is not None
    outs += [sp.process(_noise(t, s)) for s, t in ((1, 70 * N), (2, N))]
    assert sp._pending_swap is None
    _assert_bits(sp.overflow_stats(), _replay(outs, _zero("float64")))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_process_buffer_and_render_count_on_the_host(tmp_path,
                                                     no_device_count, dtype):
    sp = _session(tmp_path, dtype)
    a = sp.process(_noise(7 * N, 0, dtype))
    b = sp.process_buffer(_noise(33 * N + 5, 1, dtype))
    c = sp.render(_noise(20 * N + 3, 2, dtype))
    d = sp.process(_noise(3 * N, 3, dtype))
    assert b.shape[1] == 33 * N and c.shape[1] == 20 * N + 3
    want = _replay([a], _zero(dtype))
    want = _replay([b, c], want, blocks=False)
    _assert_bits(sp.overflow_stats(), _replay([d], want))


def test_one_magnitude_array_serves_every_drain(tmp_path, no_device_count):
    """Drains take |y| into one array kept by the session; more samples
    than a drain holds (a wide ``process_buffer``) take a temporary."""
    sp = _session(tmp_path, "float32")
    outs = [sp.process(_noise(70 * N, 0, "float32"))]
    buf = sp._overflow_scratch
    assert buf.dtype == np.float32
    assert buf.size == CHANNELS * sp.MAX_INFLIGHT * N
    outs += [sp.process(_noise(t, s, "float32"))
             for s, t in ((1, N), (2, 40 * N))]
    wide = sp.process_buffer(_noise(100 * N, 3, "float32"))
    assert sp._overflow_scratch is buf
    want = _replay(outs, _zero("float32"))
    _assert_bits(sp.overflow_stats(), _replay([wide], want, blocks=False))

def test_checkpoint_and_reset_carry_the_stats(tmp_path, no_device_count):
    sp = _session(tmp_path)
    outs = [sp.process(_noise(t, s)) for s, t in ((0, 90 * N), (1, N))]
    stats = sp.overflow_stats()
    _assert_bits(stats, _replay(outs, _zero("float64")))
    path = str(tmp_path / "ck.npz")
    ck.save_state(path, sp._state, None,
                  convert.overflow_stats_from_numpy(stats, "cpu"))
    _, _, back = ck.load_state(path, device="cpu")
    _assert_bits(dth.OverflowStats(*(t.numpy() for t in back)), stats)
    sp.reset()
    _assert_bits(sp.overflow_stats(), _zero("float64"))
    y = sp.process(_noise(5 * N, 2))
    _assert_bits(sp.overflow_stats(), _replay([y], _zero("float64")))


def test_warnings_read_the_stats_after_each_block(tmp_path, no_device_count,
                                                  monkeypatch):
    """``overflow_warnings`` reads the stats once a block, as before: each
    read equals the per-block count up to that block."""
    sp = _session(tmp_path, overflow_warnings=True)
    reads = []
    monkeypatch.setattr(sp, "check_overflows",
                        lambda: reads.append(sp.overflow_stats()))
    outs = [sp.process(_noise(t, s)) for s, t in ((0, 70 * N), (1, 2 * N))]
    blocks = np.concatenate(outs, 1)
    assert len(reads) == 72
    for i, read in enumerate(reads):
        _assert_bits(read, _replay([blocks[:, :(i + 1) * N]],
                                   _zero("float64")))


def test_overflow_passes_count_one_a_drain(tmp_path):
    sp = _session(tmp_path)
    sp.process(_noise(N, 0))
    sp.tracer = tr = P.Tracer()
    sp.process(_noise(150 * N, 1))  # drains at 64, 96 and 128 blocks; end
    sp.process(_noise(N, 2))
    sp.process(_noise(N - 1, 3))  # no block: no drain
    fetches = sum(s.name == "session.fetch" for s in tr.spans)
    overflow = sum(s.name == "session.overflow" for s in tr.spans)
    assert fetches == overflow == 5
    assert tr.counters == {"session.blocks": 151,
                           "session.overflow_passes": 5}


def test_the_integer_stage_counts_on_the_device_after_a_format_change(
        tmp_path):
    """Float output counted on the host, then S16 out: ``process_raw``
    folds the host's counts into the device stats its output stage
    advances. A twin session kept at float output gives the samples the
    reference output stage quantizes."""
    (tmp_path / "twin").mkdir()
    sp, twin = _session(tmp_path), _session(tmp_path / "twin")
    x = _noise(40 * N + 11, 0)
    y = sp.process(x)
    np.testing.assert_array_equal(twin.process(x), y)
    sp.reconfigure(dataclasses.replace(sp.config, stream=dataclasses.replace(
        sp.config.stream, out_format=TS.SampleFormat.S16_LE)))
    twin.reconfigure(twin.config)  # the same crossfade, output kept float
    assert sp._overflow_host is not None
    want = _replay([y], _zero("float64"))
    calls = []
    for seed, t in ((1, 3 * N), (2, 70 * N + 9), (3, N)):
        raw = fm.encode_float(_noise(t, seed), TS.SampleFormat.FLOAT_LE)
        calls.append((sp.process_raw(raw), raw))
    assert sp._overflow_host is None
    for out, raw in calls:
        ref = twin.process(fm.decode(raw, TS.SampleFormat.FLOAT_LE,
                                     CHANNELS, dtype=np.dtype("float64")))
        q, want, _ = fm.output_stage(torch.from_numpy(ref),
                                     TS.SampleFormat.S16_LE, want)
        assert out == fm.encode_int(q.numpy(), TS.SampleFormat.S16_LE)
    got = sp.overflow_stats()
    assert (got.n_overflows > _replay([y], _zero("float64")).n_overflows
            .numpy()).all() and int(got.intlargest.min()) > 0
    _assert_bits(got, want)
