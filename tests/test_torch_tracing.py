"""``utils.profiling.Tracer`` inside ``StreamProcessor`` and the
``extended`` engine on the CPU: the span tree of a call, the block
counter, the split of a call's host time into its layers, outputs
unchanged by tracing, the clock's mapping onto the profiler's, and the
capacity."""

import time

import numpy as np
import pytest
import torch

from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

N = 64
TAPS = 500  # 8 partitions
CHANNELS = 2
ENGINE = ["engine.rfft", "engine.insert", "engine.mac", "engine.irfft"]


def _impulse(path, seed=3):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((CHANNELS, TAPS))
         * np.exp(-np.arange(TAPS) / 150.0) * 0.1).astype(np.float32)
    wavio.write(str(path), h.T, 44100, subtype="float32")
    return str(path)


def _config(wav, **kw):
    return TS.EngineConfig(
        filter=TS.FilterSpec(block_length=N, dtype="float64"),
        stream=TS.StreamSpec(n_channels=CHANNELS, sample_rate=44100),
        chain=TS.ChainSpec(files=(
            TS.ImpulseFileSpec(enabled=True, filename=wav),
            TS.ImpulseFileSpec(), TS.ImpulseFileSpec())),
        engine_mode="extended", **kw)


def _session(tmp_path, **kw):
    wav = _impulse(tmp_path / "h.wav")
    return StreamProcessor(_config(wav, **kw),
                           ArtifactCache(str(tmp_path / "cache")),
                           device="cpu")


def _chunks(frames, calls, seed=9):
    rng = np.random.default_rng(seed)
    return [0.1 * rng.standard_normal((CHANNELS, frames)).astype(np.float32)
            for _ in range(calls)]


def _tree(spans, i):
    """(name, [children's trees]) of span ``i``."""
    return (spans[i].name, [_tree(spans, j) for j, s in enumerate(spans)
                            if s.parent == i])


def _call_tree(blocks):
    step = [("session.to_device", []),
            ("engine.step", [(name, []) for name in ENGINE])]
    return ("session.process",
            step * blocks + [("session.fetch", []), ("session.guard", []),
                             ("session.overflow", [])])


def _layer_split(spans):
    """(session host, engine host, fetch, session.process) in ns, summed
    over the calls: a span's self time goes to the layer of its nearest
    ``engine.step`` or ``session.fetch`` ancestor (itself included), else
    to the session."""
    layer = []
    for s in spans:
        if s.name in ("engine.step", "session.fetch"):
            layer.append(s.name)
        else:
            layer.append(layer[s.parent] if s.parent >= 0 else "session")
    self_ns = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            self_ns[s.parent] -= s.end_ns - s.start_ns
    split = dict.fromkeys(("session", "engine.step", "session.fetch"), 0)
    for lay, t in zip(layer, self_ns):
        split[lay] += t
    roots = sum(s.end_ns - s.start_ns for s in spans if s.parent < 0)
    return (split["session"], split["engine.step"], split["session.fetch"],
            roots)


def test_tracing_off_records_nothing(tmp_path):
    sp = _session(tmp_path)
    assert sp.tracer is None
    seen = []
    step = None

    def spy(*a):
        seen.append(P.current())
        return step(*a)

    for x in _chunks(4 * N, 3):
        sp.process(x)
        if step is None:  # built by the first call
            step, sp._step = sp._step, spy
    assert len(seen) == 8 and all(t is None for t in seen)
    assert sp.tracer is None and P.current() is None


def test_tracing_on_gives_the_tree(tmp_path):
    sp = _session(tmp_path)
    sp.tracer = tr = P.Tracer()
    for x in _chunks(4 * N, 3):  # the first call builds, self-check too
        sp.process(x)
    spans = tr.spans
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].call for i in roots] == [1, 2, 3]
    assert tr.calls == 3 and tr.dropped == 0
    for i in roots:
        assert _tree(spans, i) == _call_tree(4)
    for i, s in enumerate(spans):  # a child shares its parent's call id
        assert s.parent < i
        assert s.parent < 0 or spans[s.parent].call == s.call
    assert P.current() is None


@pytest.mark.parametrize("frames", [4 * N, 200, 3 * N + 5])
def test_blocks_counter_counts_the_blocks_stepped(tmp_path, frames):
    sp = _session(tmp_path)
    sp.tracer = tr = P.Tracer()
    outs = [sp.process(x) for x in _chunks(frames, 3)]
    blocks = 3 * frames // N
    drains = sum(s.name == "session.fetch" for s in tr.spans)
    assert tr.counters == {"session.blocks": blocks,
                           "session.overflow_passes": drains}
    assert sum(o.shape[1] for o in outs) == blocks * N
    assert sum(s.name == "engine.step" for s in tr.spans) == blocks


def test_layers_split_each_call_to_the_nanosecond(tmp_path):
    sp = _session(tmp_path)
    sp.process(_chunks(N, 1)[0])
    sp.tracer = tr = P.Tracer()
    for x in _chunks(4 * N, 3):
        sp.process(x)
    spans = tr.spans
    for s in spans:  # nested: inside the parent, after the last sibling
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    for i, s in enumerate(spans):
        sib = [t for t in spans[:i] if t.parent == s.parent
               and t.call == s.call]
        assert not sib or sib[-1].end_ns <= s.start_ns
    session, engine, fetch, total = _layer_split(spans)
    assert session + engine + fetch == total
    assert engine == sum(s.end_ns - s.start_ns for s in spans
                         if s.name == "engine.step")
    assert min(session, engine, fetch) > 0


def test_outputs_are_bit_identical_with_tracing_on(tmp_path):
    for side in ("off", "on"):
        (tmp_path / side).mkdir()
    off, on = _session(tmp_path / "off"), _session(tmp_path / "on")
    on.tracer = P.Tracer()
    for x in _chunks(3 * N + 17, 4):
        a, b = off.process(x), on.process(x)
        assert a.dtype == b.dtype == np.float64
        assert np.array_equal(a, b)
    assert on.tracer.counters["session.blocks"] > 0


def test_crossfade_block_is_traced(tmp_path):
    sp = _session(tmp_path)
    sp.process(_chunks(2 * N, 1)[0])
    wav2 = _impulse(tmp_path / "h2.wav", seed=4)
    sp.reconfigure(_config(wav2))
    sp.tracer = tr = P.Tracer()
    sp.process(_chunks(2 * N, 1)[0])
    spans = tr.spans
    crossfade = ("engine.step", [(name, []) for name in ENGINE + ENGINE[2:]])
    plain = ("engine.step", [(name, []) for name in ENGINE])
    assert _tree(spans, 0) == ("session.process", [
        ("session.to_device", []), crossfade, ("session.fetch", []),
        ("session.guard", []), ("session.overflow", []),
        ("session.to_device", []), plain, ("session.fetch", []),
        ("session.guard", []), ("session.overflow", [])])
    assert tr.counters == {"session.blocks": 2,
                           "session.overflow_passes": 2}


def test_a_call_that_raises_closes_its_spans(tmp_path):
    sp = _session(tmp_path)
    sp.process(_chunks(N, 1)[0])

    def broken(*a):
        raise RuntimeError("step failed")

    sp._step = broken
    sp.tracer = tr = P.Tracer()
    with pytest.raises(RuntimeError, match="step failed"):
        sp.process(_chunks(2 * N, 1)[0])
    assert [s.name for s in tr.spans] == ["session.process",
                                          "session.to_device", "engine.step"]
    assert all(s.end_ns >= s.start_ns for s in tr.spans)
    assert P.current() is None and tr._open == []


def test_a_span_maps_onto_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = P.Tracer()
    a = torch.randn(200, 200)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            tr.begin(f"body{k}")
            with record_function(f"body{k}"):
                for _ in range(10):
                    a = a @ a
                    a = a / a.norm()
            tr.end()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    slack = 100_000  # ns
    for s in tr.spans:
        e = events[s.name]
        assert tr.to_unix_ns(s.start_ns) <= e.start_ns() + slack
        assert tr.to_unix_ns(s.end_ns) >= e.end_ns() - slack
        assert e.end_ns() > e.start_ns()


def test_capacity_drops_spans_and_counts_them(tmp_path):
    sp = _session(tmp_path)
    sp.process(_chunks(N, 1)[0])
    chunks = _chunks(4 * N, 2)
    sp.tracer = whole = P.Tracer()
    for x in chunks:
        sp.process(x)
    sp.reset()
    sp.tracer = capped = P.Tracer(capacity=10)
    for x in chunks:
        sp.process(x)
    kept = capped.spans
    assert len(kept) == 10
    assert capped.dropped == len(whole.spans) - 10
    assert [s.name for s in kept] == [s.name for s in whole.spans[:10]]
    assert capped.counters == whole.counters == {
        "session.blocks": 8, "session.overflow_passes": 2}
    assert capped._open == []


def test_to_unix_ns_uses_the_anchor():
    tr = P.Tracer()
    t0, u0 = tr.anchor
    assert tr.to_unix_ns(t0 + 1234) == u0 + 1234
    assert abs(u0 - time.time_ns()) < 10**9
