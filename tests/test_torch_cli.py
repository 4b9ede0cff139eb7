"""The control plane, the audio server, the noise probe and the render CLI
of bfir_tpu_torch on the CPU against bfir_tpu.

- The 15 cases of tests/test_cli.py: the same command scripts go to both
  packages' ``CommandHandler`` (and ``ControlServer``) and the replies
  must match line for line, besides the reference test's own assertions.
  Impulses whose probe gives 0 dB keep the noise RNGs (the port's
  ``torch.Generator``, the reference's threefry) out of the comparison; a
  hot impulse's level may differ by one step. The audio server streams
  against scipy (1e-5, float32 PCM) and, in one case, the reference's
  server (1e-6).
- tests/test_concurrency.py's cross-thread mutation test.
- The noise probe: the 4 cases of tests/test_resample_delay_noise.py,
  compared by statistics; the probe's body fed the reference's own noise
  equals the reference's dB to 1e-9 (float64) or 1e-4 dB (float32);
  ``attenuation_bound`` exactly.
- The render CLI at its float64 default and with ``--auto-attenuate``
  against the reference's CLI (1e-12 at float64; levels at most one step
  apart), and ``python -m bfir_tpu_torch.cli.audio_server`` serving.

Every socket has a timeout of at most 10 s."""

import json
import os
import select
import signal as os_signal
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
from scipy import signal

from bfir_tpu.cli import render as JCLI
from bfir_tpu.cli.audio_server import AudioServer as JAudioServer
from bfir_tpu.cli.protocol import CommandHandler as JCommandHandler
from bfir_tpu.cli.server import ControlServer as JControlServer
from bfir_tpu.cli.store import ConfigStore as JConfigStore
from bfir_tpu.core import spec as JS
from bfir_tpu.ops import noise as jnz
from bfir_tpu_torch.cli import render as CLI
from bfir_tpu_torch.cli.audio_server import AudioServer
from bfir_tpu_torch.cli.protocol import CommandHandler, dir_listing, parse_line
from bfir_tpu_torch.cli.server import ControlServer
from bfir_tpu_torch.cli.store import ConfigStore
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.session import StreamProcessor
from bfir_tpu_torch.io import wavio
from bfir_tpu_torch.ops import formats as fm
from bfir_tpu_torch.ops import noise as nz

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 10.0  # every socket's timeout, seconds
FLOAT_LE = TS.SampleFormat.FLOAT_LE


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends: XLA's CPU
    compiler has aborted xdist workers late in full runs once many
    executables had accumulated in one process (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


def _engine_config(spec):
    return spec.EngineConfig(filter=spec.FilterSpec(
        block_length=256, n_partitions=1, dtype="float64"))


@pytest.fixture
def stores():
    """(reference store, port store), each recording its change calls."""
    pair = []
    for spec, cls, kw in ((JS, JConfigStore, {}),
                          (TS, ConfigStore, {"device": "cpu"})):
        changes = []
        s = cls(_engine_config(spec), on_change=changes.append, **kw)
        s.test_changes = changes
        pair.append(s)
    return tuple(pair)


@pytest.fixture
def script(stores, tmp_path):
    """``script(lines)``: each line to both packages' handlers; the replies
    must be equal; returns the port's, with its handler as ``.handler``."""
    jh = JCommandHandler(stores[0], default_dir=str(tmp_path))
    th = CommandHandler(stores[1], default_dir=str(tmp_path))

    def run(lines):
        out = []
        for line in lines:
            rj, rt = jh.handle(line), th.handle(line)
            assert rt == rj, (line, rt, rj)
            out.append(rt)
        assert th.close == jh.close
        return out

    run.handler = th
    return run


def test_parse_line():
    for line, want in (("EQM5 -30\r", ("EQM5", "-30")), ("eqen", ("EQEN", "")),
                       ("F1FN C:\\my file.wav", ("F1FN", "C:\\my file.wav"))):
        assert parse_line(line) == want


def test_eq_mag_get_set_clamp(script, stores):
    assert script(["EQM0", "EQM0 -30", "EQM0", "EQM1 999", "EQM1",
                   "EQM99 50", "EQM30", "EQM2 abc"]) == [
        "0", "OK", "-30", "OK", "200", "OK", "50", "ERR"]
    assert [len(s.test_changes) for s in stores] == [3, 3]


def test_enables_and_levels(script):
    for op in ("EQEN", "F1EN", "F2EN", "F3EN"):
        assert script([op, f"{op} 1", op, f"{op} 7", op]) == [
            "0", "OK", "1", "OK", "1"]
    for op in ("EQLV", "F1LV", "F2LV", "F3LV"):
        assert script([f"{op} -55", op, f"{op} -999", op]) == [
            "OK", "-55", "OK", "-200"]


def test_filename_set_probes_and_autolevels(script, stores, tmp_path):
    """A quiet impulse (the probe gives 0 dB) line for line; a +12 dB one
    auto-levels to about -120 steps in both packages, at most one step
    apart."""
    quiet = np.zeros((64, 2))
    quiet[0, :] = 0.5
    pq = str(tmp_path / "quiet.wav")
    wavio.write(pq, quiet, 44100, subtype="float64")
    assert script([f"F1FN {pq}", "F1FN", "F1EN", "F1MD", "F1LV", "F1FN ?",
                   "F1FN", "F1MD", "F1LV", "F1EN"]) == [
        "OK", pq, "1", "64 samples, 2 channels, 44100 Hz", "0", "OK", "",
        "", "0", "0"]
    hot = np.zeros((64, 2))
    hot[0, :] = 4.0
    p = str(tmp_path / "hot.wav")
    wavio.write(p, hot, 44100, subtype="float64")
    assert script([f"F1FN {p}", "F1FN", "F1EN", "F1MD"]) == [
        "OK", p, "1", "64 samples, 2 channels, 44100 Hz"]
    levels = [s.get_file_level(1) for s in stores]
    assert all(-125 <= v <= -110 for v in levels), levels
    assert abs(levels[0] - levels[1]) <= 1, levels
    assert script(["F1FN ?", "F1FN", "F1MD", "F1LV", "F1EN"]) == [
        "OK", "", "", "0", "0"]


def test_filename_missing_errors(script):
    assert script(["F2FN /no/such/file.wav", "F2FN"]) == ["ERR", ""]


def test_dir_listing(script, tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.wav").write_bytes(b"")
    (tmp_path / "b.wav").write_bytes(b"")
    out, other, bogus = script(["DIR", "DIR /definitely/not/here", "BOGUS"])
    data = json.loads(out)
    assert data["dir"] == str(tmp_path)
    names = [e["name"] for e in data["subdir"]]
    assert names[0] == ".." and "sub" in names
    assert [e["name"] for e in data["file"]] == ["a.wav", "b.wav"]
    assert other and bogus == "ERR"  # falls back to default


def test_close(script):
    assert script(["CLOSE"]) == ["OK"]
    assert script.handler.close


def test_dir_listing_of_file(tmp_path):
    from bfir_tpu.cli.protocol import dir_listing as jdir_listing

    f = tmp_path / "x.txt"
    f.write_text("hi")
    out = dir_listing(str(f), str(tmp_path))
    assert json.loads(out) == str(f)
    assert out == jdir_listing(str(f), str(tmp_path))


def _recv_replies(sk, count):
    buf = b""
    while buf.count(b"\r") < count:
        chunk = sk.recv(4096)
        if not chunk:
            break
        buf += chunk
    return buf.split(b"\r")[:count]


def _transcript(port, lines):
    """Each line over one control connection, one reply awaited each."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as sk:
        for line in lines:
            sk.sendall(line.encode() + b"\r")
            out.append(_recv_replies(sk, 1)[0].decode())
    return out


def _both_servers(stores, tmp_path):
    srvs = [cls(s, host="127.0.0.1", port=0, default_dir=str(tmp_path))
            for cls, s in zip((JControlServer, ControlServer), stores)]
    for srv in srvs:
        srv.start()
    return srvs


def test_server_end_to_end(stores, tmp_path):
    srvs = _both_servers(stores, tmp_path)
    try:
        lines = ["EQM0 -100", "EQM0", "EQEN 1", "NOPE", "CLOSE"]
        got = [_transcript(srv.port, lines) for srv in srvs]
        assert got[1] == got[0] == ["OK", "-100", "OK", "ERR", "OK"]
        for s in stores:  # the store reflects the mutations
            assert s.config.chain.eq.mag_steps[0] == -100
            assert s.config.chain.eq.enabled
    finally:
        for srv in srvs:
            srv.stop()


def test_server_crlf_clients(stores, tmp_path):
    srvs = _both_servers(stores, tmp_path)
    try:
        got = []
        for srv in srvs:
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=TIMEOUT) as sk:
                sk.sendall(b"EQM3 40\r\nEQM3\r\n")  # telnet-style CRLF
                got.append(_recv_replies(sk, 2))
        assert got[1] == got[0] == [b"OK", b"40"]
    finally:
        for srv in srvs:
            srv.stop()


# -- audio streaming server ---------------------------------------------------


def _cfg_with_impulse(path, spec=TS, block=256):
    files = [spec.ImpulseFileSpec(enabled=True, filename=path),
             spec.ImpulseFileSpec(), spec.ImpulseFileSpec()]
    return spec.EngineConfig(
        filter=spec.FilterSpec(block_length=block, n_partitions=1,
                               dtype="float64"),
        stream=spec.StreamSpec(n_channels=2, sample_rate=44100),
        chain=spec.ChainSpec(files=tuple(files)))


def _ir(tmp_path, seed, taps, name="ir.wav"):
    h = np.random.default_rng(seed).standard_normal((2, taps)) * 0.1
    p = str(tmp_path / name)
    wavio.write(p, h.T, 44100, subtype="float64")
    return h, p


def _connect(port, channels=2, rate=44100, **fmts):
    s = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    s.sendall((json.dumps({"channels": channels, "sample_rate": rate, **fmts})
               + "\n").encode())
    f = s.makefile("rb")
    return s, f, json.loads(f.readline().decode())


def _audio_client(port, frames_iter, channels=2):
    """Minimal wire-protocol client: (header, concatenated reply bytes)."""
    s, f, hdr = _connect(port, channels, in_format="float_le",
                         out_format="float_le")
    chunks = []
    if hdr.get("ok"):
        for raw in frames_iter:
            s.sendall(struct.pack("<I", len(raw)) + raw)
            (n,) = struct.unpack("<I", f.read(4))
            chunks.append(f.read(n))
        s.sendall(struct.pack("<I", 0))  # flush/end
        (n,) = struct.unpack("<I", f.read(4))
        chunks.append(f.read(n))
    s.close()
    return hdr, b"".join(chunks)


def _scipy(x, h, length):
    return np.stack([signal.fftconvolve(x[c], h[c])[:length]
                     for c in range(x.shape[0])])


def test_audio_server_streams_filtered_pcm(tmp_path):
    """PCM frames in, filtered PCM out (the process_raw path), against
    scipy and against the reference's server on the same frames."""
    h, p = _ir(tmp_path, 70, 700)
    rng = np.random.default_rng(70)
    x = rng.standard_normal((2, 256 * 6 + 100))
    cuts = [0, 700, 1100, x.shape[1]]  # unaligned: the server re-blocks
    frames = [fm.encode_float(x[:, a:b], FLOAT_LE)
              for a, b in zip(cuts, cuts[1:])]
    srvs = [AudioServer(_cfg_with_impulse(p), host="127.0.0.1", port=0,
                        cache=ArtifactCache(str(tmp_path / "t")),
                        device="cpu"),
            JAudioServer(_cfg_with_impulse(p, JS), host="127.0.0.1", port=0)]
    ys = []
    try:
        for srv in srvs:
            srv.start()
            hdr, out = _audio_client(srv.port, frames)
            assert hdr["ok"] and hdr["block_length"] == 256
            ys.append(fm.decode(out, FLOAT_LE, 2))
    finally:
        for srv in srvs:
            srv.stop()
    y, yj = ys
    assert y.shape == yj.shape == (2, 256 * 6)  # the flush drops the rest
    assert np.abs(y - _scipy(x, h, y.shape[1])).max() < 1e-5
    assert np.abs(y - yj).max() < 1e-6


def test_audio_server_live_control_reconfigure(tmp_path):
    """A control-plane level change crossfades into a running stream (one
    store shared by the server's sessions; no reconnect, no dropout)."""
    h = np.zeros((2, 16))
    h[:, 0] = 1.0  # dirac chain
    p = str(tmp_path / "d.wav")
    wavio.write(p, h.T, 44100, subtype="float64")
    cfg = _cfg_with_impulse(p)
    store = ConfigStore(cfg, device="cpu")
    srv = AudioServer(cfg, host="127.0.0.1", port=0, store=store,
                      cache=ArtifactCache(str(tmp_path / "t")), device="cpu")
    srv.start()
    try:
        s, f, hdr = _connect(srv.port)
        assert hdr["ok"]

        def push(block):
            raw = fm.encode_float(block, FLOAT_LE)
            s.sendall(struct.pack("<I", len(raw)) + raw)
            (n,) = struct.unpack("<I", f.read(4))
            return fm.decode(f.read(n), FLOAT_LE, 2)

        x = np.ones((2, 256)) * 0.25
        np.testing.assert_allclose(push(x), x, atol=1e-6)  # passthrough
        store.set_file_level(1, 60)  # +6 dB through the control surface
        y2 = push(x)  # the crossfade block ramps 1.0 -> 2.0 gain
        y3 = push(x)  # settled at the new gain
        assert y2[0, 0] < y2[0, -1], "the crossfade must ramp in the block"
        np.testing.assert_allclose(y3, x * (10 ** (6 / 20)), rtol=1e-4)
        s.close()
    finally:
        srv.stop()


def test_audio_server_rejects_bad_header():
    srv = AudioServer(TS.EngineConfig(), host="127.0.0.1", port=0,
                      device="cpu")
    srv.start()
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=TIMEOUT)
        s.sendall(b"not json\n")
        hdr = json.loads(s.makefile("rb").readline().decode())
        assert hdr["ok"] is False and "error" in hdr
        s.close()
    finally:
        srv.stop()


def test_audio_server_multi_client_concurrent(tmp_path):
    """Four clients streaming at once, each with its own session and its
    own correct output (no cross-talk)."""
    h, p = _ir(tmp_path, 71, 500)
    rng = np.random.default_rng(71)
    srv = AudioServer(_cfg_with_impulse(p), host="127.0.0.1", port=0,
                      cache=ArtifactCache(str(tmp_path / "t")), device="cpu")
    srv.start()
    n_clients = 4
    signals = [rng.standard_normal((2, 1440)) for _ in range(n_clients)]
    results = [None] * n_clients
    errors = []

    def client(i):
        try:
            frames = [fm.encode_float(signals[i][:, a:a + 640], FLOAT_LE)
                      for a in range(0, 1280, 640)] + [
                fm.encode_float(signals[i][:, 1280:], FLOAT_LE)]
            hdr, out = _audio_client(srv.port, frames)
            assert hdr["ok"]
            results[i] = fm.decode(out, FLOAT_LE, 2)
        except Exception as e:  # surfaced below
            errors.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        for i in range(n_clients):
            y = results[i]
            assert y is not None and y.shape == (2, 256 * 5)  # 1440 // 256
            assert np.abs(y - _scipy(signals[i], h, y.shape[1])).max() < 1e-5
    finally:
        srv.stop()


def test_audio_server_pipelined_frames_in_flight(tmp_path):
    """A client may send many frames before reading any reply and still
    gets every reply, in order."""
    h, p = _ir(tmp_path, 72, 400)
    rng = np.random.default_rng(72)
    srv = AudioServer(_cfg_with_impulse(p), host="127.0.0.1", port=0,
                      cache=ArtifactCache(str(tmp_path / "t")), device="cpu")
    srv.start()
    try:
        nframes = 24
        x = rng.standard_normal((2, 256 * nframes))
        s, f, hdr = _connect(srv.port, in_format="float_le",
                             out_format="float_le")
        assert hdr["ok"] and hdr.get("max_inflight", 0) >= 4
        for i in range(nframes):  # every frame and the flush, then read
            raw = fm.encode_float(x[:, i * 256:(i + 1) * 256], FLOAT_LE)
            s.sendall(struct.pack("<I", len(raw)) + raw)
        s.sendall(struct.pack("<I", 0))
        chunks = []
        for _ in range(nframes + 1):
            (n,) = struct.unpack("<I", f.read(4))
            chunks.append(f.read(n))
        s.close()
        y = fm.decode(b"".join(chunks), FLOAT_LE, 2)
        assert y.shape == (2, 256 * nframes)
        assert np.abs(y - _scipy(x, h, y.shape[1])).max() < 1e-5
    finally:
        srv.stop()


def test_audio_server_module_serves(tmp_path):
    """``python -m bfir_tpu_torch.cli.audio_server --cpu`` with a control
    port: it prints its ports, streams filtered PCM and answers the control
    protocol, and stops on SIGINT."""
    h, p = _ir(tmp_path, 73, 300)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bfir_tpu_torch.cli.audio_server", "--cpu",
         "--port", "0", "--control-port", "0", "--impulse", p, "--block",
         "256"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, HOME=str(tmp_path)))
    try:
        # the start (torch's import included) may take a while, not forever
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        line = proc.stdout.readline() if ready else ""
        assert line.startswith("audio server on :"), line
        ports = [int(w.split(":")[1].strip(",")) for w in line.split()
                 if w.startswith(":")]
        x = np.random.default_rng(73).standard_normal((2, 1024))
        hdr, out = _audio_client(ports[0], [fm.encode_float(x, FLOAT_LE)])
        assert hdr["ok"]
        y = fm.decode(out, FLOAT_LE, 2)
        assert y.shape == (2, 1024)
        assert np.abs(y - _scipy(x, h, 1024)).max() < 1e-5
        assert _transcript(ports[1], ["F1EN", "EQM0 50", "EQM0"]) == [
            "1", "OK", "50"]
    finally:
        proc.send_signal(os_signal.SIGINT)
        try:
            assert proc.wait(timeout=TIMEOUT) == 0
        finally:
            proc.kill()
            proc.communicate()


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        return
    cfg = TS.EngineConfig()
    for make in (lambda: ConfigStore(cfg, device="cuda"),
                 lambda: AudioServer(cfg, port=0, device="cuda"),
                 lambda: nz.calculate_attenuation(np.ones(8), 256,
                                                  device="cuda"),
                 lambda: nz.white_noise(1, 8, dtype="float32",
                                        device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# -- cross-thread config mutation (tests/test_concurrency.py) -----------------


def test_cli_mutation_during_streaming(tmp_path):
    h = np.zeros((2, 8))
    h[:, 0] = 0.5
    p = str(tmp_path / "imp.wav")
    wavio.write(p, h.T, 44100, subtype="float64")
    cfg = _cfg_with_impulse(p)
    sp = StreamProcessor(cfg, ArtifactCache(str(tmp_path / "c")),
                         device="cpu")
    store = ConfigStore(cfg, on_change=sp.reconfigure, device="cpu")
    handler = CommandHandler(store, default_dir=str(tmp_path))
    stop = threading.Event()
    errors = []

    def mutate():
        i = 0
        try:
            while not stop.is_set():
                # toggle the file level between 0 dB and -6 dB
                handler.handle(f"F1LV {0 if i % 2 else -60}")
                handler.handle("F1LV")
                i += 1
        except Exception as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=mutate)
    t.start()
    try:
        rng = np.random.default_rng(0)
        for _ in range(60):
            x = rng.standard_normal((2, 256)) * 0.1
            y = sp.process(x)
            # the gain is 0.5 (0 dB), 0.25 (-6 dB) or a crossfade between
            assert np.isfinite(y).all()
            if y.size:
                ratio = np.abs(y).max() / max(np.abs(x).max(), 1e-9)
                assert 0.1 < ratio < 0.8, f"wild gain {ratio}"
    finally:
        stop.set()
        t.join(TIMEOUT)
    assert not errors, errors


# -- the noise probe (tests/test_resample_delay_noise.py:129-160) -------------


def test_attenuation_zero_for_quiet_filter():
    h = np.zeros(256)
    h[0] = 0.5
    assert nz.calculate_attenuation(h, block_length=128, device="cpu") == 0.0
    assert jnz.calculate_attenuation(h, block_length=128) == 0.0


def test_attenuation_for_hot_filter():
    h = np.zeros(256)
    h[0] = 4.0  # +12 dB gain
    att = nz.calculate_attenuation(h, block_length=128, device="cpu")
    assert -12.5 < att < -11.0
    assert abs(att - jnz.calculate_attenuation(h, block_length=128)) < 0.05


def test_attenuation_bound_vs_probe():
    rng = np.random.default_rng(3)
    h = rng.standard_normal(512) * 0.2
    probe = nz.calculate_attenuation(h, block_length=256, device="cpu")
    bound = nz.attenuation_bound(h)
    assert bound <= probe + 1e-9  # the bound is at least as strict
    assert bound == jnz.attenuation_bound(h)
    assert nz.attenuation_bound(h * 0.01) == jnz.attenuation_bound(h * 0.01)


def test_white_noise_stats():
    x = nz.white_noise(2, 50000, seed=1, dtype="float64", device="cpu")
    assert x.dtype == torch.float64 and tuple(x.shape) == (2, 50000)
    x = x.numpy()
    assert -1.0 <= x.min() and x.max() < 1.0
    np.testing.assert_allclose(x.mean(), 0.0, atol=0.02)
    np.testing.assert_allclose(x.var(), 1 / 3, atol=0.02)  # uniform [-1, 1)
    xj = np.asarray(jnz.white_noise(2, 50000, seed=1, dtype=np.float64))
    np.testing.assert_allclose(x.var(), xj.var(), atol=0.01)
    y = nz.white_noise(2, 50000, seed=1, dtype=torch.float64,
                       device="cpu").numpy()
    np.testing.assert_array_equal(x, y)  # seeded


@pytest.mark.parametrize("dtype,tol_db", [("float64", 1e-9),
                                          ("float32", 1e-4)])
def test_probe_body_on_reference_noise(dtype, tol_db):
    """The probe's body fed the reference's own noise gives the
    reference's dB."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 700)) * np.exp(-np.arange(700) / 200) * 0.6
    n, blocks = 256, 3
    noise = np.asarray(jnz.white_noise(2, n * blocks, seed=4,
                                       dtype=getattr(np, dtype)))
    want = jnz.calculate_attenuation(h, block_length=n, dtype=dtype, seed=4)
    got = nz._probe_db(h, noise, n, dtype, torch.device("cpu"))
    assert want < -1.0  # the probe fires
    assert abs(got - want) <= tol_db, (got, want)


# -- the render CLI -----------------------------------------------------------


def _cli_files(tmp_path, h, x):
    ir, inp = str(tmp_path / "ir.wav"), str(tmp_path / "in.wav")
    wavio.write(ir, h.T, 44100, subtype="float64")
    wavio.write(inp, x.T, 44100, subtype="float32")
    return ir, inp


@pytest.mark.parametrize("mode", [[], ["--engine-mode", "extended"]],
                         ids=["auto", "extended"])
def test_render_cli_float64_default_matches_reference(tmp_path, monkeypatch,
                                                      mode):
    """No ``--dtype``: float64 in both CLIs (``auto`` on the CPU is the
    complex engine's bulk render; ``extended`` takes process_buffer), the
    float64 WAVs within 1e-12 of each other and 1e-11 of scipy."""
    monkeypatch.setenv("HOME", str(tmp_path))  # the sessions' default cache
    rng = np.random.default_rng(80)
    h = rng.standard_normal((2, 900)) * np.exp(-np.arange(900) / 300) * 0.05
    x = (0.3 * rng.standard_normal((2, 5000))).astype(np.float32)
    ir, inp = _cli_files(tmp_path, h, x)
    flags = ["--impulse", ir, "--block", "256", "--out-format", "float64",
             "--cpu", *mode]
    out_j, out_t = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert JCLI.main([inp, out_j, *flags]) == 0
    assert CLI.build_parser().parse_args([inp, out_t]).dtype == "float64"
    assert CLI.main([inp, out_t, *flags]) == 0
    yj, yt = wavio.read(out_j)[0].T, wavio.read(out_t)[0].T
    assert yt.shape == yj.shape == x.shape
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(yt, _scipy(x.astype(np.float64), h, 5000),
                               rtol=0, atol=1e-11)


def test_render_cli_auto_attenuate_matches_reference(tmp_path, monkeypatch,
                                                     capsys):
    """``--auto-attenuate`` on a hot impulse (+12 dB): each CLI lowers the
    level by its own probe, the two at most one step apart; each output is
    scipy's convolution at its level (1e-11), its peak at most 1."""
    monkeypatch.setenv("HOME", str(tmp_path))
    rng = np.random.default_rng(81)
    h = rng.standard_normal((2, 700)) * np.exp(-np.arange(700) / 100) * 1e-4
    h[:, 0] = 4.0
    x = (0.2 * rng.standard_normal((2, 6000))).astype(np.float32)
    ir, inp = _cli_files(tmp_path, h, x)
    flags = ["--impulse", ir, "--block", "256", "--out-format", "float64",
             "--auto-attenuate", "--cpu"]
    out_j, out_t = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert JCLI.main([inp, out_j, *flags]) == 0
    capsys.readouterr()
    assert CLI.main([inp, out_t, *flags]) == 0
    printed = capsys.readouterr().out
    steps_t = int(printed.split(" dB, level ")[1].split()[0])
    steps_j = int(jnz.calculate_attenuation(h, block_length=256) * 10)
    assert steps_t == int(nz.calculate_attenuation(h, 256, device="cpu") * 10)
    assert -125 <= steps_t <= -115 and abs(steps_t - steps_j) <= 1
    ref = _scipy(x.astype(np.float64), h, 6000)
    for path, steps in ((out_t, steps_t), (out_j, steps_j)):
        y = wavio.read(path)[0].T
        np.testing.assert_allclose(y, ref * 10 ** (steps / 200), rtol=0,
                                   atol=1e-11)
        assert np.abs(y).max() <= 1.0 < np.abs(ref).max()
