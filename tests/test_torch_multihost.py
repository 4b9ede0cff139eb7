"""bfir_tpu_torch's sharded engine on meshes that span two processes: the
counterpart of tests/test_multihost.py and tests/multihost_worker.py.

Two worker processes join one gloo ``torch.distributed`` group through
``parallel.mesh.init_distributed``; each owns two CPU devices, so the
global mesh has four shards. Each runs meshes (2, 2) (the channel axis
spans the processes) and (1, 4) (the partition axis does: every ppermute
and psum crosses) with the local engines complex (float64), hc,
nonuniform and nonuniform3, plus an hc ``step_crossfade``, a two-stage
``process_blocks`` over two macro cycles and the final states through
``join_state`` and ``convert.sharded_state_to_numpy``. The test cases hold
every result to:

- the port's one-process ``ShardedEngine`` on the same mesh shape, bit for
  bit (the psum keeps its order across processes);
- the reference's ``bfir_tpu.parallel.sharded.ShardedEngine`` on 4 of
  conftest's 8 XLA CPU devices (tests/test_torch_parallel.py's helpers and
  bounds: 1e-5 x max(1, max|ref|), 1e-9 for the float64 complex engine);
- scipy, at the reference worker's bounds (1e-9 absolute for the complex
  engine, 1e-5 relative for the others);
- the comm model, per process, and the bytes that crossed between them.

This file is also the worker: ``python tests/test_torch_multihost.py
<port> <rank> <world> <out.npz> [run | diverge]``. The workers import
torch and the port only, never jax, and run with PYTHONPATH set to the
repository alone (so no site customization loads). Every wait is bounded:
the group's timeout inside the workers, ``communicate(timeout=...)``
outside.
"""

import fcntl
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script
    sys.path.insert(0, REPO)

from bfir_tpu_torch import convert  # noqa: E402
from bfir_tpu_torch.core import nonuniform as NU  # noqa: E402
from bfir_tpu_torch.core.spec import FilterSpec  # noqa: E402
from bfir_tpu_torch.parallel import mesh as M  # noqa: E402
from bfir_tpu_torch.parallel import sharded as SH  # noqa: E402

torch.set_num_threads(1)

C = 8
MESHES = [(2, 2), (1, 4)]
LOCALS = ["complex", "hc", "nonuniform", "nonuniform3"]
_N_BLOCKS = {"complex": 6, "hc": 10, "nonuniform": 19, "nonuniform3": 13}
GROUP_TIMEOUT = 20.0  # seconds a worker waits on its peer
DIVERGE_TIMEOUT = 4.0
WAIT = 80  # seconds the test waits on a worker pair


# ---------------------------------------------------------------------------
# The runs, shared by the workers and the one-process reference
# ---------------------------------------------------------------------------


def _geometry(local, p_s):
    """(n, taps, dtype, partitions, nuspec): tests/test_torch_parallel.py's
    ``_setup`` geometries."""
    nuspec = None
    if local == "complex":
        n, taps, dtype = 64, 8 * 64, "float64"
    elif local == "hc":
        n, taps, dtype = 128, 8 * 128, "float32"
    elif local == "nonuniform":
        n, dtype = 128, "float32"
        taps = 16 * n + 5 * 8 * n
    else:
        n, dtype = 128, "float32"
        p_head = int(np.lcm(4, p_s))
        nuspec = NU.Nu3Spec(n, 2, p_head, NU.NuSpec(
            block_length=2 * n, ratio=2, dtype="float32",
            tail_store="float32", p_head=p_head, p_tail=2 * p_s))
        taps = nuspec.max_taps
    parts = -(-(taps // n) // p_s) * p_s
    return n, taps, dtype, parts, nuspec


def _engine(local, mesh, seed=30):
    """(ShardedEngine, impulse, block length) of ``_geometry``."""
    n, taps, dtype, parts, nuspec = _geometry(local, mesh.shape["p"])
    h = (np.random.default_rng(seed).standard_normal((C, taps))
         * 0.05).astype(dtype)
    return (SH.ShardedEngine(FilterSpec(n, parts, dtype), C, mesh,
                             local_impl=local, nuspec=nuspec), h, n)


def _blocks(seed, b, n, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((b, C, n)).astype(
        dtype)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [np.asarray(tree)]


def _run_all(mesh) -> dict:
    """Every run of this file on ``mesh``: {name: array}."""
    tag = f"{mesh.shape['c']}x{mesh.shape['p']}"
    res = {}
    for local in LOCALS:
        eng, h, n = _engine(local, mesh)
        co, st = eng.prepare_coeffs(h), eng.init_state()
        M.reset_comm_counts()
        outs = []
        for blk in _blocks(31, _N_BLOCKS[local], n, h.dtype):
            st, y = eng.step(st, co, torch.from_numpy(blk))
            outs.append(y.numpy())
        comm, cross = M.comm_counts(), M.cross_process_bytes()
        key = f"{local}.{tag}"
        res[f"{key}.h"] = h
        res[f"{key}.out"] = np.stack(outs)
        res[f"{key}.comm"] = np.array([comm[k][f] for k in (M.PPERMUTE, M.PSUM)
                                       for f in ("calls", "bytes")])
        res[f"{key}.cross"] = np.array([
            cross[k][f] for k in (M.PPERMUTE, M.PSUM, M.JOIN)
            for f in ("sent", "received")])
        for i, leaf in enumerate(
                _leaves(convert.sharded_state_to_numpy(st, eng))):
            res[f"{key}.state{i}"] = leaf

    # the hc engine's one-block crossfade, then the new filter
    eng, h, n = _engine("hc", mesh, seed=22)
    co, co2 = eng.prepare_coeffs(h), eng.prepare_coeffs(h[:, ::-1].copy())
    st, outs = eng.init_state(), []
    for b, blk in enumerate(_blocks(23, 6, n)):
        t = torch.from_numpy(blk)
        if b == 3:
            st, y = eng.step_crossfade(st, co, co2, t)
        else:
            st, y = eng.step(st, co if b < 3 else co2, t)
        outs.append(y.numpy())
    res[f"xfade.{tag}.out"] = np.stack(outs)

    # the two-stage macro steps over two cycles from phase 0
    eng, h, n = _engine("nonuniform", mesh)
    assert eng.nuspec.ratio == 8
    _, y = eng.process_blocks(eng.init_state(), eng.prepare_coeffs(h),
                              torch.from_numpy(_blocks(31, 16, n)))
    res[f"macro.{tag}.out"] = y.numpy()
    return res


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as err:
        return str(err)
    return "no error"


def _worker(port, rank, world, out, mode):
    from bfir_tpu_torch.core.spec import EngineConfig
    from bfir_tpu_torch.engine.session import StreamProcessor

    M.init_distributed(f"localhost:{port}", world, rank, backend="gloo",
                       local_device_ids=["cpu", "cpu"],
                       timeout=DIVERGE_TIMEOUT if mode == "diverge"
                       else GROUP_TIMEOUT)
    try:
        mesh = M.make_mesh(1, 4)
        print(f"rank {rank}: {mesh}", flush=True)
        if mode == "diverge":
            # rank 1 steps once more than rank 0: it waits in the ppermute
            # of its third step for a peer that never comes
            eng, h, n = _engine("hc", mesh)
            co, st = eng.prepare_coeffs(h), eng.init_state()
            blocks = _blocks(31, 3, n)
            for blk in blocks[:2 + rank]:
                st, _ = eng.step(st, co, torch.from_numpy(blk))
            if rank == 0:
                time.sleep(DIVERGE_TIMEOUT + 4)
            print(f"rank {rank}: done", flush=True)
            return
        res = {}
        for c_s, p_s in MESHES:
            res.update(_run_all(M.make_mesh(c_s, p_s)))
        res["refusals"] = np.array([
            _refusal(lambda: M.make_mesh(devices=[(0, "cpu")] * 4)),
            _refusal(lambda: M.make_mesh(devices=["cpu"] * 4)),
            _refusal(lambda: StreamProcessor(EngineConfig(), device="cpu",
                                             mesh=mesh)),
            _refusal(lambda: StreamProcessor(EngineConfig(), device="cpu"
                                             )._resolve_mesh())])
        res["group"] = np.array([M.process_index(), M.process_count()])
        res["jax_loaded"] = np.array("jax" in sys.modules)
        np.savez(out, **res)
        print(f"rank {rank}: saved {len(res)} arrays", flush=True)
    finally:
        M.shutdown_distributed()


# ---------------------------------------------------------------------------
# Launching the workers
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(out_dir, mode="run"):
    """Two workers on one fresh port: [(returncode, output, seconds)]."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(rank),
         "2", os.path.join(out_dir, f"rank{rank}.npz"), mode],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for rank in range(2)]
    res = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WAIT)
            res.append((p.returncode, out, time.monotonic() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both workers' results ({name: array} a rank), made once a test
    session: under xdist the first worker to get here runs the pair and
    the others read its files."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        out_dir = str(tmp_path_factory.mktemp("multihost"))
    else:
        out_dir = str(tmp_path_factory.getbasetemp().parent
                      / "torch_multihost")
        os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = os.path.join(out_dir, "done")
        if not os.path.exists(done):
            res = _launch(out_dir)
            for rank, (rc, out, _) in enumerate(res):
                assert rc == 0, f"worker {rank} failed:\n{out}"
            open(done, "w").close()
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(2)]


_ONE = {}


def _one_process(c_s, p_s) -> dict:
    """``_run_all`` on a one-process mesh of the same shape."""
    if (c_s, p_s) not in _ONE:
        _ONE[c_s, p_s] = _run_all(M.make_mesh(c_s, p_s,
                                              devices=["cpu"] * 4))
    return _ONE[c_s, p_s]


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends (see
    tests/test_session_sharded.py)."""
    yield
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()


def _keys(res, prefix):
    return sorted(k for k in res if k.startswith(prefix + "."))


def test_workers_ran_without_jax(runs):
    for rank, res in enumerate(runs):
        assert res["group"].tolist() == [rank, 2]
        assert not res["jax_loaded"]


@pytest.mark.parametrize("local", LOCALS)
@pytest.mark.parametrize("c_s,p_s", MESHES)
def test_equals_one_process_bit_for_bit(runs, local, c_s, p_s):
    """Outputs and final states on a mesh over two processes equal the
    one-process engine's on the same mesh shape, on both ranks."""
    one = _one_process(c_s, p_s)
    key = f"{local}.{c_s}x{p_s}"
    names = [k for k in _keys(one, key) if not k.endswith((".comm",
                                                           ".cross"))]
    assert f"{key}.out" in names and f"{key}.state0" in names
    for res in runs:
        for k in names:
            np.testing.assert_array_equal(res[k], one[k], err_msg=k)


@pytest.mark.parametrize("what", ["xfade", "macro"])
@pytest.mark.parametrize("c_s,p_s", MESHES)
def test_crossfade_and_macro_equal_one_process(runs, what, c_s, p_s):
    """The hc crossfade and the two-stage macro steps across processes,
    bit for bit against one process; the macro steps also within 1e-6 of
    the step loop (tests/test_torch_parallel.py's bound)."""
    tag = f"{c_s}x{p_s}"
    one = _one_process(c_s, p_s)
    for res in runs:
        np.testing.assert_array_equal(res[f"{what}.{tag}.out"],
                                      one[f"{what}.{tag}.out"])
        if what == "macro":
            import test_torch_parallel as TP

            TP._close(res[f"macro.{tag}.out"],
                      res[f"nonuniform.{tag}.out"][:16], 1e-6)


def _reference_stream(local, c_s, p_s, h):
    """The reference's ShardedEngine over the same blocks: (outputs [B, C,
    n], final state leaves)."""
    import jax

    import test_torch_parallel as TP

    jeng, _, h_ref, n, jco, _ = TP._setup(local, c_s, p_s, seed=30)
    np.testing.assert_array_equal(h_ref, h)
    jst, outs = jeng.init_state(), []
    for blk in _blocks(31, _N_BLOCKS[local], n, h.dtype):
        jst, jo = jeng.step(jst, jco, blk)
        outs.append(np.asarray(jo))
    return np.stack(outs), jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, jst))


@pytest.mark.parametrize("local", LOCALS)
@pytest.mark.parametrize("c_s,p_s", MESHES)
def test_matches_reference(runs, local, c_s, p_s):
    """Block for block and the final state in the global layout against
    the reference's ShardedEngine on a mesh of the same shape."""
    import test_torch_parallel as TP

    key = f"{local}.{c_s}x{p_s}"
    rel = 1e-9 if local == "complex" else 1e-5
    ref, ref_state = _reference_stream(local, c_s, p_s, runs[0][f"{key}.h"])
    n_state = sum(".state" in k for k in _keys(runs[0], key))
    state = [runs[0][f"{key}.state{i}"] for i in range(n_state)]
    for b in range(ref.shape[0]):
        TP._close(runs[0][f"{key}.out"][b], ref[b], rel)
    assert len(state) == len(ref_state)
    for g, w in zip(state, ref_state):
        if np.iscomplexobj(w):
            g, w = g.view(np.float64), w.view(np.float64)
        TP._close(g, np.asarray(w, dtype=np.float64), rel)


@pytest.mark.parametrize("c_s,p_s", MESHES)
def test_crossfade_matches_reference(runs, c_s, p_s):
    import test_torch_parallel as TP

    jeng, _, h, n, jco, _ = TP._setup("hc", c_s, p_s, seed=22)
    jco2 = jeng.prepare_coeffs(h[:, ::-1].copy())
    jst = jeng.init_state()
    got = runs[1][f"xfade.{c_s}x{p_s}.out"]
    for b, blk in enumerate(_blocks(23, 6, n)):
        if b == 3:
            jst, jo = jeng.step_crossfade(jst, jco, jco2, blk)
        else:
            jst, jo = jeng.step(jst, jco if b < 3 else jco2, blk)
        TP._close(got[b], jo)


@pytest.mark.parametrize("local", LOCALS)
@pytest.mark.parametrize("c_s,p_s", MESHES)
def test_matches_scipy(runs, local, c_s, p_s):
    """The reference worker's oracle: the linear convolution from the
    start, 1e-9 absolute (complex, float64), 1e-5 relative otherwise."""
    from scipy import signal

    key = f"{local}.{c_s}x{p_s}"
    h = runs[0][f"{key}.h"].astype(np.float64)
    out = runs[1][f"{key}.out"]
    b, _, n = out.shape
    x = _blocks(31, b, n, runs[0][f"{key}.h"].dtype).astype(np.float64)
    x = x.transpose(1, 0, 2).reshape(C, -1)
    y = out.transpose(1, 0, 2).reshape(C, -1)
    ref = np.stack([signal.fftconvolve(x[c], h[c])[:b * n] for c in range(C)])
    err = float(np.abs(y - ref).max())
    if local == "complex":
        assert err < 1e-9, err
    else:
        assert err / max(1.0, float(np.abs(ref).max())) < 1e-5, err


def _stage_fires(local, nblocks):
    """[(block, stage block length)] of every stage fire in the stream."""
    n = _geometry(local, 1)[0]
    fires = []
    for b in range(nblocks):
        fires.append((b, n))
        if local == "nonuniform" and b % 8 == 7:
            fires.append((b, 8 * n))
        if local == "nonuniform3" and b % 2 == 1:
            fires.append((b, 2 * n))
            if b % 4 == 3:
                fires.append((b, 4 * n))
    return fires


@pytest.mark.parametrize("local", LOCALS)
@pytest.mark.parametrize("c_s,p_s", MESHES)
def test_comm_counts_per_process(runs, local, c_s, p_s):
    """Each process counts the comm model (one ppermute and one psum per
    stage fire, each of its payload's bytes a device), as on one process;
    what crossed between the processes follows the layout: nothing at
    (2, 2), where each row lies on one process, and at (1, 4) one payload
    each way per ppermute, the two partials of rank 1 in and one sum out
    per psum; the output joins send each row's piece to the other rank."""
    key = f"{local}.{c_s}x{p_s}"
    c_l = C // c_s
    fires = _stage_fires(local, _N_BLOCKS[local])
    if local == "complex":
        payload = c_l * (64 + 1) * 16  # [C/c, n + 1] complex128
        sizes = [payload] * len(fires)
    else:
        sizes = [2 * c_l * (-(-m // 128) * 128) * 4 for _, m in fires]
    model = [len(fires), sum(sizes)] * 2
    n = _geometry(local, p_s)[0]
    piece = c_l * n * np.dtype(runs[0][f"{key}.h"].dtype).itemsize
    blocks = _N_BLOCKS[local]
    one = _one_process(c_s, p_s)[f"{key}.comm"].tolist()
    for rank, res in enumerate(runs):
        assert res[f"{key}.comm"].tolist() == model == one, rank
        cross = res[f"{key}.cross"].tolist()
        if (c_s, p_s) == (2, 2):
            want = [0, 0, 0, 0, blocks * piece, blocks * piece]
        else:
            b = sum(sizes)
            psum = [b, 2 * b] if rank == 0 else [2 * b, b]
            join = [blocks * piece, 0] if rank == 0 else [0, blocks * piece]
            want = [b, b, *psum, *join]
        assert cross == want, (rank, cross, want)


def test_mesh_and_session_refusals_in_a_group(runs):
    """In a group, a mesh whose ranks do not cover it and a mesh entry
    without its owner raise; the session refuses a mesh that spans
    processes, and its default mesh."""
    for res in runs:
        cover, owner, session, default = res["refusals"].tolist()
        assert "do not cover the group of 2" in cover
        assert "names its owner rank" in owner
        assert "one-process mesh" in session and "ShardedEngine" in session
        assert "one-process mesh" in default


def test_divergence_fails_within_the_group_timeout(tmp_path):
    """Rank 1 steps once more than rank 0: it fails in shard_map's
    ppermute within the group's timeout instead of hanging; rank 0 ends."""
    (rc0, out0, _), (rc1, out1, t1) = _launch(str(tmp_path), "diverge")
    assert rc0 == 0, out0
    assert rc1 != 0, out1
    assert "PeerError: shard_map: the ppermute collective failed" in out1
    assert "waited on rank(s) [0]" in out1
    assert "rank 1: done" not in out1
    assert t1 < DIVERGE_TIMEOUT + 20, t1


def test_init_distributed_arguments():
    """One process is a no-op; every refusal raises before a connection is
    attempted, and leaves no group behind."""
    assert M.init_distributed() is None
    assert M.init_distributed("localhost:1", 1, 0) is None
    bad = [
        (dict(backend="nccl", local_device_ids=["cpu"]),
         (RuntimeError, ValueError), "nccl"),
        (dict(backend="mpi"), ValueError, "'nccl' or 'gloo'"),
        (dict(local_device_ids=["cpu", "cuda:0"]), ValueError, "one type"),
        (dict(local_device_ids=["tpu"]), (RuntimeError, ValueError), "tpu"),
    ]
    for kw, exc, match in bad:
        with pytest.raises(exc, match=match):
            M.init_distributed("localhost:1", 2, 0, **kw)
    with pytest.raises(ValueError, match="coordinator"):
        M.init_distributed(None, 2, 0)
    for pid in (None, 2, -1):
        with pytest.raises(ValueError, match="not a rank of 2"):
            M.init_distributed("localhost:1", 2, pid)
    assert M.process_count() == 1 and M.process_index() == 0


def test_init_distributed_missing_peer_raises():
    """Rank 0 of two, its peer never started: the group's set-up fails
    within its timeout, and no group is left."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        M.init_distributed(f"localhost:{_free_port()}", 2, 0,
                           backend="gloo", local_device_ids=["cpu"],
                           timeout=2.0)
    assert time.monotonic() - t0 < 30
    assert M.process_count() == 1
    assert not torch.distributed.is_initialized()


def test_mesh_ranks_without_a_group():
    """Without a group, (rank, device) entries must name rank 0, and a mesh
    that this process owns no shard of is refused."""
    mesh = M.make_mesh(1, 2, devices=[(0, "cpu"), (0, "cpu")])
    assert mesh.ranks.tolist() == [[0, 0]] and not mesh.spans_processes
    assert mesh.local == [(0, 0), (0, 1)] and mesh.is_local(0, 1)
    with pytest.raises(ValueError, match="no process group"):
        M.make_mesh(devices=[(0, "cpu"), (1, "cpu")])
    with pytest.raises(ValueError, match="owns no shard"):
        M.Mesh(np.array([[torch.device("cpu")]], dtype=object), ranks=[[1]])


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5] if len(sys.argv) > 5 else "run")
