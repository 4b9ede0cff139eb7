"""bfir_tpu_torch's sharded engine (``parallel/mesh``, ``parallel/sharded``)
on CPU meshes against bfir_tpu's ``ShardedEngine`` on the 8 virtual CPU
devices (Pallas kernels in interpret mode, as tests/test_parallel.py runs
it) and against the port's single-device engines.

The port's meshes repeat the CPU device (``["cpu"] * 8``): every shard is
its own tensor, and the collectives run as they would between cards.
Geometries are the reference tests' own, at C = 8 (so the (8, 1) mesh has
a channel a shard) and N = 64 or 128.

Tolerances: 1e-5 x max(1, max|reference|) in float32 (FFTs, MACs and the
psum summed in other orders), 1e-10 in float64; the bf16 tail store is held
to the reference's own bound (> 40 dB against scipy)."""

import numpy as np
import pytest
import torch
from scipy import signal

import jax

from bfir_tpu.core import convolver as JCV
from bfir_tpu.core import nonuniform as JNU
from bfir_tpu.core.spec import FilterSpec as JFilterSpec
from bfir_tpu.parallel import mesh as JM
from bfir_tpu.parallel import sharded as JSH
from bfir_tpu_torch import convert
from bfir_tpu_torch.core import convolver as cv
from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.core.spec import FilterSpec
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.parallel import mesh as M
from bfir_tpu_torch.parallel import sharded as SH

torch.set_num_threads(1)

C = 8
MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


def _meshes(c_s, p_s):
    """(the reference's mesh, the port's mesh) of the same shape."""
    if len(jax.devices()) < c_s * p_s:
        pytest.skip("needs 8 virtual JAX devices")
    return (JM.make_mesh(c_s, p_s, devices=jax.devices()[:c_s * p_s]),
            M.make_mesh(c_s, p_s, devices=["cpu"] * (c_s * p_s)))


def _close(got, ref, rel=1e-5):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(1.0, np.abs(ref).max()))


def _nu3_specs(p_s, n=128, tail_store="float32"):
    """The reference tests' three-stage geometry (r1 = r2 = 2), in both
    packages' classes."""
    p_head = int(np.lcm(4, p_s))
    geo = dict(p_head=p_head, p_tail=2 * p_s)
    j = JNU.Nu3Spec(n, 2, p_head, JNU.NuSpec(
        block_length=2 * n, ratio=2, dtype="float32", tail_store=tail_store,
        **geo))
    t = NU.Nu3Spec(n, 2, p_head, NU.NuSpec(
        block_length=2 * n, ratio=2, dtype="float32", tail_store=tail_store,
        **geo))
    return j, t


def _setup(local, c_s, p_s, seed, tail_store="float32"):
    """Both engines on one filter: (jax engine, port engine, h, n, jax
    coeffs, port coeffs)."""
    jmesh, tmesh = _meshes(c_s, p_s)
    rng = np.random.default_rng(seed)
    j_nu = t_nu = None
    if local == "complex":
        n, taps, dtype = 64, 8 * 64, "float64"
    elif local == "hc":
        n, taps, dtype = 128, 8 * 128, "float32"
    elif local == "nonuniform":
        n, dtype = 128, "float32"
        taps = 16 * n + 5 * 8 * n
    else:
        n, dtype = 128, "float32"
        j_nu, t_nu = _nu3_specs(p_s, n, tail_store)
        taps = j_nu.max_taps
    parts = taps // n
    parts = -(-parts // p_s) * p_s
    h = (rng.standard_normal((C, taps)) * 0.05).astype(dtype)
    jeng = JSH.ShardedEngine(JFilterSpec(n, parts, dtype), C, jmesh,
                             local_impl=local, nuspec=j_nu,
                             nu_tail_store=tail_store)
    teng = SH.ShardedEngine(FilterSpec(n, parts, dtype), C, tmesh,
                            local_impl=local, nuspec=t_nu,
                            nu_tail_store=tail_store)
    return jeng, teng, h, n, jeng.prepare_coeffs(h), teng.prepare_coeffs(h)


def _blocks(seed, b, n, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((b, C, n)).astype(
        dtype)


def _single_device(local, teng, h):
    """The port's single-device engine for ``teng``'s geometry: (step,
    state, coefficients)."""
    cpu = torch.device("cpu")
    if local == "complex":
        return (cv.step, cv.init_state(teng.spec, C, device=cpu),
                cv.coeffs_to_spectra(h, teng.spec, device=cpu))
    if local == "hc":
        return (K.step_hc, K.init_hc_state(teng.spec, C, device=cpu),
                K.hc_coeffs(h, teng.spec, C, device=cpu))
    if local == "nonuniform":
        return (NU.step_nu, NU.init_nu_state(teng.nuspec, C, device=cpu),
                NU.nu_coeffs(h, teng.nuspec, C, device=cpu))
    return (NU.step_nu3, NU.init_nu3_state(teng.nuspec, C, device=cpu),
            NU.nu3_coeffs(h, teng.nuspec, C, device=cpu))


_N_BLOCKS = {"complex": 6, "hc": 10, "nonuniform": 19, "nonuniform3": 13}


@pytest.mark.parametrize("local", ["complex", "hc", "nonuniform",
                                   "nonuniform3"])
@pytest.mark.parametrize("c_s,p_s", MESHES)
def test_sharded_step_matches_reference_and_single_device(local, c_s, p_s):
    """Every local engine at every mesh shape: block for block against the
    reference's ShardedEngine and the port's single-device engine, and the
    final state, joined to the global layout, against the reference's."""
    jeng, teng, h, n, jco, tco = _setup(local, c_s, p_s, seed=30)
    rel = 1e-10 if local == "complex" else 1e-5
    x = _blocks(31, _N_BLOCKS[local], n, h.dtype)
    jst, tst = jeng.init_state(), teng.init_state()
    step1, st1, co1 = _single_device(local, teng, h)
    for b, blk in enumerate(x):
        jst, jo = jeng.step(jst, jco, blk)
        tst, to = teng.step(tst, tco, torch.from_numpy(blk))
        st1, o1 = step1(st1, co1, torch.from_numpy(blk))
        _close(to, jo, rel)
        _close(to, o1, rel)
    got = jax.tree_util.tree_leaves(convert.sharded_state_to_numpy(tst, teng))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jst))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if np.iscomplexobj(w):
            g, w = g.view(np.float64), w.view(np.float64)
        _close(g, np.asarray(w, dtype=np.float64), rel)


def test_sharded_bf16_tail_store():
    """nu_tail_store="bfloat16": the tail ring and planes stored bf16 per
    shard, output in the reference's class (> 40 dB against scipy) and
    near the reference's own sharded output."""
    jeng, teng, h, n, jco, tco = _setup("nonuniform", 2, 4, seed=34,
                                        tail_store="bfloat16")
    assert teng.init_state().tail.ring[0, 0].dtype == torch.bfloat16
    assert tco.tail[0, 0].dtype == torch.bfloat16
    x = _blocks(35, 4 * teng.nuspec.ratio, n)
    jst, tst = jeng.init_state(), teng.init_state()
    ys, js = [], []
    for blk in x:
        jst, jo = jeng.step(jst, jco, blk)
        tst, to = teng.step(tst, tco, torch.from_numpy(blk))
        ys.append(to.numpy())
        js.append(np.asarray(jo))
    y = np.concatenate(ys, axis=1)
    flat = x.transpose(1, 0, 2).reshape(C, -1).astype(np.float64)
    ref = np.stack([signal.fftconvolve(flat[c], h[c].astype(np.float64))
                    [: y.shape[1]] for c in range(C)])
    snr = 10 * np.log10(float((ref ** 2).sum())
                        / float(((y - ref) ** 2).sum()))
    assert snr > 40, snr
    _close(y, np.concatenate(js, axis=1), 1e-2)


def test_hc_chunk_reorder_index_law():
    """K1's plain version at pos = 0 on a reordered chunk computes the
    rolled sum sum_j coeff[j] ring[j] (P/p = 4 >= 3, where the reorder is
    not the identity), and the reorder equals the reference's."""
    rng = np.random.default_rng(5)
    p, p_s, c, hp = 16, 4, 3, 128
    ring = rng.standard_normal((p, 2, c, hp)).astype(np.float32)
    coeff = rng.standard_normal((p, 2, c, hp)).astype(np.float32)
    t_re = SH._hc_chunk_reorder(torch.from_numpy(coeff), p_s)
    np.testing.assert_array_equal(
        t_re.numpy(), np.asarray(JSH._hc_chunk_reorder(coeff, p_s)))
    assert not np.array_equal(t_re.numpy(), coeff)
    pl_ = p // p_s
    total = np.zeros((2, c, hp), np.float64)
    for i in range(p_s):
        r = torch.from_numpy(ring[i * pl_:(i + 1) * pl_]).reshape(pl_, 2 * c,
                                                                 hp)
        g = t_re[i * pl_:(i + 1) * pl_].reshape(pl_, 2 * c, hp)
        yr, yi = K.mac_hc_plain(r, g, 0)
        total += np.stack([yr.numpy(), yi.numpy()])
    # the rolled sum, lane 0 by the halfcomplex law (two real products)
    rr, ri, cr, ci = ring[:, 0], ring[:, 1], coeff[:, 0], coeff[:, 1]
    want_r = (cr * rr - ci * ri).sum(0)
    want_i = (cr * ri + ci * rr).sum(0)
    want_r[:, 0] = (cr[:, :, 0] * rr[:, :, 0]).sum(0)
    want_i[:, 0] = (ci[:, :, 0] * ri[:, :, 0]).sum(0)
    _close(total, np.stack([want_r, want_i]))


def test_step_rolled_and_converters():
    """``step_rolled`` against the reference's and against ``step``; the
    rolled and pointer rings convert into each other."""
    rng = np.random.default_rng(0)
    spec = FilterSpec(block_length=64, n_partitions=4, dtype="float64")
    jspec = JFilterSpec(block_length=64, n_partitions=4, dtype="float64")
    h = rng.standard_normal(200)
    cpu = torch.device("cpu")
    co = cv.coeffs_to_spectra(h, spec, device=cpu)
    jco = JCV.coeffs_to_spectra(h, jspec)
    s_ptr = cv.init_state(spec, 2, device=cpu)
    s_rol = cv.init_state(spec, 2, device=cpu)
    j_rol = JCV.init_state(jspec, 2)
    x = rng.standard_normal((2, 64 * 8))
    for b in range(8):
        blk = x[:, b * 64:(b + 1) * 64]
        s_ptr, o1 = cv.step(s_ptr, co, torch.from_numpy(blk))
        s_rol, o2 = cv.step_rolled(s_rol, co, torch.from_numpy(blk))
        j_rol, o3 = JCV.step_rolled(j_rol, jco, blk)
        np.testing.assert_allclose(o2.numpy(), o1.numpy(), atol=1e-12)
        np.testing.assert_allclose(o2.numpy(), np.asarray(o3), atol=1e-12)
    conv = cv.rolled_from_state(s_ptr)
    np.testing.assert_allclose(conv.spectra_ring.numpy(),
                               s_rol.spectra_ring.numpy(), atol=1e-12)
    back = cv.state_from_rolled(conv)
    np.testing.assert_array_equal(back.spectra_ring.numpy(),
                                  s_ptr.spectra_ring.numpy())
    # a rolled stream continues on the pointer step
    blk = torch.from_numpy(rng.standard_normal((2, 64)))
    _, o_a = cv.step(cv.state_from_rolled(s_rol), co, blk)
    _, o_b = cv.step_rolled(s_rol, co, blk)
    np.testing.assert_allclose(o_a.numpy(), o_b.numpy(), atol=1e-12)


def test_make_mesh_validation():
    with pytest.raises(ValueError, match="3x3"):
        M.make_mesh(3, 3, devices=["cpu"] * 8)
    assert M.make_mesh(devices=["cpu"] * 8).shape == {"c": 1, "p": 8}
    assert M.make_mesh(2, devices=["cpu"] * 8).shape == {"c": 2, "p": 4}
    assert M.make_mesh(partition_shards=2,
                       devices=["cpu"] * 8).shape == {"c": 4, "p": 2}
    with pytest.raises(ValueError, match="one type"):
        M.make_mesh(devices=["cpu", "cuda:0"])
    if torch.cuda.is_available():
        assert M.make_mesh().device_type == "cuda"
    else:  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            M.make_mesh()
    M.init_distributed()  # one process: a no-op
    # NCCL for CPU devices is refused before any connection is attempted
    # (RuntimeError on a host without CUDA, ValueError on one with it)
    with pytest.raises((RuntimeError, ValueError), match="nccl"):
        M.init_distributed("localhost:1234", 2, 0, backend="nccl",
                           local_device_ids=["cpu"])
    assert M.process_count() == 1


def test_sharding_split_join_round_trip():
    """Each shard holds its own contiguous piece on its device; join puts
    the global tensor back; replicated axes hold a copy per shard."""
    mesh = M.make_mesh(2, 4, devices=["cpu"] * 8)
    t = torch.arange(8 * 2 * 6 * 3, dtype=torch.float32).reshape(8, 2, 6, 3)
    sh = M.Sharding(mesh, ("p", None, "c", None))
    g = sh.split(t)
    assert g.shape == (2, 4)
    assert {tuple(x.shape) for x in g.flat} == {(2, 2, 3, 3)}
    assert all(x.is_contiguous() for x in g.flat)
    torch.testing.assert_close(g[1, 2], t[4:6, :, 3:6])
    torch.testing.assert_close(sh.join(g), t)
    rep = M.block_sharding(mesh).split(t[0, 0])
    assert rep[0, 0] is not rep[0, 1]  # a copy per shard
    torch.testing.assert_close(M.block_sharding(mesh).join(rep), t[0, 0])
    with pytest.raises(ValueError, match="divide"):
        M.Sharding(mesh, ("c", None)).split(torch.zeros(3, 4))


def test_engine_validation():
    """Every ValueError of ShardedEngine, and the nu3 crossfade refusal."""
    mesh = M.make_mesh(2, 4, devices=["cpu"] * 8)
    spec = FilterSpec(block_length=64, n_partitions=8, dtype="float32")
    with pytest.raises(ValueError, match="not divisible by mesh p"):
        SH.ShardedEngine(FilterSpec(64, 7, "float32"), 4, mesh)
    with pytest.raises(ValueError, match="not divisible by mesh c"):
        SH.ShardedEngine(spec, 3, mesh)
    with pytest.raises(ValueError, match="GSPMD"):
        SH.ShardedEngine(spec, 4, mesh, schedule="gspmd")
    with pytest.raises(ValueError, match="schedule must be"):
        SH.ShardedEngine(spec, 4, mesh, schedule="ring")
    with pytest.raises(ValueError, match="local_impl must be"):
        SH.ShardedEngine(spec, 4, mesh, local_impl="packed")
    long = FilterSpec(block_length=128, n_partitions=64, dtype="float32")
    for local in ("nonuniform", "nonuniform3"):
        with pytest.raises(ValueError, match="integer tail storage"):
            SH.ShardedEngine(long, 4, mesh, local_impl=local,
                             nu_tail_store="int24")
    with pytest.raises(ValueError, match="too short"):
        SH.ShardedEngine(FilterSpec(128, 8, "float32"), 4,
                         M.make_mesh(1, 8, devices=["cpu"] * 8),
                         local_impl="nonuniform")
    mesh3 = M.make_mesh(1, 3, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match=r"nu head partitions \(16\)"):
        SH.ShardedEngine(FilterSpec(128, 66, "float32"), 4, mesh3,
                         local_impl="nonuniform")
    inner = NU.NuSpec(block_length=256, ratio=2, p_head=4, p_tail=8,
                      dtype="float32")
    spec3 = NU.Nu3Spec(block_length=128, ratio1=2, p_head=4, inner=inner)
    with pytest.raises(ValueError, match="not divisible"):
        SH.ShardedEngine(FilterSpec(128, spec3.max_taps // 128, "float32"),
                         4, M.make_mesh(1, 8, devices=["cpu"] * 8),
                         local_impl="nonuniform3", nuspec=spec3)
    with pytest.raises(ValueError, match="too short"):
        SH.ShardedEngine(FilterSpec(128, 144, "float32"), 4, mesh,
                         local_impl="nonuniform3")
    _, teng, h, n, _, tco = _setup("nonuniform3", 2, 4, seed=65)
    with pytest.raises(NotImplementedError, match="rebuild"):
        teng.step_crossfade(teng.init_state(), tco, tco,
                            torch.zeros((C, n)))
    with pytest.raises(ValueError, match="two-stage"):
        SH.ShardedEngine(spec, 4, mesh, local_impl="hc").nu_crossfade_steps()


@pytest.mark.parametrize("c_s,p_s", [(2, 4), (1, 8), (1, 1)])
def test_dryrun(c_s, p_s):
    SH.dryrun(mesh=M.make_mesh(c_s, p_s, devices=["cpu"] * (c_s * p_s)))


def _stage_bytes(c_l, block):
    return 2 * c_l * (-(-block // 128) * 128) * 4


@pytest.mark.parametrize("local", ["hc", "nonuniform", "nonuniform3"])
def test_comm_counter_matches_comm_model(local):
    """One ppermute and one psum per stage fire, each of 2·(C/c)·Hp·4 bytes
    (COMM_MODEL.md): the head every block, the tail (mid, far) pairs only
    on their fire blocks; nothing else is counted."""
    c_s, p_s = 2, 4
    _, teng, h, n, _, tco = _setup(local, c_s, p_s, seed=50)
    st = teng.init_state()
    c_l = C // c_s
    for b, blk in enumerate(_blocks(51, 17, n)):
        stages = [n]
        if local == "nonuniform" and b % teng.nuspec.ratio == 7:
            stages.append(teng.nuspec.m)
        if local == "nonuniform3" and b % 2 == 1:
            stages.append(teng.nuspec.m1)
            if b % 4 == 3:
                stages.append(teng.nuspec.inner.m)
        M.reset_comm_counts()
        st, _ = teng.step(st, tco, torch.from_numpy(blk))
        want = {"calls": len(stages),
                "bytes": sum(_stage_bytes(c_l, s) for s in stages)}
        assert M.comm_counts() == {"ppermute": want, "psum": want}, b


def test_comm_bytes_independent_of_partitions():
    """The per-step traffic is O(C·Hp): 8 and 32 partitions move the same
    bytes."""
    mesh = M.make_mesh(2, 4, devices=["cpu"] * 8)
    counts = []
    for parts in (8, 32):
        eng = SH.ShardedEngine(FilterSpec(128, parts, "float32"), C, mesh,
                               local_impl="hc")
        co = eng.prepare_coeffs(np.ones((C, 128 * parts), np.float32))
        M.reset_comm_counts()
        eng.step(eng.init_state(), co, torch.zeros((C, 128)))
        counts.append(M.comm_counts())
    assert counts[0] == counts[1]
    assert counts[0]["psum"]["bytes"] == _stage_bytes(C // 2, 128)


def test_uniform_crossfades_match_reference():
    """The one-shot crossfade block of the complex and hc local engines
    against the reference's ShardedEngine, then the new filter."""
    for local in ("complex", "hc"):
        jeng, teng, h, n, jco, tco = _setup(local, 2, 4, seed=22)
        h2 = h[:, ::-1].copy()
        jco2, tco2 = jeng.prepare_coeffs(h2), teng.prepare_coeffs(h2)
        rel = 1e-10 if local == "complex" else 1e-5
        jst, tst = jeng.init_state(), teng.init_state()
        for b, blk in enumerate(_blocks(23, 6, n, h.dtype)):
            t_blk = torch.from_numpy(blk)
            if b < 3:
                jst, jo = jeng.step(jst, jco, blk)
                tst, to = teng.step(tst, tco, t_blk)
            elif b == 3:
                jst, jo = jeng.step_crossfade(jst, jco, jco2, blk)
                tst, to = teng.step_crossfade(tst, tco, tco2, t_blk)
            else:
                jst, jo = jeng.step(jst, jco2, blk)
                tst, to = teng.step(tst, tco2, t_blk)
            _close(to, jo, rel)


def test_nu_crossfade_protocol_matches_reference():
    """The sharded (ramp, hold) pair through a whole transition (change
    mid-cycle, bridging tail fire, then the new filter) against the
    reference's pair and the port's single-device step_nu_crossfade."""
    jeng, teng, h, n, jco, tco = _setup("nonuniform", 2, 4, seed=33)
    h2 = (np.random.default_rng(34).standard_normal(h.shape) * 0.05).astype(
        np.float32)
    jco2, tco2 = jeng.prepare_coeffs(h2), teng.prepare_coeffs(h2)
    cpu = torch.device("cpu")
    u_o = NU.nu_coeffs(h, teng.nuspec, C, device=cpu)
    u_n = NU.nu_coeffs(h2, teng.nuspec, C, device=cpu)
    st1 = NU.init_nu_state(teng.nuspec, C, device=cpu)
    jramp, jhold = jeng.nu_crossfade_steps()
    tramp, thold = teng.nu_crossfade_steps()
    r = teng.nuspec.ratio
    warm = r + 2
    jst, tst = jeng.init_state(), teng.init_state()
    fired = False
    for b, blk in enumerate(_blocks(35, warm + 2 * r, n)):
        t_blk = torch.from_numpy(blk)
        if b < warm:
            jst, jo = jeng.step(jst, jco, blk)
            tst, to = teng.step(tst, tco, t_blk)
            st1, o1 = NU.step_nu(st1, u_o, t_blk)
        elif b == warm:
            jst, jo = jramp(jst, jco, jco2, blk)
            tst, to = tramp(tst, tco, tco2, t_blk)
            st1, o1 = NU.step_nu_crossfade(st1, u_o, u_n, t_blk,
                                           head_ramp=True)
        elif not fired:
            jst, jo = jhold(jst, jco, jco2, blk)
            tst, to = thold(tst, tco, tco2, t_blk)
            st1, o1 = NU.step_nu_crossfade(st1, u_o, u_n, t_blk,
                                           head_ramp=False)
        else:
            jst, jo = jeng.step(jst, jco2, blk)
            tst, to = teng.step(tst, tco2, t_blk)
            st1, o1 = NU.step_nu(st1, u_n, t_blk)
        if b >= warm:
            fired = fired or b % r == r - 1
        _close(to, jo)
        _close(to, o1)
    # the step form of the change block is the ramp
    _, ramp_out = teng.step_crossfade(teng.init_state(), tco, tco2,
                                      torch.zeros((C, n)))
    assert ramp_out.shape == (C, n)


@pytest.mark.parametrize("local", ["hc", "nonuniform", "nonuniform3"])
def test_process_blocks_matches_step_loop(local):
    """``process_blocks`` (the macro steps on cycle-aligned work) equals
    the step loop, and the state threads on."""
    _, teng, h, n, _, tco = _setup(local, 2, 4, seed=62)
    cyc = {"hc": 2, "nonuniform": 8, "nonuniform3": 4}[local]
    x = torch.from_numpy(_blocks(63, 2 * cyc, n))
    st_b, ys = teng.process_blocks(teng.init_state(), tco, x)
    st_s = teng.init_state()
    refs = []
    for blk in x:
        st_s, o = teng.step(st_s, tco, blk)
        refs.append(o)
    _close(ys, torch.stack(refs), 1e-6)
    blk = torch.from_numpy(_blocks(64, 1, n)[0])
    _close(teng.step(st_b, tco, blk)[1], teng.step(st_s, tco, blk)[1], 1e-6)
    # unaligned work takes the step loop
    st_u, yu = teng.process_blocks(st_s, tco, x[:3])
    assert yu.shape == (3, C, n)


def test_process_batch_interoperates_with_step():
    """The complex engine's bulk form against the reference's, from a state
    the step left mid-ring, and back to the step."""
    jeng, teng, h, n, jco, tco = _setup("complex", 4, 2, seed=15)
    jst, tst = jeng.init_state(), teng.init_state()
    st1 = cv.init_state(teng.spec, C, device=torch.device("cpu"))
    co1 = cv.coeffs_to_spectra(h, teng.spec, device=torch.device("cpu"))
    x = _blocks(16, 9, n, np.float64)
    for blk in x[:3]:
        jst, jo = jeng.step(jst, jco, blk)
        tst, to = teng.step(tst, tco, torch.from_numpy(blk))
        st1, _ = cv.step(st1, co1, torch.from_numpy(blk))
        _close(to, jo, 1e-10)
    jst, jys = jeng.process_batch(jst, jco, x[3:8])
    tst, tys = teng.process_batch(tst, tco, torch.from_numpy(x[3:8]))
    st1, ys1 = cv.process_batch(st1, co1, torch.from_numpy(x[3:8]))
    _close(tys, jys, 1e-10)
    _close(tys, ys1, 1e-10)
    jst, jo = jeng.step(jst, jco, x[8])
    tst, to = teng.step(tst, tco, torch.from_numpy(x[8]))
    _close(to, jo, 1e-10)
    # the uniform hc engine's bulk form is process_blocks
    _, hc_eng, _, _, _, hc_co = _setup("hc", 2, 4, seed=17)
    xb = torch.from_numpy(_blocks(18, 4, 128))
    _close(hc_eng.process_batch(hc_eng.init_state(), hc_co, xb)[1],
           hc_eng.process_blocks(hc_eng.init_state(), hc_co, xb)[1], 0)


@pytest.mark.parametrize("local", ["hc", "nonuniform", "nonuniform3"])
def test_shared_coeffs_match_broadcast(local):
    """One filter for all channels: [P, 2, 1, Hp] planes replicated over
    "c", broadcast by the MAC, equal to the per-channel build."""
    mesh = M.make_mesh(2, 4, devices=["cpu"] * 8)
    n = 128
    rng = np.random.default_rng(55)
    nuspec = None
    if local == "hc":
        taps = 8 * n
    elif local == "nonuniform":
        taps = 16 * n + 5 * 8 * n
    else:
        _, nuspec = _nu3_specs(4, n)
        taps = nuspec.max_taps
    spec = FilterSpec(n, -(-(taps // n) // 4) * 4, "float32")
    h1 = (rng.standard_normal((1, taps)) * 0.05).astype(np.float32)
    e_sh = SH.ShardedEngine(spec, C, mesh, local_impl=local, nuspec=nuspec,
                            shared_coeffs=True)
    e_bc = SH.ShardedEngine(spec, C, mesh, local_impl=local, nuspec=nuspec)
    co_sh = e_sh.prepare_coeffs(h1)
    co_bc = e_bc.prepare_coeffs(np.broadcast_to(h1, (C, taps)).copy())
    head = co_sh if local == "hc" else co_sh.head
    assert head[0, 0].shape[2] == 1 and head[1, 0] is not head[0, 0]
    st_s, st_b = e_sh.init_state(), e_bc.init_state()
    for blk in _blocks(56, 13, n):
        st_s, o_s = e_sh.step(st_s, co_sh, torch.from_numpy(blk))
        st_b, o_b = e_bc.step(st_b, co_bc, torch.from_numpy(blk))
        _close(o_s, o_b)


def _to_reference(np_tree, jeng, shardings):
    """A port NamedTuple of numpy leaves, placed as the reference's pytree
    of ``jeng`` with its shardings."""
    leaves = jax.tree_util.tree_leaves(np_tree)
    sh = jax.tree_util.tree_leaves(shardings)
    assert len(leaves) == len(sh)
    treedef = jax.tree_util.tree_structure(jeng.init_state()) \
        if shardings is jeng._state_shardings else \
        jax.tree_util.tree_structure(shardings)
    return treedef.unflatten([jax.device_put(a, s)
                              for a, s in zip(leaves, sh)])


def test_nu_stream_moves_between_packages():
    """A sharded two-stage stream started in bfir_tpu at (2, 4) resumes in
    bfir_tpu_torch at (2, 4) mid-cycle, and the other way; the following
    outputs match within 1e-5."""
    jeng, teng, h, n, jco, tco = _setup("nonuniform", 2, 4, seed=70)
    x = _blocks(71, 30, n)
    jst = jeng.init_state()
    for blk in x[:11]:  # mid-cycle, after a tail fire
        jst, _ = jeng.step(jst, jco, blk)
    tst = convert.sharded_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), teng)
    tco2 = convert.sharded_coeffs_from_numpy(
        jax.tree_util.tree_map(np.asarray, jco), teng)
    for a, b in zip(jax.tree_util.tree_leaves(
            convert.sharded_coeffs_to_numpy(tco2, teng)),
            jax.tree_util.tree_leaves(
                convert.sharded_coeffs_to_numpy(tco, teng))):
        _close(a, b)
    for blk in x[11:20]:
        jst, jo = jeng.step(jst, jco, blk)
        tst, to = teng.step(tst, tco2, torch.from_numpy(blk))
        _close(to, jo)
    # and back: the port's state resumes in the reference
    jst2 = _to_reference(convert.sharded_state_to_numpy(tst, teng), jeng,
                         jeng._state_shardings)
    for blk in x[20:]:
        jst2, jo2 = jeng.step(jst2, jco, blk)
        tst, to = teng.step(tst, tco2, torch.from_numpy(blk))
        _close(to, jo2)
