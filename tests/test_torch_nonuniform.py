"""bfir_tpu_torch engines on CPU against bfir_tpu: the two-stage engine at
a geometry where the tail inverse takes the fused kernel's path (the
reference run with its Pallas kernels in interpret mode), state hand-over
between the packages, the halfcomplex step and the crossfades.

Tolerance: 1e-5 x max|reference| (float32 FFTs and MACs summed in other
orders); int24 ring states compare decoded, to 1 LSB."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bfir_tpu.core import nonuniform as JNU
from bfir_tpu.core.spec import FilterSpec
from bfir_tpu_torch.core.spec import FilterSpec as TFilterSpec
from bfir_tpu.kernels import spectrum_mac as JK
from bfir_tpu_torch import convert
from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.kernels import spectrum_mac as K

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends: XLA's CPU
    compiler has aborted xdist workers late in full runs once many
    executables had accumulated in one process (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


GEOM = dict(block_length=128, ratio=8, p_head=16, p_tail=2)
C = 2
N_BLOCKS = 32  # four M-cycles: the tail output lands from block 24 on


def _close(got, ref, rel=1e-5):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _inputs(seed, n_taps):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((C, n_taps))
         * np.exp(-np.arange(n_taps) / 1500.0)).astype(np.float32) * 0.1
    x = rng.standard_normal((N_BLOCKS, C, GEOM["block_length"])).astype(np.float32)
    return h, x


def _compare_states(tstate, jstate):
    """Port state (as numpy) against the reference state, leaf by leaf;
    integer rings compare decoded."""
    t = convert.nu_state_to_numpy(tstate)
    j = jax.tree_util.tree_map(np.asarray, jstate)
    for tt, jj in ((t.head, j.head), (t.tail, j.tail)):
        assert int(tt.blockcounter) == int(jj.blockcounter)
        _close(tt.prev_block, jj.prev_block, 0)
        if isinstance(tt.ring, K.IntPlanes):
            dq = K.dequantize_planes(
                convert.planes_from_numpy(tt.ring, "cpu")).numpy()
            jdq = np.asarray(JK.dequantize_planes(jj.ring))
            lsb = np.asarray(jj.ring.scale)[..., :1]
            assert np.all(np.abs(dq - jdq) <= 1.001 * lsb + 1e-5 * np.abs(jdq).max())
        else:
            _close(tt.ring, jj.ring)
    _close(t.inbuf, j.inbuf, 0)
    _close(t.pending, j.pending)


@pytest.mark.parametrize("store", ["float32", "int24"])
def test_step_nu_and_fast_match_reference(store):
    jspec = JNU.NuSpec(**GEOM, tail_store=store)
    tspec = NU.NuSpec(**GEOM, tail_store=store)
    h, x = _inputs(20, jspec.max_taps - 100)
    jco = JNU.nu_coeffs(h, jspec, C)
    jst, jy = JNU.process_blocks_nu_fast(JNU.init_nu_state(jspec, C), jco,
                                         jnp.asarray(x), use_pallas=True,
                                         interpret=True)
    tco = NU.nu_coeffs(h, tspec, C, device="cpu")
    st = NU.init_nu_state(tspec, C, device="cpu")
    ys = []
    for blk in x:
        st, y = NU.step_nu(st, tco, torch.from_numpy(blk))
        ys.append(y)
    _close(torch.stack(ys), jy)
    _compare_states(st, jst)
    st2, y2 = NU.process_blocks_nu_fast(
        NU.init_nu_state(tspec, C, device="cpu"), tco, torch.from_numpy(x))
    _close(y2, jy)
    assert np.abs(np.asarray(jy)[-8:]).max() > 0  # the tail reached the output
    with pytest.raises(ValueError, match="multiple of R"):
        NU.process_blocks_nu_fast(st2, tco, torch.from_numpy(x[:5]))


def test_state_hand_over_between_packages():
    """Stream k blocks in bfir_tpu, convert state and coefficients, finish
    in the port: the output equals bfir_tpu finishing the stream."""
    spec = JNU.NuSpec(**GEOM, tail_store="int24")
    h, x = _inputs(21, spec.max_taps)
    jco = JNU.nu_coeffs(h, spec, C)
    k = 13  # mid M-cycle
    jst, _ = JNU.process_blocks_nu(JNU.init_nu_state(spec, C), jco,
                                   jnp.asarray(x[:k]), use_pallas=False)
    jst_end, jy = JNU.process_blocks_nu(jst, jco, jnp.asarray(x[k:]),
                                        use_pallas=False)
    tst = convert.nu_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst),
                                      "cpu")
    tco = convert.nu_coeffs_from_numpy(jax.tree_util.tree_map(np.asarray, jco),
                                       "cpu")
    tst, ty = NU.process_blocks_nu(tst, tco, torch.from_numpy(x[k:]))
    _close(ty, jy)
    _compare_states(tst, jst_end)
    # and back: the port's state resumes in the reference
    treedef = jax.tree_util.tree_structure(jst_end)
    back = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in
                  jax.tree_util.tree_leaves(convert.nu_state_to_numpy(tst))])
    more = np.random.default_rng(22).standard_normal((3, C, 128)).astype(np.float32)
    _, jy2 = JNU.process_blocks_nu(back, jco, jnp.asarray(more), use_pallas=False)
    _, ty2 = NU.process_blocks_nu(tst, tco, torch.from_numpy(more))
    _close(ty2, jy2)


def test_step_hc_and_crossfade_match_reference():
    rng = np.random.default_rng(23)
    spec = FilterSpec(block_length=64, n_partitions=4, dtype="float32")
    tspec = TFilterSpec(block_length=64, n_partitions=4, dtype="float32")
    h1 = rng.standard_normal((C, 250)).astype(np.float32)
    h2 = rng.standard_normal((1, 256)).astype(np.float32)  # shared planes
    x = rng.standard_normal((6, C, 64)).astype(np.float32)
    j1, j2 = JK.hc_coeffs(h1, spec, C), JK.hc_coeffs(h2, spec, C, shared=True)
    t1 = K.hc_coeffs(h1, tspec, C, device="cpu")
    t2 = K.hc_coeffs(h2, tspec, C, shared=True, device="cpu")
    js, ts = JK.init_hc_state(spec, C), K.init_hc_state(tspec, C, device="cpu")
    for i, blk in enumerate(x):
        if i == 3:
            js, jy = JK.step_hc_crossfade(js, j1, j2, jnp.asarray(blk),
                                          interpret=True)
            ts, ty = K.step_hc_crossfade(ts, t1, t2, torch.from_numpy(blk))
        else:
            jc, tc = (j1, t1) if i < 3 else (j2, t2)
            js, jy = JK.step_hc(js, jc, jnp.asarray(blk), interpret=True)
            ts, ty = K.step_hc(ts, tc, torch.from_numpy(blk))
        _close(ty, jy)
    assert ts.blockcounter == int(js.blockcounter) == 6


def test_step_nu_crossfade_matches_reference():
    spec = JNU.NuSpec(block_length=16, ratio=2, p_head=4, p_tail=3)
    tspec = NU.NuSpec(block_length=16, ratio=2, p_head=4, p_tail=3)
    rng = np.random.default_rng(24)
    h1 = rng.standard_normal((C, spec.max_taps)).astype(np.float32)
    h2 = rng.standard_normal((C, spec.max_taps)).astype(np.float32)
    x = rng.standard_normal((10, C, 16)).astype(np.float32)
    jo, jn = JNU.nu_coeffs(h1, spec, C), JNU.nu_coeffs(h2, spec, C)
    to = NU.nu_coeffs(h1, tspec, C, device="cpu")
    tn = NU.nu_coeffs(h2, tspec, C, device="cpu")
    js = JNU.init_nu_state(spec, C)
    ts = NU.init_nu_state(tspec, C, device="cpu")
    jstep = jax.jit(lambda s, c, b: JNU.step_nu(s, c, b, use_pallas=False))
    jxfade = jax.jit(lambda s, o, n, b, r: JNU.step_nu_crossfade(
        s, o, n, b, head_ramp=r, use_pallas=False), static_argnums=4)
    for i, blk in enumerate(x):
        jb, tb = jnp.asarray(blk), torch.from_numpy(blk)
        if i in (4, 5):  # change at phase 0, bridging fire at phase 1
            js, jy = jxfade(js, jo, jn, jb, i == 4)
            ts, ty = NU.step_nu_crossfade(ts, to, tn, tb, head_ramp=i == 4)
        else:
            jc, tc = (jo, to) if i < 4 else (jn, tn)
            js, jy = jstep(js, jc, jb)
            ts, ty = NU.step_nu(ts, tc, tb)
        _close(ty, jy)
