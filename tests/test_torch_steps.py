"""The rest of the uniform-step family of bfir_tpu_torch (``step_split``,
``step_chunked``, ``step_hc2``, ``step_hc_fused``, their states and
coefficient layouts) on CPU against bfir_tpu, whose Pallas kernels run in
interpret mode, on the same numpy inputs; streams handed over between the
packages through ``convert``.

Tolerances, at float64 (as tests/test_kernels.py holds the reference's
own steps): outputs within 1e-10 of the reference's, rings within 1e-12,
and within 1e-9 of scipy's convolution."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import signal

from bfir_tpu.core import spec as JS
from bfir_tpu.kernels import spectrum_mac as JK
from bfir_tpu.ops import fft as JF
from bfir_tpu_torch import convert
from bfir_tpu_torch.core import spec as TS
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.ops import fft as F

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends: XLA's CPU
    compiler has aborted xdist workers late in full runs once many
    executables had accumulated in one process (see
    tests/test_session_sharded.py)."""
    yield
    jax.clear_caches()


P, C = 4, 2


def _specs(blocklen):
    return (JS.FilterSpec(block_length=blocklen, n_partitions=P,
                          dtype="float64"),
            TS.FilterSpec(block_length=blocklen, n_partitions=P,
                          dtype="float64"))


def _inputs(seed, blocklen, blocks, rows=C):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((rows, 3 * blocklen + 50)) * 0.1
    x = rng.standard_normal((C, blocklen * blocks))
    return h, x


def _blocks(x, blocklen):
    return [x[:, i:i + blocklen] for i in range(0, x.shape[1], blocklen)]


def _scipy(x, h):
    return np.stack([signal.fftconvolve(x[c], h[c % h.shape[0]])[:x.shape[1]]
                     for c in range(x.shape[0])])


def _close(got, ref, atol):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("rows", [C, 1], ids=["per_channel", "shared"])
@pytest.mark.parametrize("blocklen", [128, 64])
def test_step_split_matches_reference_and_scipy(blocklen, rows):
    """Shared [P, 1, Fp] coefficients are materialised per channel."""
    sj, st = _specs(blocklen)
    h, x = _inputs(1, blocklen, 8, rows)
    cj = JK.split_coeffs(h, sj)
    ct = K.split_coeffs(h, st, device="cpu")
    for a, b in zip(ct, cj):
        _close(a, b, 1e-12)
    js = JK.init_split_state(sj, C)
    ts = K.init_split_state(st, C, device="cpu")
    outs = []
    for i, blk in enumerate(_blocks(x, blocklen)):
        js, yj = JK.step_split(js, *cj, jnp.asarray(blk), interpret=True)
        ts, yt = K.step_split(ts, *ct, torch.from_numpy(blk))
        _close(yt, yj, 1e-10)
        _close(ts.ring_re, js.ring_re, 1e-12)
        _close(ts.ring_im, js.ring_im, 1e-12)
        outs.append(yt.numpy())
    assert ts.blockcounter == int(js.blockcounter) == 8
    _close(np.concatenate(outs, axis=1), _scipy(x, h), 1e-9)


@pytest.mark.parametrize("blocklen", [128, 64])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_step_chunked_matches_reference_and_packed(k, blocklen):
    sj, st = _specs(blocklen)
    h, x = _inputs(2, blocklen, 7)
    gj = JK.pack_coeffs(h, sj, C)
    gt = K.pack_coeffs(h, st, C, device="cpu")
    crj = JK.chunk_reverse_coeffs(gj, k)
    crt = K.chunk_reverse_coeffs(gt, k)
    js = JK.init_doubled_state(sj, C)
    ts = K.init_doubled_state(st, C, device="cpu")
    ps = K.init_packed_state(st, C, device="cpu")
    assert tuple(ts.ring2.shape) == tuple(js.ring2.shape)
    for blk in _blocks(x, blocklen):
        js, yj = JK.step_chunked(js, crj, jnp.asarray(blk), k=k,
                                 interpret=True)
        ts, yt = K.step_chunked(ts, crt, torch.from_numpy(blk), k=k)
        ps, yp = K.step_packed(ps, gt, torch.from_numpy(blk))
        _close(yt, yj, 1e-10)
        _close(yt, yp, 1e-10)
        _close(ts.ring2, js.ring2, 1e-12)
        # slot s mirrored at s + P
        np.testing.assert_array_equal(ts.ring2[:P].numpy(),
                                      ts.ring2[P:].numpy())
    _close(ts.ring2[:P], ps.ring, 0)


@pytest.mark.parametrize("blocklen", [128, 64])
def test_step_hc2_matches_reference_and_step_hc(blocklen):
    """K13's plain version writes the slot itself: the ring after every
    block equals step_hc's (the reference's test_step_hc2_matches_step_hc
    checks its own the same way)."""
    sj, st = _specs(blocklen)
    h, x = _inputs(3, blocklen, 6)
    cj = JK.hc_coeffs(h, sj, C)
    ct = K.hc_coeffs(h, st, C, device="cpu")
    js = JK.init_hc_state(sj, C)
    ts = K.init_hc_state(st, C, device="cpu")
    hs = K.init_hc_state(st, C, device="cpu")
    for i, blk in enumerate(_blocks(x, blocklen)):
        js, yj = JK.step_hc2(js, cj, jnp.asarray(blk), interpret=True)
        ts, yt = K.step_hc2(ts, ct, torch.from_numpy(blk))
        hs, yh = K.step_hc(hs, ct, torch.from_numpy(blk))
        _close(yt, yj, 1e-10)
        _close(yt, yh, 1e-10)
        _close(ts.ring, js.ring, 1e-12)
        np.testing.assert_array_equal(ts.ring.numpy(), hs.ring.numpy(),
                                      err_msg=f"ring after block {i}")


@pytest.mark.parametrize("blocklen", [128, 64])  # 64: Hp (128) > h (64)
def test_step_hc_fused_matches_reference_and_step_hc(blocklen):
    sj, st = _specs(blocklen)
    h, x = _inputs(4, blocklen, 6)
    cj = JK.hc_coeffs(h, sj, C)
    ct = K.hc_coeffs(h, st, C, device="cpu")
    js = JK.init_hc_state(sj, C)
    ts = K.init_hc_state(st, C, device="cpu")
    hs = K.init_hc_state(st, C, device="cpu")
    outs = []
    for blk in _blocks(x, blocklen):
        js, yj = JK.step_hc_fused(js, cj, jnp.asarray(blk), interpret=True)
        ts, yt = K.step_hc_fused(ts, ct, torch.from_numpy(blk))
        hs, yh = K.step_hc(hs, ct, torch.from_numpy(blk))
        assert tuple(yt.shape) == (C, blocklen)
        _close(yt, yj, 1e-10)
        _close(yt, yh, 1e-10)
        _close(ts.ring, js.ring, 1e-12)
        outs.append(yt.numpy())
    _close(np.concatenate(outs, axis=1), _scipy(x, h), 1e-9)


@pytest.mark.parametrize("n, hp", [(128, 128), (64, 128)])
def test_tail_basis_matches_reference(n, hp):
    """The basis is computed in float64 and cast once: bit-equal to the
    reference's, zero-padded to [Hp, Hp], cached per (n, Hp, dtype,
    device)."""
    for dt in (torch.float32, torch.float64):
        wr, wi = K._tail_basis(n, hp, dt, torch.device("cpu"))
        jr, ji = JK._tail_basis(n, hp, str(dt).split(".")[-1])
        assert wr.dtype == dt and tuple(wr.shape) == (hp, hp)
        np.testing.assert_array_equal(wr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(wi.numpy(), np.asarray(ji))
        assert K._tail_basis(n, hp, dt, torch.device("cpu"))[0] is wr
    tr, ti = F._hc_tail_weights(2 * n, "float64")
    rr, ri = JF._hc_tail_weights(2 * n, "float64")
    np.testing.assert_array_equal(tr, rr)
    np.testing.assert_array_equal(ti, ri)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_chunk_reverse_coeffs_matches_reference(k):
    x = np.arange(8 * 2 * 4, dtype=np.float64).reshape(8, 2, 4)
    y = K.chunk_reverse_coeffs(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(y, np.asarray(JK.chunk_reverse_coeffs(x,
                                                                         k)))
    if k == 4:
        np.testing.assert_array_equal(y[0], x[3])
        np.testing.assert_array_equal(y[4], x[7])


def test_chunk_size_must_divide_partitions():
    _, st = _specs(64)
    ring2 = torch.zeros((2 * P, 2 * C, 128))
    coeff = torch.zeros((P, 2 * C, 128))
    with pytest.raises(ValueError, match="must divide partition count 4"):
        K.mac_chunked(ring2, coeff, 0, 65, k=3)
    with pytest.raises(ValueError, match="must divide"):
        K.mac_chunked(ring2.to("meta"), coeff.to("meta"), 0, 65, k=3)
    with pytest.raises(ValueError, match="must divide"):
        K.chunk_reverse_coeffs(coeff, 3)
    st0 = K.init_doubled_state(st, C, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        K.step_chunked(st0, coeff, torch.zeros((C, 64)), k=3)
    with pytest.raises(ValueError, match="must divide"):
        JK.mac_pallas_chunked(jnp.zeros((2 * P, 2 * C, 128)),
                              jnp.zeros((P, 2 * C, 128)), jnp.int32(0), k=3,
                              interpret=True)


def test_split_stream_resumes_across_packages():
    """A split-plane stream started in bfir_tpu continues in the port from
    the converted state and matches the uninterrupted reference stream;
    the port's state converts back with the reference's leaves."""
    sj, st = _specs(64)
    h, x = _inputs(5, 64, 10)
    cj = JK.split_coeffs(h, sj)
    js = JK.init_split_state(sj, C)
    ref = []
    for i, blk in enumerate(_blocks(x, 64)):
        js, y = JK.step_split(js, *cj, jnp.asarray(blk), interpret=True)
        ref.append(np.asarray(y))
        if i == 5:
            handed = jax.tree_util.tree_map(np.asarray, js)
    ts = convert.split_state_from_numpy(handed, "cpu")
    ct = [convert.tensor_from_numpy(np.asarray(a), "cpu") for a in cj]
    for i in range(6, 10):
        ts, y = K.step_split(ts, *ct, torch.from_numpy(x[:, 64 * i:64 * i + 64]))
        _close(y, ref[i], 1e-10)
    back = convert.split_state_to_numpy(ts)
    assert ([np.shape(a) for a in jax.tree_util.tree_leaves(back)]
            == [np.shape(a) for a in jax.tree_util.tree_leaves(js)])
    _close(back.ring_re, js.ring_re, 1e-12)
    _close(back.ring_im, js.ring_im, 1e-12)
    assert int(back.blockcounter) == int(js.blockcounter) == 10


def test_doubled_stream_resumes_across_packages():
    sj, st = _specs(64)
    h, x = _inputs(6, 64, 10)
    crj = JK.chunk_reverse_coeffs(JK.pack_coeffs(h, sj, C), 2)
    js = JK.init_doubled_state(sj, C)
    ref = []
    for i, blk in enumerate(_blocks(x, 64)):
        js, y = JK.step_chunked(js, crj, jnp.asarray(blk), k=2,
                                interpret=True)
        ref.append(np.asarray(y))
        if i == 4:
            handed = jax.tree_util.tree_map(np.asarray, js)
    ts = convert.doubled_state_from_numpy(handed, "cpu")
    crt = convert.tensor_from_numpy(np.asarray(crj), "cpu")
    for i in range(5, 10):
        ts, y = K.step_chunked(ts, crt,
                               torch.from_numpy(x[:, 64 * i:64 * i + 64]), k=2)
        _close(y, ref[i], 1e-10)
    back = convert.doubled_state_to_numpy(ts)
    assert ([np.shape(a) for a in jax.tree_util.tree_leaves(back)]
            == [np.shape(a) for a in jax.tree_util.tree_leaves(js)])
    _close(back.ring2, js.ring2, 1e-12)
    assert int(back.blockcounter) == int(js.blockcounter) == 10


def test_hc_stream_resumes_in_the_fused_and_insert_steps():
    """An hc stream from the reference's step_hc continues through the
    port's step_hc2 and step_hc_fused: the three share HcState."""
    sj, st = _specs(64)
    h, x = _inputs(7, 64, 10)
    cj = JK.hc_coeffs(h, sj, C)
    js = JK.init_hc_state(sj, C)
    ref = []
    for i, blk in enumerate(_blocks(x, 64)):
        js, y = JK.step_hc(js, cj, jnp.asarray(blk), use_pallas=False)
        ref.append(np.asarray(y))
        if i == 5:
            handed = jax.tree_util.tree_map(np.asarray, js)
    ct = convert.tensor_from_numpy(np.asarray(cj), "cpu")
    ts = convert.hc_state_from_numpy(handed, "cpu")
    for i in range(6, 10):
        step = K.step_hc2 if i % 2 else K.step_hc_fused
        ts, y = step(ts, ct, torch.from_numpy(x[:, 64 * i:64 * i + 64]))
        _close(y, ref[i], 1e-10)
    _close(ts.ring, js.ring, 1e-12)
