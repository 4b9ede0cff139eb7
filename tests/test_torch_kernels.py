"""bfir_tpu_torch kernels K1-K7 and K10-K13: each wrapper on CPU tensors (its plain
PyTorch version) against the bfir_tpu Pallas kernel in interpret mode, on
the same numpy inputs.

Tolerance: 1e-5 x max|reference| — the two sides sum partitions and
butterflies in different orders in float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bfir_tpu.core import nubatch as JNB
from bfir_tpu.kernels import corr_mac as JCM
from bfir_tpu.kernels import fft_fused as JFF
from bfir_tpu.kernels import spectrum_mac as JK
from bfir_tpu_torch.kernels import corr_mac as CM
from bfir_tpu_torch.kernels import fft_fused as FF
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


P, C, HP, TILE = 3, 2, 256, 128


def _close(got, ref, rel=1e-5):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _planes(seed, cs):
    rng = np.random.default_rng(seed)
    ring = rng.standard_normal((P, 2 * C, HP)).astype(np.float32)
    coeff = rng.standard_normal((P, 2 * cs, HP)).astype(np.float32)
    return ring, coeff


@pytest.mark.parametrize("cs", [C, 1], ids=["per_channel", "shared"])
@pytest.mark.parametrize("pos", [0, 2])
def test_mac_hc_matches_pallas(cs, pos):
    ring, coeff = _planes(1, cs)
    jr, ji = JK.mac_pallas_hc(jnp.asarray(ring), jnp.asarray(coeff),
                              jnp.int32(pos), interpret=True)
    tr, ti = K.mac_hc(torch.from_numpy(ring), torch.from_numpy(coeff), pos)
    _close(tr, jr)
    _close(ti, ji)
    assert K.mac_hc.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("cs", [C, 1], ids=["per_channel", "shared"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mac_hc_tiled_matches_pallas(cs, dtype):
    ring, coeff = _planes(2, cs)
    jdt = jnp.dtype(dtype)
    jring, jcoeff = jnp.asarray(ring, jdt), jnp.asarray(coeff, jdt)
    jr, ji = JK.mac_pallas_hc_tiled(jring, jcoeff, jnp.int32(1), tile=TILE,
                                    interpret=True)
    tdt = getattr(torch, dtype)
    tr, ti = K.mac_hc_tiled(torch.from_numpy(ring).to(tdt),
                            torch.from_numpy(coeff).to(tdt), 1, tile=TILE)
    assert tr.dtype == torch.float32
    _close(tr, jr)
    _close(ti, ji)
    with pytest.raises(ValueError, match="must divide"):
        K.mac_hc_tiled(torch.from_numpy(ring), torch.from_numpy(coeff), 1,
                       tile=96)


@pytest.mark.parametrize("cs", [C, 1], ids=["per_channel", "shared"])
@pytest.mark.parametrize("bits", [(24, 24), (16, 16), (24, 16)],
                         ids=["int24", "int16", "int24_ring_int16_coeff"])
def test_mac_hc_tiled_int_matches_pallas(cs, bits):
    ring, coeff = _planes(3, cs)
    jr_q = JK.quantize_planes(jnp.asarray(ring), bits[0])
    jc_q = JK.quantize_planes(jnp.asarray(coeff), bits[1])
    jr, ji = JK.mac_pallas_hc_tiled_int(jr_q, jc_q, jnp.int32(2), tile=TILE,
                                        interpret=True)
    tr_q = K.quantize_planes(torch.from_numpy(ring), bits[0])
    tc_q = K.quantize_planes(torch.from_numpy(coeff), bits[1])
    tr, ti = K.mac_hc_tiled_int(tr_q, tc_q, 2, tile=TILE)
    _close(tr, jr)
    _close(ti, ji)


@pytest.mark.parametrize("cs", [C, 1], ids=["per_channel", "shared"])
@pytest.mark.parametrize("band", [0, 1], ids=["band0", "band1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mac_hc_band_matches_pallas(cs, band, dtype):
    """K5 over one 128-lane band; the lane-0 law only in band 0."""
    ring, coeff = _planes(6, cs)
    jdt = jnp.dtype(dtype)
    jr, ji = JK.mac_pallas_hc_band(jnp.asarray(ring, jdt),
                                   jnp.asarray(coeff, jdt), jnp.int32(2),
                                   band * TILE, TILE, interpret=True)
    tdt = getattr(torch, dtype)
    tr, ti = K.mac_hc_band(torch.from_numpy(ring).to(tdt),
                           torch.from_numpy(coeff).to(tdt), 2, band * TILE,
                           TILE)
    assert tr.shape == (C, TILE) and tr.dtype == torch.float32
    _close(tr, jr)
    _close(ti, ji)
    jfr, jfi = JK.mac_reference_hc_band(jnp.asarray(ring, jdt),
                                        jnp.asarray(coeff, jdt), jnp.int32(2),
                                        band * TILE, TILE)
    _close(tr, jfr)
    _close(ti, jfi)
    assert K.mac_hc_band.launches == 0
    with pytest.raises(ValueError, match="128-lane aligned"):
        K.mac_hc_band(torch.from_numpy(ring), torch.from_numpy(coeff), 2, 64,
                      TILE)
    with pytest.raises(ValueError, match="outside"):
        K.mac_hc_band(torch.from_numpy(ring), torch.from_numpy(coeff), 2,
                      HP, TILE)


@pytest.mark.parametrize("cs", [C, 1], ids=["per_channel", "shared"])
@pytest.mark.parametrize("band", [0, 1], ids=["band0", "band1"])
@pytest.mark.parametrize("bits", [24, 16], ids=["int24", "int16"])
def test_mac_hc_band_int_matches_pallas(cs, band, bits):
    """K6: K5 on block-scaled integer planes."""
    ring, coeff = _planes(7, cs)
    jr_q = JK.quantize_planes(jnp.asarray(ring), bits)
    jc_q = JK.quantize_planes(jnp.asarray(coeff), bits)
    jr, ji = JK.mac_pallas_hc_band_int(jr_q, jc_q, jnp.int32(1), band * TILE,
                                       TILE, interpret=True)
    tr, ti = K.mac_hc_band_int(K.quantize_planes(torch.from_numpy(ring), bits),
                               K.quantize_planes(torch.from_numpy(coeff),
                                                 bits), 1, band * TILE, TILE)
    _close(tr, jr)
    _close(ti, ji)
    assert K.mac_hc_band_int.launches == 0


# K7 shapes: at C = 64 and B = 64 the reference kernel's VMEM model cuts
# the batch into chunks of 16 blocks, so its chunk loop runs too
@pytest.mark.parametrize("cs", [64, 1], ids=["per_channel", "shared"])
def test_corr_mac_matches_pallas_and_nubatch(cs):
    rng = np.random.default_rng(8)
    p, c, b, hp = 3, 64, 64, 128
    hist = rng.standard_normal((p - 1 + b, 2 * c, hp)).astype(np.float32)
    coeff = rng.standard_normal((p, 2 * cs, hp)).astype(np.float32)
    jr, ji = JCM.corr_mac_pallas(jnp.asarray(hist), jnp.asarray(coeff), b,
                                 interpret=True)
    tr, ti = CM.corr_mac(torch.from_numpy(hist), torch.from_numpy(coeff), b)
    assert tr.shape == (b, c, hp) and tr.dtype == torch.float32
    _close(tr, jr)
    _close(ti, ji)
    nr, ni = JNB._corr_mac(jnp.asarray(hist), jnp.asarray(coeff), b)
    _close(tr, nr)
    _close(ti, ni)
    assert CM.corr_mac.launches == 0
    with pytest.raises(ValueError, match="P-1\\+B"):
        CM.corr_mac(torch.from_numpy(hist), torch.from_numpy(coeff), b - 1)


def test_corr_mac_bf16_history_matches_nubatch():
    rng = np.random.default_rng(9)
    p, c, b, hp = 4, 2, 5, 256
    hist = rng.standard_normal((p - 1 + b, 2 * c, hp)).astype(np.float32)
    coeff = rng.standard_normal((p, 2 * c, hp)).astype(np.float32)
    jh = jnp.asarray(hist, jnp.bfloat16)
    nr, ni = JNB._corr_mac(jh, jnp.asarray(coeff), b)
    tr, ti = CM.corr_mac(torch.from_numpy(hist).to(torch.bfloat16),
                         torch.from_numpy(coeff), b)
    _close(tr, nr)
    _close(ti, ni)


def test_corr_mac_plan():
    """The CUDA launch's plan at the flagship's head and tail calls (every
    byte read once, the grid occupancy x SMs capped at the items), B split
    while the items leave SMs idle, and the entry point's refusals."""
    for p, b, hp in ((16, 64, 1024), (14, 8, 8192)):
        plan = CM.corr_mac_plan(p, b, 64, 64, hp, 4, 4, 3, 132)
        assert plan.variant == CM._variant(hp) and plan.nsplit == 1
        assert plan.items == 64 * -(-hp // plan.tile)
        assert plan.grid == min(plan.items, 3 * 132)
        assert plan.streamed == plan.inputs == 2 * hp * 4 * (
            (p - 1 + b) * 64 + p * 64)
    shared = CM.corr_mac_plan(16, 64, 64, 1, 1024, 4, 2, 3, 132)
    assert shared.streamed - shared.inputs == 63 * 16 * 2 * 1024 * 2
    few = CM.corr_mac_plan(16, 64, 2, 2, 256, 4, 4, 3, 132)
    assert few.b_chunk == 16 and few.nsplit == 4  # 4 items x 4 ranges
    assert few.streamed - few.inputs == 2 * 2 * 256 * 4 * 3 * (15 + 16)
    for hp, size in ((6, 4), (12, 2), (2, 4)):
        with pytest.raises(ValueError, match="16-byte"):
            CM.corr_mac_plan(3, 4, 2, 2, hp, size, 4, 3, 132)
    with pytest.raises(ValueError, match="fits no block"):
        CM.corr_mac_plan(3, 4, 2, 2, 128, 4, 4, 0, 132)


@pytest.mark.parametrize("bits", [24, 16])
def test_quantize_planes_matches_reference(bits):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 4, 256))
         * rng.uniform(1e-3, 1e3, (3, 4, 1))).astype(np.float32)
    jq = JK.quantize_planes(jnp.asarray(x), bits)
    tq = K.quantize_planes(torch.from_numpy(x), bits)
    # scales: the same f32 arithmetic, so equal to f32 rounding
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=2e-7, atol=0)
    assert tq.scale.shape == (3, 4, 128)
    assert tq.hi.dtype == torch.int16
    assert (tq.lo is None) == (bits == 16)
    if bits == 24:
        assert tq.lo.dtype == torch.uint8
    # decoded planes within 1 LSB of the reference's q
    lsb = np.asarray(jq.scale)[..., :1]
    dq = K.dequantize_planes(tq).numpy()
    assert np.all(np.abs(dq - np.asarray(JK.dequantize_planes(jq)))
                  <= 1.001 * lsb)
    assert np.all(np.abs(dq - x) <= 0.501 * lsb + 1e-6 * np.abs(x))


def test_irfft_tail_balanced_matches_pallas():
    rng = np.random.default_rng(5)
    h = 1024
    x = rng.standard_normal((4, 2 * h))
    spec = np.fft.rfft(x)
    hr = spec.real[:, :h].astype(np.float32)
    hi = np.concatenate([spec.real[:, h:h + 1], spec.imag[:, 1:h]],
                        axis=1).astype(np.float32)
    jy = JFF.irfft_split_hc_tail_balanced(jnp.asarray(hr), jnp.asarray(hi),
                                          n=2 * h, interpret=True)
    ty = FF.irfft_split_hc_tail_balanced(torch.from_numpy(hr),
                                         torch.from_numpy(hi), 2 * h)
    _close(ty, jy)
    _close(ty, x[:, h:], rel=2e-6)
    # lane-padded planes read only the first h lanes
    pad = np.full((4, 128), 7.0, np.float32)
    tp = FF.irfft_split_hc_tail_balanced(
        torch.from_numpy(np.concatenate([hr, pad], 1)),
        torch.from_numpy(np.concatenate([hi, pad], 1)), 2 * h)
    np.testing.assert_array_equal(tp.numpy(), ty.numpy())
    assert FF.irfft_split_hc_tail_balanced.launches == 0


# K10-K13 shapes: P = 8 partitions, C = 4 channels
P8, C4 = 8, 4


def _planes8(seed, lanes):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((P8, 2 * C4, lanes)).astype(np.float32),
            rng.standard_normal((P8, 2 * C4, lanes)).astype(np.float32),
            rng.standard_normal((2 * C4, lanes)).astype(np.float32))


@pytest.mark.parametrize("lanes", [128, 256])
@pytest.mark.parametrize("pos", [0, 3, 7])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_mac_chunked_matches_pallas(k, pos, lanes):
    """K10 over a doubled ring (slot s mirrored at s + P) and
    chunk-reversed coefficients; the same sum as K8 on the single ring."""
    ring, coeff, _ = _planes8(20, lanes)
    ring2 = np.concatenate([ring, ring])
    crj = JK.chunk_reverse_coeffs(jnp.asarray(coeff), k)
    jr, ji = JK.mac_pallas_chunked(jnp.asarray(ring2), crj, jnp.int32(pos),
                                   k=k, interpret=True)
    crt = K.chunk_reverse_coeffs(torch.from_numpy(coeff), k)
    np.testing.assert_array_equal(crt.numpy(), np.asarray(crj))
    tr, ti = K.mac_chunked(torch.from_numpy(ring2), crt, pos, lanes, k)
    assert tuple(tr.shape) == (C4, lanes)
    _close(tr, jr)
    _close(ti, ji)
    pr, pi = K.mac_packed_plain(torch.from_numpy(ring),
                                torch.from_numpy(coeff), pos, lanes)
    _close(tr, pr)
    _close(ti, pi)
    assert K.mac_chunked.launches == 0


@pytest.mark.parametrize("lanes", [128, 256])
@pytest.mark.parametrize("pos", [0, 3, 7])
def test_mac_split_matches_pallas(pos, lanes):
    """K11 over four planes [P, C, Fp]; the live-lane count rounds up to
    4 as K8's does."""
    rng = np.random.default_rng(21)
    planes = [rng.standard_normal((P8, C4, lanes)).astype(np.float32)
              for _ in range(4)]
    jr, ji = JK.mac_pallas(*map(jnp.asarray, planes), jnp.int32(pos),
                           interpret=True)
    tp = [torch.from_numpy(a) for a in planes]
    tr, ti = K.mac_split(*tp, pos, lanes)
    _close(tr, jr)
    _close(ti, ji)
    lr, li = K.mac_split(*tp, pos, lanes // 2 + 1)
    assert tuple(lr.shape) == (C4, lanes // 2 + 4)
    _close(lr, np.asarray(jr)[:, :lanes // 2 + 4])
    assert K.mac_split.launches == 0


@pytest.mark.parametrize("lanes", [128, 256])
@pytest.mark.parametrize("pos", [0, 3, 7])
def test_mac_hc_insert_matches_pallas(pos, lanes):
    """K13: partition 0 is the new spectrum, which lands in slot pos of
    the ring (in place); the other slots stay as they were."""
    ring, coeff, xpk = _planes8(22, lanes)
    jr, ji, jring = JK.mac_pallas_hc_insert(
        jnp.asarray(ring.copy()), jnp.asarray(coeff), jnp.asarray(xpk),
        jnp.int32(pos), interpret=True)
    tring = torch.from_numpy(ring.copy())
    tr, ti, tring2 = K.mac_hc_insert(tring, torch.from_numpy(coeff),
                                     torch.from_numpy(xpk), pos)
    assert tring2 is tring
    _close(tr, jr)
    _close(ti, ji)
    want = ring.copy()
    want[pos] = xpk
    np.testing.assert_array_equal(tring.numpy(), np.asarray(jring))
    np.testing.assert_array_equal(tring.numpy(), want)
    assert K.mac_hc_insert.launches == 0
    with pytest.raises(ValueError, match="per channel"):
        K.mac_hc_insert(tring, torch.from_numpy(coeff[:, :2]),
                        torch.from_numpy(xpk), pos)


@pytest.mark.parametrize("lanes", [128, 256])
@pytest.mark.parametrize("pos", [0, 3, 7])
def test_mac_tail_hc_matches_pallas(pos, lanes):
    """K12: the hc MAC and the tail product against the half-DFT basis;
    at 128 lanes for blocks of 64 (the basis zero-padded, Hp > h), at 256
    for blocks of 256 (Hp = h)."""
    n = 64 if lanes == 128 else 256
    ring, coeff, _ = _planes8(23, lanes)
    jwr, jwi = JK._tail_basis(n, lanes, "float32")
    jo = JK.mac_tail_pallas_hc(jnp.asarray(ring), jnp.asarray(coeff), jwr,
                               jwi, jnp.int32(pos), interpret=True)
    wr, wi = K._tail_basis(n, lanes, torch.float32, torch.device("cpu"))
    to = K.mac_tail_hc(torch.from_numpy(ring), torch.from_numpy(coeff), wr,
                       wi, pos)
    assert tuple(to.shape) == (C4, lanes) and to.dtype == torch.float32
    _close(to, jo)
    if lanes > n:
        assert not to[:, n:].any()  # zero basis columns beyond h
    assert K.mac_tail_hc.launches == 0


def test_new_mac_wrappers_refuse_float64_on_cuda(monkeypatch):
    """K10-K13 compute in float32: a float64 tensor headed for a kernel
    raises NotImplementedError naming engine_mode="extended" (the device
    check is stubbed out here: this machine has no CUDA)."""
    from bfir_tpu_torch.kernels import cuda_lib

    monkeypatch.setattr(cuda_lib, "require_cuda", lambda *a: None)
    z = torch.zeros((P8, 2 * C4, 128), dtype=torch.float64, device="meta")
    calls = [
        lambda: K.mac_chunked(torch.zeros((2 * P8, 2 * C4, 128),
                                          dtype=torch.float64,
                                          device="meta"), z, 0, 65),
        lambda: K.mac_split(z[:, :C4], z[:, :C4], z[:, :C4], z[:, :C4], 0,
                            65),
        lambda: K.mac_hc_insert(z, z, z[0], 0),
        lambda: K.mac_tail_hc(z, z, z[0, :1].expand(128, 128), z[0], 0),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match='engine_mode="extended"'):
            call()


def test_kernel_wrappers_refuse_other_devices():
    """A tensor off the CPU never takes the plain version: the wrappers
    check it for the kernel and raise (here on the meta device)."""
    ring = torch.zeros((P, 2 * C, HP), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.mac_hc(ring, ring, 0)
    with pytest.raises(ValueError, match="CUDA"):
        FF.irfft_split_hc_tail_balanced(ring[0], ring[0], 2 * HP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.mac_hc_band(ring, ring, 0, 0, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        CM.corr_mac(torch.zeros((P + 1, 2 * C, HP), device="meta"), ring, 2)
    for call in (lambda: K.mac_chunked(torch.zeros((2 * P, 2 * C, HP),
                                                   device="meta"), ring, 0,
                                       HP, k=1),
                 lambda: K.mac_split(ring, ring, ring, ring, 0, HP),
                 lambda: K.mac_hc_insert(ring, ring, ring[0], 0),
                 lambda: K.mac_tail_hc(ring, ring, ring[0], ring[0], 0)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
