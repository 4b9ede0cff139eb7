"""The designs of K12 (``bfir_tpu_torch/csrc/mac_tail_hc.cu``), K9
(``bfir_tpu_torch/csrc/dither_q.cu``), K7
(``bfir_tpu_torch/csrc/corr_mac.cu``) and the ring MAC of K1-K3, K5, K6
and K8 (``bfir_tpu_torch/csrc/mac_hc.cu``) modelled on the CPU, where no
CUDA compiler runs.

K12: a numpy model of the kernel's decomposition with its constants parsed
from the CUDA source and its plan from the wrapper (``mac_tail_plan``):
phase 1 deals warp items of 32 (channel, four-lane) pairs round-robin over
the blocks of the grid and scatters each thread's MAC (partitions summed
in order, whatever the kernel's unroll) into the k-major
accumulator scratch [2Hp, Cs]; phase 2 walks the (channel tile, sample
tile, k split) items, stages 16-row k-slices with the kernel's zero fill,
and sums k in the kernel's order; phase 3 adds the partials in split
order. The scratch starts as NaN, so a read of anything the kernel does
not write (the accumulator's padding columns) would show in the output.
Every item must be taken exactly once. The model runs in float64 against
the port's plain version in float64 (1e-12 x max: the same sums in
another order), and in float32 against the reference's Pallas kernel in
interpret mode (1e-5 x max: float32 sums in another order).

K9: a torch model of the kernel's loop (register windows, the branch-free
body: the rounding as trunc(d) - (d < 0), the clip as a max and a min in
float32 and a select in float64, the statistics as selects, |q| from the
int q)
that must equal the plain version bit for bit in all six outputs, in
float32 and float64, on crafted samples (negative integer-valued d, -0.0,
d = imin, d = imax, d just above imax, d in (imin, imin + 1), runs that
clip and un-clip) and on random clipping input.

K7: a numpy model of the kernel's decomposition with its register window
and launch variants parsed from the CUDA source and its plan from the
wrapper (``corr_mac_plan``): items dealt round-robin over the persistent
grid, each block's row tiles pushed by its producer in the kernel's order
into an S-stage ring (at most S ahead of the consumers, a stage refilled
only after it was read), the register window indexed as the kernel
indexes it, a thread's first lane summing the four real products apart
and combining them by the lane-0 law once an output (its other lanes
accumulating the complex product), and further tap
chunks (P > window) added into the outputs. Tiles are NaN beyond the
live lanes and the outputs start as NaN, so a dead lane stored or an
output never written would show. Every output has one owner (block,
thread) and is written once per tap chunk. The model runs in float64
against the port's plain version in float64 (1e-12 x max: the same sums
in another order) and in float32 against the reference's Pallas kernel
in interpret mode (1e-5 x max).

K1-K3, K5, K6, K8: a numpy model of the ring MAC's decomposition with
its constants parsed from the CUDA source and its plan from the wrapper
(``mac_hc_plan``): blocks of width x S threads on a (quad blocks,
channels) grid, thread (x, s) summing the contiguous partition slice
[s P / S, (s + 1) P / S) of its quad in partition order, slice 0 adding
the other slices' sums in slice order and writing each output once.
Outputs start as NaN; every (channel, quad, partition) must be taken
exactly once. The plan is checked over a grid of shapes and SM counts
(coverage, S <= P, the card's block limits, S = 1 at the flagship's K1,
K2 and K3 shapes). The model runs in float64 against the port's plain
versions in float64 (1e-12 x max) and in float32 against the reference's
Pallas kernels in interpret mode (1e-5 x max), at session M's partition
counts and lane widths with two or three channels."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bfir_tpu.kernels import corr_mac as JCM
from bfir_tpu.kernels import spectrum_mac as JK
from bfir_tpu_torch.kernels import corr_mac as CM
from bfir_tpu_torch.kernels import dither_kernel as DK
from bfir_tpu_torch.kernels import spectrum_mac as K

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc")


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_graphs():
    """Drop this module's compiled JAX graphs when it ends (see
    tests/test_torch_kernels.py)."""
    yield
    jax.clear_caches()


def _constants(name):
    """``constexpr int`` values of a CUDA source, by name."""
    with open(os.path.join(CSRC, name)) as f:
        text = f.read()
    return {k: v for k, v in re.findall(
        r"constexpr int (\w+) = ([^;]+);", text)}


def _k12():
    k = _constants("mac_tail_hc.cu")
    threads = int(k["kThreads"])
    return (threads, threads // 32, int(k["kTile"]), int(k["kSlice"]),
            int(k["kUnroll"]))


THREADS, WARPS, TILE, SLICE, UNROLL = _k12()
K12_P = 7  # one group of UNROLL partitions' loads and a remainder


def test_k12_constants_match_the_wrapper():
    assert (TILE, SLICE) == (K._TAIL_TILE, K._TAIL_SLICE)
    assert K12_P > UNROLL and K12_P % UNROLL
    assert SLICE * TILE == 4 * THREADS  # one float4 a thread a slice


@pytest.mark.parametrize("c", [1, 5, 64, 65, 128])
@pytest.mark.parametrize("hp", [4, 124, 128, 1024, 2048])
@pytest.mark.parametrize("grid", [1, 7, 264, 396])
def test_k12_plan_meets_the_entry_point_checks(c, hp, grid):
    """The plan's splits cover the k range 2 Hp with whole slices and no
    empty split (the checks of ``bfir_mac_tail_hc``), and make no more
    items than the grid unless one split already does."""
    splits, ks, floats = K.mac_tail_plan(c, hp, grid)
    tiles = -(-c // TILE) * -(-hp // TILE)
    assert splits >= 1 and ks >= SLICE and ks % SLICE == 0
    assert splits * ks >= 2 * hp > (splits - 1) * ks
    assert splits == 1 or tiles * splits <= grid
    cs = -(-c // TILE) * TILE
    assert floats == 2 * hp * cs + (splits * c * hp if splits > 1 else 0)


def k12_model(ring, coeff, wr, wi, pos, grid):
    """csrc/mac_tail_hc.cu's three phases on numpy arrays (float64 or
    float32 throughout) for a grid of ``grid`` blocks -> out [C, Hp]."""
    p, c2, hp = ring.shape
    c = c2 // 2
    dt = ring.dtype
    splits, ks, floats = K.mac_tail_plan(c, hp, grid)
    cs = -(-c // TILE) * TILE
    scratch = np.full(floats, np.nan, dtype=dt)
    acc = scratch[:2 * hp * cs].reshape(2 * hp, cs)
    part = scratch[2 * hp * cs:].reshape(splits, c, hp) if splits > 1 else None
    out = np.full((c, hp), np.nan, dtype=dt)

    # phase 1: warp item j -> items 32 j .. 32 j + 31, block-round-robin
    groups = hp // 4
    items = c * groups
    witems = -(-items // 32)
    seen = np.zeros(items, dtype=int)
    for b in range(grid):
        for w in range(WARPS):
            for j in range(b + grid * w, witems, grid * WARPS):
                i = j * 32 + np.arange(32)
                i = i[i < items]
                seen[i] += 1
                ch = (i // groups)[:, None]
                lanes = ((i % groups) * 4)[:, None] + np.arange(4)
                ar = np.zeros(lanes.shape, dtype=dt)
                ai = np.zeros(lanes.shape, dtype=dt)
                for q in range(p):
                    slot = (pos - q) % p
                    rr, ri = ring[slot, ch, lanes], ring[slot, c + ch, lanes]
                    cr, ci = coeff[q, ch, lanes], coeff[q, c + ch, lanes]
                    lane0 = lanes == 0  # (DC.re, Nyquist.re): two products
                    ar += np.where(lane0, cr * rr, cr * rr - ci * ri)
                    ai += np.where(lane0, ci * ri, cr * ri + ci * rr)
                acc[lanes, ch] = ar
                acc[hp + lanes, ch] = ai
    assert (seen == 1).all()

    # phase 2: item w = (tile w // splits, split w % splits)
    nct, ntt = -(-c // TILE), -(-hp // TILE)
    n_items = nct * ntt * splits
    taken = np.zeros(n_items, dtype=int)
    basis = np.concatenate([wr, wi])  # row k < Hp: wr[k], else wi[k - Hp]
    for b in range(grid):
        for w in range(b, n_items, grid):
            taken[w] += 1
            split, tile = w % splits, w // splits
            c0, t0 = (tile // ntt) * TILE, (tile % ntt) * TILE
            kb = split * ks
            ke = min(2 * hp, kb + ks)
            o = np.zeros((TILE, TILE), dtype=dt)
            cols = t0 + np.arange(TILE)
            live = cols < hp  # whole float4 groups, hp % 4 == 0
            for k0 in range(kb, ke, SLICE):
                rows = k0 + np.arange(SLICE)
                on = rows < ke
                sa = np.zeros((SLICE, TILE), dtype=dt)
                sb = np.zeros((SLICE, TILE), dtype=dt)
                sa[on] = acc[rows[on], c0:c0 + TILE]
                sb[np.ix_(on, live)] = basis[np.ix_(rows[on], cols[live])]
                for kk in range(SLICE):  # the kernel's k order
                    o += np.outer(sa[kk], sb[kk])
            ch = c0 + np.arange(TILE)
            keep = ch < c
            dst = out if splits == 1 else part[split]
            dst[np.ix_(ch[keep], cols[live])] = o[np.ix_(keep, live)]
    assert (taken == 1).all()

    # phase 3: the partials in split order
    if splits > 1:
        out = part[0].copy()
        for sp in range(1, splits):
            out = out + part[sp]
    return out


# (Hp, block length n): the zero-padded basis of blocks of 64 at Hp = 128,
# Hp = h at 256 and at 2048
K12_SHAPES = [(128, 64), (256, 256), (2048, 2048)]


def _k12_inputs(hp, c, p, seed):
    rng = np.random.default_rng(seed)
    ring = rng.standard_normal((p, 2 * c, hp))
    coeff = rng.standard_normal((p, 2 * c, hp))
    return ring, coeff


@pytest.mark.parametrize("hp,n", K12_SHAPES)
@pytest.mark.parametrize("grid", [7, 264])
def test_k12_model_matches_plain_float64(hp, n, grid):
    """C = 5 (the last channel tile and warp item ragged), P = 7 (the
    MAC's unroll does not divide it), pos = 1; float64 against the plain
    version in float64."""
    c, p, pos = 5, K12_P, 1
    ring, coeff = _k12_inputs(hp, c, p, 30 + hp)
    wr, wi = (t.numpy() for t in K._tail_basis(n, hp, torch.float64,
                                               torch.device("cpu")))
    got = k12_model(ring, coeff, wr, wi, pos, grid)
    ref = K.mac_tail_hc_plain(torch.from_numpy(ring), torch.from_numpy(coeff),
                              torch.from_numpy(wr), torch.from_numpy(wi),
                              pos).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    if hp > n:
        assert not got[:, n:].any()  # zero basis columns beyond h


@pytest.mark.parametrize("hp,n", K12_SHAPES)
def test_k12_model_and_port_match_pallas(hp, n):
    """float32: the model (grid 264) and the port's wrapper on CPU tensors
    against ``mac_tail_pallas_hc`` in interpret mode, C = 5, P = 7."""
    c, p, pos = 5, K12_P, 2
    ring, coeff = (t.astype(np.float32)
                   for t in _k12_inputs(hp, c, p, 40 + hp))
    jwr, jwi = JK._tail_basis(n, hp, "float32")
    jo = np.asarray(JK.mac_tail_pallas_hc(
        jnp.asarray(ring), jnp.asarray(coeff), jwr, jwi, jnp.int32(pos),
        interpret=True))
    wr, wi = K._tail_basis(n, hp, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(wr.numpy(), np.asarray(jwr))
    got = k12_model(ring, coeff, wr.numpy(), wi.numpy(), pos, 264)
    port = K.mac_tail_hc(torch.from_numpy(ring), torch.from_numpy(coeff), wr,
                         wi, pos).numpy()
    for out in (got, port):
        assert out.dtype == np.float32 and out.shape == (c, hp)
        np.testing.assert_allclose(out, jo, rtol=0,
                                   atol=1e-5 * np.abs(jo).max())


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

WINDOW_BYTES = int(_constants("dither_q.cu")["kWindowBytes"])


def k9_model(x, dv, e0, e1, imin, imax, nof, lg, ilg):
    """csrc/dither_q.cu's loop on CPU tensors: windows of
    ``WINDOW_BYTES`` of each row, the body branch-free -> the six outputs
    of ``quantize_hp_tpdf_plain``."""
    c, n = x.shape
    w = WINDOW_BYTES // x.element_size()
    lo, hi = x.new_tensor(imin), x.new_tensor(imax)
    q = torch.zeros((c, n), dtype=torch.int32)
    for t0 in range(0, n, w):
        xw, dw = x[:, t0:t0 + w], dv[:, t0:t0 + w]  # the register window
        for j in range(xw.shape[1]):
            xp = (xw[:, j] + e0) - e1
            d = xp + dw[:, j]
            r = torch.trunc(d) - torch.where(d < 0, 1.0, 0.0).to(d.dtype)
            clip_lo = d <= lo
            clipped = clip_lo | (d > hi)
            if x.dtype == torch.float32:  # max and min
                qv = torch.minimum(torch.maximum(r, lo), hi)
            else:  # a select on the clip flags
                qv = torch.where(clipped, torch.where(clip_lo, lo, hi), r)
            qi = qv.to(torch.int32)
            aq = qi.to(torch.int64).abs().clamp(max=2 ** 31 - 1).to(
                torch.int32)
            ad = d.abs()
            nof = nof + clipped.to(torch.int32)
            lg = torch.where(clipped & (ad > lg), ad, lg)
            ilg = torch.where(~clipped & (aq > ilg), aq, ilg)
            q[:, t0 + j] = qi
            e0, e1 = xp - qv, e0
    return q, e0, e1, nof, lg, ilg


def _bits(t):
    """Bit patterns (so that -0.0 and 0.0 differ)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _crafted(dtype, bits, n):
    """Rows whose first sample sets d exactly (e0 = e1 = 0, dv = 0, so d =
    x), a row with d = -0.0, then runs that clip and un-clip, each row
    continued by random clipping input with dither values."""
    npdt = np.dtype(dtype)
    imin, imax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    lo, hi = npdt.type(imin), npdt.type(imax)
    first = [-1.0, -2.0, -100.0, float(lo) + 1, lo, hi,
             np.nextafter(hi, npdt.type(np.inf)), hi + 0.5,
             np.nextafter(lo, npdt.type(np.inf)), lo + 0.25, lo + 0.75,
             np.nextafter(lo, npdt.type(-np.inf)), hi - 0.5, 0.5, -0.5,
             0.0, 2.0 * hi, 2.0 * lo]
    rows = len(first) + 3
    rng = np.random.default_rng(bits + n)
    x = rng.uniform(-1.2, 1.2, (rows, n)) * (imax + 1)
    dv = 0.5 + (np.diff(rng.integers(-128, 128, (rows, n + 1)), axis=1)
                + 1.0) / 255.0
    e0 = rng.uniform(-1.5, 1.5, rows)
    e1 = rng.uniform(-1.5, 1.5, rows)
    k = len(first)
    x[:k, 0] = first
    dv[:k, 0] = 0.0
    e0[:k] = 0.0
    e1[:k] = 0.0
    # d = -0.0: xp = (-0.0 + -0.0) - 0.0 = -0.0, d = -0.0 + -0.0
    x[k, 0], e0[k], e1[k], dv[k, 0] = -0.0, -0.0, 0.0, -0.0
    # runs that clip and un-clip, without dither
    x[k + 1] = np.resize([2.0 * hi, 2.0 * hi, 3.0, -3.0, 2.0 * lo, 2.0 * lo,
                          0.25, float(hi), float(lo), -7.0], n)
    dv[k + 1] = 0.0
    x[k + 2] = np.resize([1.5 * hi, 0.0, 1.5 * lo, 0.0], n)
    x, dv, e0, e1 = (torch.from_numpy(np.asarray(a, dtype=npdt))
                     for a in (x, dv, e0, e1))
    assert _bits(e0[k]).item() != 0  # -0.0 survived
    stats = (torch.zeros(rows, dtype=torch.int32),
             torch.zeros(rows, dtype=getattr(torch, dtype)),
             torch.zeros(rows, dtype=torch.int32))
    return x, dv, e0, e1, float(imin), float(imax), stats


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bits", [24, 16], ids=["int24", "int16"])
@pytest.mark.parametrize("n", [1, 37, 64])
def test_k9_model_matches_plain_bit_for_bit(dtype, bits, n):
    """n = 37: a full window and a ragged one in float64 (W = 16), one
    ragged window in float32 (W = 32); n = 64: whole windows."""
    x, dv, e0, e1, imin, imax, stats = _crafted(dtype, bits, n)
    got = k9_model(x, dv, e0, e1, imin, imax, *stats)
    ref = DK.quantize_hp_tpdf_plain(x, dv, e0, e1, imin, imax, *stats)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(_bits(g), _bits(r))
    assert DK.quantize_hp_tpdf.launches == 0
    if n > 1:
        assert int(ref[3].sum()) > 0 and int(ref[5].max()) > 0  # both sides


def test_k9_crafted_values_reach_their_cases():
    """The crafted first samples give the d they name: d = -0.0 keeps its
    sign into q (floor(-0.0) = -0.0, so e0 = -0.0 - -0.0 = +0.0), d = imin
    and d just above imax clip, d in (imin, imin + 1) does not."""
    x, dv, e0, e1, imin, imax, stats = _crafted("float32", 24, 1)
    q, e0n, _, nof, _, ilg = DK.quantize_hp_tpdf_plain(
        x, dv, e0, e1, imin, imax, *stats)
    lo_row, hi_row, above_row, inside_row = 4, 5, 6, 8
    assert nof[lo_row] == 1 and q[lo_row, 0] == int(imin)
    assert nof[hi_row] == 0 and q[hi_row, 0] == int(imax)
    assert nof[above_row] == 1 and q[above_row, 0] == int(imax)
    assert nof[inside_row] == 0 and q[inside_row, 0] == int(imin)
    assert q[0, 0] == -2 and q[1, 0] == -3  # negative integers: ceil - 1
    assert q[18, 0] == 0 and _bits(e0n[18]).item() == 0 and ilg[18] == 0


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def _k7():
    with open(os.path.join(CSRC, "corr_mac.cu")) as f:
        text = f.read()
    table = re.search(r"kVariants\[\] = \{(.*?)\};", text, re.S).group(1)
    variants = tuple(tuple(int(x) for x in t.split(","))
                     for t in re.findall(r"\{([^{}]*)\}", table))
    return int(_constants("corr_mac.cu")["kQW"]), variants


QW, VARIANTS = _k7()


def test_k7_constants_match_the_wrapper():
    assert QW == CM._QW and VARIANTS == CM._VARIANTS
    for threads, lanes, stages in VARIANTS:
        assert threads % 32 == 0 and lanes in (1, 2) and stages >= 2
        assert threads * lanes * 4 % 16 == 0  # whole chunks a segment


def _k7_tiles(hist, coeff, b, plan, items):
    """The producer of one block: each row tile (re, im) of its items in
    the kernel's order, over ``plan.tile`` lanes, NaN past the live
    lanes."""
    _, c2, hp = hist.shape
    p = coeff.shape[0]
    c, cs = c2 // 2, coeff.shape[1] // 2
    t = plan.tile

    def tile(plane, row, half, t0):
        seg = np.full((2, t), np.nan, dtype=plane.dtype)
        n = min(t, hp - t0)
        seg[0, :n] = plane[row, half, t0:t0 + n]
        seg[1, :n] = plane[row, half + plane.shape[1] // 2, t0:t0 + n]
        return seg

    for w in items:
        ch, t0, b0, b1 = _k7_item(w, plan, c, hp, b)
        cc = 0 if cs == 1 else ch
        for q0 in range(0, p, QW):
            for k in range(min(QW, p - q0)):
                yield tile(coeff, q0 + k, cc, t0)
            base = p - 1 - q0
            for r in range(max(0, base + b0 - QW + 1), base + b1):
                yield tile(hist, r, ch, t0)


def _k7_item(w, plan, c, hp, b):
    """Item w -> (channel, first lane, b0, b1): b split fastest, then
    channel, then lane tile."""
    rest = w // plan.nsplit
    b0 = w % plan.nsplit * plan.b_chunk
    return rest % c, rest // c * plan.tile, b0, min(b, b0 + plan.b_chunk)


def k7_model(hist, coeff, b, plan):
    """csrc/corr_mac.cu on numpy arrays (float64 or float32 throughout)
    under ``plan`` -> (yr, yi) [B, C, Hp]."""
    _, c2, hp = hist.shape
    p = coeff.shape[0]
    c = c2 // 2
    dt = hist.dtype
    threads, lanes, stages = VARIANTS[plan.variant]
    t = plan.tile
    assert t == threads * lanes
    yr = np.full((b, c, hp), np.nan, dtype=dt)
    yi = np.full((b, c, hp), np.nan, dtype=dt)
    owner = np.full((b, c, hp), -1)
    writes = np.zeros((b, c, hp), dtype=int)
    taken = np.zeros(plan.items, dtype=int)
    thread = np.arange(t) // lanes
    for g in range(plan.grid):
        items = range(g, plan.items, plan.grid)
        producer = _k7_tiles(hist, coeff, b, plan, items)
        ring = [None] * stages  # (tile number, tile)
        state = {"pushed": 0, "read": 0}

        def pop():
            while state["pushed"] < state["read"] + stages:
                tile = next(producer, None)
                if tile is None:
                    break
                slot = state["pushed"] % stages
                assert ring[slot] is None or ring[slot][0] < state["read"]
                ring[slot] = (state["pushed"], tile)
                state["pushed"] += 1
            j, tile = ring[state["read"] % stages]
            assert j == state["read"]
            state["read"] += 1
            return tile

        for w in items:
            taken[w] += 1
            ch, t0, b0, b1 = _k7_item(w, plan, c, hp, b)
            lane = t0 + np.arange(t)
            live = thread * lanes < min(t, hp - t0)
            lane0 = lane == 0
            first = np.arange(t) % lanes == 0  # a thread's first lane
            for q0 in range(0, p, QW):
                qn = min(QW, p - q0)
                cr = np.zeros((QW, t), dtype=dt)
                ci = np.zeros((QW, t), dtype=dt)
                for k in range(qn):
                    cr[k], ci[k] = pop()
                base = p - 1 - q0
                wr = np.zeros((QW, t), dtype=dt)
                wi = np.zeros((QW, t), dtype=dt)
                for s in range(1, QW):
                    if base + b0 - QW + s >= 0:
                        wr[s], wi[s] = pop()
                for bb in range(b0, b1, QW):
                    for u in range(min(QW, b1 - bb)):
                        wr[u], wi[u] = pop()
                        sums = np.zeros((4, t), dtype=dt)
                        cx = np.zeros((2, t), dtype=dt)
                        for k in range(QW):
                            s = (u - k) % QW
                            sums += (cr[k] * wr[s], ci[k] * wi[s],
                                     cr[k] * wi[s], ci[k] * wr[s])
                            cx[0] = cx[0] + cr[k] * wr[s] - ci[k] * wi[s]
                            cx[1] = cx[1] + cr[k] * wi[s] + ci[k] * wr[s]
                        ar = np.where(first, sums[0] - sums[1], cx[0])
                        ai = np.where(first, sums[2] + sums[3], cx[1])
                        ar = np.where(lane0, sums[0], ar)
                        ai = np.where(lane0, sums[1], ai)
                        bi, li = bb + u, lane[live]
                        who = g * threads + thread[live]
                        was = owner[bi, ch, li]
                        assert ((was == -1) | (was == who)).all()
                        owner[bi, ch, li] = who
                        writes[bi, ch, li] += 1
                        if q0:
                            yr[bi, ch, li] = yr[bi, ch, li] + ar[live]
                            yi[bi, ch, li] = yi[bi, ch, li] + ai[live]
                        else:
                            yr[bi, ch, li] = ar[live]
                            yi[bi, ch, li] = ai[live]
        assert next(producer, None) is None  # the producer ran dry
        assert state["read"] == state["pushed"]
    assert (taken == 1).all()
    assert (writes == -(-p // QW)).all()
    return yr, yi


# (P, B, C, Cs, Hp): P > window with B < window and a ragged last lane
# tile; the flagship head's P and B with a shared filter; the tail's P and
# B, ragged; B = 1; three blocks of outputs past a window
K7_SHAPES = [(40, 5, 3, 3, 200), (16, 64, 2, 1, 256), (14, 8, 3, 1, 136),
             (5, 1, 2, 2, 128), (3, 49, 2, 2, 64)]


def _k7_inputs(p, b, c, cs, hp, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p - 1 + b, 2 * c, hp)),
            rng.standard_normal((p, 2 * cs, hp)))


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
@pytest.mark.parametrize("grid", ["persistent", "wide"])
@pytest.mark.parametrize("shape", K7_SHAPES,
                         ids=["p40-b5-ragged", "head-shared", "tail-ragged",
                              "b1", "p3-b49"])
def test_k7_model_matches_plain_float64(shape, grid, variant):
    """"persistent": one block on one SM, fewer blocks than items, so
    each block walks several items through its ring; "wide": 132 SMs, so
    B splits wherever the items leave SMs idle."""
    p, b, c, cs, hp = shape
    per_sm, sms = (1, 1) if grid == "persistent" else (4, 132)
    plan = CM.corr_mac_plan(p, b, c, cs, hp, 8, 8, per_sm, sms, variant)
    if grid == "persistent":
        assert plan.nsplit == 1 and plan.grid < plan.items
    hist, coeff = _k7_inputs(p, b, c, cs, hp, 50 + p + b)
    got = k7_model(hist, coeff, b, plan)
    ref = CM.corr_mac_plain(torch.from_numpy(hist), torch.from_numpy(coeff),
                            b)
    for g, r in zip(got, ref):
        r = r.numpy()
        assert r.dtype == np.float64 and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-12 * np.abs(r).max())


@pytest.mark.parametrize("shape", K7_SHAPES[:3],
                         ids=["p40-b5-ragged", "head-shared", "tail-ragged"])
def test_k7_model_matches_pallas_float32(shape):
    """float32: the model (variant 0, the wide grid) against
    ``corr_mac_pallas`` in interpret mode."""
    p, b, c, cs, hp = shape
    hist, coeff = (x.astype(np.float32)
                   for x in _k7_inputs(p, b, c, cs, hp, 60 + p + b))
    jr, ji = JCM.corr_mac_pallas(jnp.asarray(hist), jnp.asarray(coeff), b,
                                 interpret=True)
    plan = CM.corr_mac_plan(p, b, c, cs, hp, 4, 4, 4, 132, 0)
    got = k7_model(hist, coeff, b, plan)
    for g, r in zip(got, (np.asarray(jr), np.asarray(ji))):
        assert g.dtype == np.float32 and g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


# ---------------------------------------------------------------------------
# K1-K3, K5, K6, K8: the ring MAC (csrc/mac_hc.cu)
# ---------------------------------------------------------------------------

def _k1():
    k = _constants("mac_hc.cu")
    return tuple(int(k[n]) for n in ("kThreads", "kMaxSlices", "kMaxBlock",
                                     "kSliceUnroll"))


MAC_THREADS, MAC_SLICES, MAC_BLOCK, MAC_UNROLL = _k1()
SMEM_STATIC = 48 * 1024  # shared memory a block gets without opting in


def test_mac_hc_constants_match_the_wrapper():
    assert (MAC_THREADS, MAC_SLICES, MAC_BLOCK, MAC_UNROLL) == (
        K._MAC_THREADS, K._MAC_SLICES, K._MAC_BLOCK, K._MAC_UNROLL)
    assert MAC_THREADS % 32 == 0 and MAC_BLOCK <= 1024 and MAC_UNROLL > 1


def _mac_slices(p, s_count):
    """Slice s's partitions, as the kernel cuts them."""
    return [range(s * p // s_count, (s + 1) * p // s_count)
            for s in range(s_count)]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("band_len", [128, 512, 1024, 8192, 1028])
@pytest.mark.parametrize("c", [1, 2, 64])
@pytest.mark.parametrize("p", [1, 3, 16, 254])
def test_mac_hc_plan_covers_the_work_once(p, c, band_len, sms):
    """Every (channel, quad, partition) is taken by exactly one thread;
    S <= P; the block fits the card (threads, shared memory, grid); an
    unsliced plan keeps one partition's loads in flight."""
    plan = K.mac_hc_plan(p, c, band_len, sms)
    s_count, width = plan.slices, plan.width
    quads = -(-band_len // 4)
    assert 1 <= s_count <= min(p, MAC_SLICES)
    assert width in (32, MAC_THREADS) and (
        width == MAC_THREADS or quads <= 32
        or s_count * MAC_THREADS > MAC_BLOCK)
    assert width * s_count <= MAC_BLOCK <= 1024
    assert (s_count - 1) * 2 * width * 16 <= SMEM_STATIC
    assert plan.unroll == (1 if s_count == 1 else MAC_UNROLL)
    assert plan.grid == (-(-quads // width), c) and c <= 65535
    # each quad of a channel belongs to one thread column of one block
    q = (np.arange(plan.grid[0])[:, None] * width
         + np.arange(width)[None, :]).ravel()
    q = q[q < quads]
    assert np.array_equal(np.sort(q), np.arange(quads))
    # the slices' runs tile [0, P): each partition once
    taken = np.zeros(p, dtype=int)
    for run in _mac_slices(p, s_count):
        assert len(run) >= 1
        taken[list(run)] += 1
    assert (taken == 1).all()
    if s_count > 1:  # slicing only where the quads leave the card short
        assert c * quads < sms * K._MAC_FILL


@pytest.mark.parametrize("shape", [(16, 64, 1024), (14, 64, 8192),
                                   (14, 64, 1024), (78, 64, 8192),
                                   (16, 64, 8192), (8, 64, 65536),
                                   (4, 64, 8192), (2, 64, 65536)],
                         ids=["k1-head", "k2-k3-tail", "k5-k6-band",
                              "j-two-stage-tail", "j-mid", "j-far",
                              "k-shard-tail", "k-shard-far"])
def test_mac_hc_plan_keeps_the_flagship_unsliced(shape):
    """The flagship's K1 [16, 128, 1024], K2/K3 [14, 128, 8192] and the
    bands of K5/K6, and session J's and K's tails, keep one slice: the
    schedule and sum order they had before slicing."""
    assert K.mac_hc_plan(*shape, 132) == K.MacPlan(
        1, 1, MAC_THREADS, (-(-shape[2] // 4 // MAC_THREADS), shape[1]))


@pytest.mark.parametrize("shape", [(16, 64, 128), (254, 64, 512),
                                   (126, 64, 1024)],
                         ids=["m-head", "m-tail", "n128-tail"])
def test_mac_hc_plan_slices_few_lanes(shape):
    """Session M's head and tail (N = 64) and N = 128's tail are sliced."""
    plan = K.mac_hc_plan(*shape, 132)
    threads = shape[1] * shape[2] // 4
    assert plan.slices > 1
    assert threads * plan.slices >= 132 * K._MAC_FILL or (
        plan.slices == min(MAC_SLICES, shape[0]))
    assert threads * (plan.slices - 1) < 132 * K._MAC_FILL  # the fewest


def mac_hc_model(ring, coeff, pos, plan, b0=0, bl=None, lane0=True):
    """csrc/mac_hc.cu on numpy planes ring [P, 2C, Hp], coeff [P, 2C | 2,
    Hp] (decoded; float64 or float32 throughout) under ``plan``, over the
    lanes [b0, b0 + bl) -> (yr, yi) [C, bl]."""
    p, c2, hp = ring.shape
    c, cs = c2 // 2, coeff.shape[1] // 2
    bl = hp - b0 if bl is None else bl
    dt = ring.dtype
    s_count, width = plan.slices, plan.width
    gx, gy = plan.grid
    quads = bl // 4
    assert gy == c and (gx - 1) * width < quads <= gx * width
    yr = np.full((c, bl), np.nan, dtype=dt)
    yi = np.full((c, bl), np.nan, dtype=dt)
    writes = np.zeros((c, bl), dtype=int)
    taken = np.zeros((c, quads, p), dtype=int)
    runs = _mac_slices(p, s_count)
    for by in range(gy):
        cc = 0 if cs == 1 else by
        for bx in range(gx):
            q = bx * width + np.arange(width)
            q = q[q < quads]  # live threads; the rest only meet the barrier
            k = (q[:, None] * 4 + np.arange(4)).ravel()
            g = b0 + k
            l0 = lane0 & (g == 0)  # (DC.re, Nyquist.re): two products
            parts = []
            for run in runs:  # thread (x, s): its slice in partition order
                ar = np.zeros(k.shape, dtype=dt)
                ai = np.zeros(k.shape, dtype=dt)
                for pp in run:
                    slot = (pos - pp) % p
                    rr, ri = ring[slot, by, g], ring[slot, c + by, g]
                    cr, ci = coeff[pp, cc, g], coeff[pp, cs + cc, g]
                    ar = ar + np.where(l0, cr * rr, cr * rr - ci * ri)
                    ai = ai + np.where(l0, ci * ri, cr * ri + ci * rr)
                    taken[by, q, pp] += 1
                parts.append((ar, ai))
            ar, ai = parts[0]
            for pr, pi in parts[1:]:  # slice 0 adds them in slice order
                ar, ai = ar + pr, ai + pi
            yr[by, k], yi[by, k] = ar, ai
            writes[by, k] += 1
    assert (taken == 1).all() and (writes == 1).all()
    return yr, yi


# (P, C, Cs, Hp, band): session M's head (16 x 128 lanes) and tail (254 x
# 512), N = 128's tail (126 x 1024), a shared filter, K5/K6 bands with and
# without lane 0
MAC_SHAPES = [(16, 3, 3, 128, None), (16, 3, 1, 128, None),
              (254, 2, 2, 512, None), (126, 2, 2, 1024, None),
              (14, 2, 1, 1024, (0, 256)), (14, 2, 2, 1024, (384, 256))]
MAC_IDS = ["m-head", "m-head-shared", "m-tail", "n128-tail",
           "band0-shared", "band3"]


def _mac_inputs(p, c, cs, hp, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p, 2 * c, hp)),
            rng.standard_normal((p, 2 * cs, hp)))


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("shape", MAC_SHAPES, ids=MAC_IDS)
def test_mac_hc_model_matches_plain_float64(shape, sms):
    p, c, cs, hp, band = shape
    b0, bl = band or (0, hp)
    plan = K.mac_hc_plan(p, c, bl, sms)
    ring, coeff = _mac_inputs(p, c, cs, hp, 70 + p + hp)
    pos = 5 % p
    got = mac_hc_model(ring, coeff, pos, plan, b0, bl, lane0=True)
    ref = K.mac_reference_hc_band(torch.from_numpy(ring),
                                  torch.from_numpy(coeff), pos, b0, bl)
    for g, r in zip(got, ref):
        r = r.numpy()
        assert r.dtype == np.float64 and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-12 * np.abs(r).max())


@pytest.mark.parametrize("sms", [1, 132])
def test_mac_packed_model_matches_plain_float64(sms):
    """K8: no lane-0 law, the first N + 1 lanes rounded up to 4 (257
    quads: a last block of one live quad)."""
    p, c, fp, nf = 16, 2, 1152, 1025
    nb = K._packed_lanes(fp, nf)
    plan = K.mac_hc_plan(p, c, nb, sms)
    ring, coeff = _mac_inputs(p, c, c, fp, 81)
    got = mac_hc_model(ring, coeff, 7, plan, 0, nb, lane0=False)
    ref = K.mac_packed_plain(torch.from_numpy(ring), torch.from_numpy(coeff),
                             7, nf)
    for g, r in zip(got, ref):
        r = r.numpy()
        assert g.shape == (c, nb) and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-12 * np.abs(r).max())


def _close32(got, ref):
    ref = np.asarray(ref)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("cs", [3, 1], ids=["per_channel", "shared"])
def test_mac_hc_model_matches_pallas_head(cs):
    """float32, session M's head [16, 2C, 128]: the model against
    ``mac_pallas_hc`` in interpret mode."""
    p, c, hp = 16, 3, 128
    ring, coeff = (t.astype(np.float32)
                   for t in _mac_inputs(p, c, cs, hp, 90 + cs))
    jr, ji = JK.mac_pallas_hc(jnp.asarray(ring), jnp.asarray(coeff),
                              jnp.int32(5), interpret=True)
    plan = K.mac_hc_plan(p, c, hp, 132)
    assert plan.slices > 1
    got = mac_hc_model(ring, coeff, 5, plan)
    _close32(got[0], jr)
    _close32(got[1], ji)


@pytest.mark.parametrize("bits", [(24, 24), (16, 16), (24, 16)],
                         ids=["int24", "int16", "int24_ring_int16_coeff"])
def test_mac_hc_model_matches_pallas_int_tail(bits):
    """float32, session M's int tail [254, 2C, 512] (C = 2): the model on
    the decoded planes against ``mac_pallas_hc_tiled_int`` in interpret
    mode."""
    p, c, hp = 254, 2, 512
    ring, coeff = (t.astype(np.float32)
                   for t in _mac_inputs(p, c, c, hp, 95 + sum(bits)))
    jr, ji = JK.mac_pallas_hc_tiled_int(
        JK.quantize_planes(jnp.asarray(ring), bits[0]),
        JK.quantize_planes(jnp.asarray(coeff), bits[1]), jnp.int32(77),
        tile=hp, interpret=True)
    dec = [K.dequantize_planes(K.quantize_planes(torch.from_numpy(t), b))
           .numpy() for t, b in ((ring, bits[0]), (coeff, bits[1]))]
    plan = K.mac_hc_plan(p, c, hp, 132)
    assert plan.slices > 1
    got = mac_hc_model(*dec, 77, plan)
    _close32(got[0], jr)
    _close32(got[1], ji)


@pytest.mark.parametrize("band", [0, 3])
def test_mac_hc_model_matches_pallas_band(band):
    """float32, K5 bands of 256 lanes of [14, 2C, 1024] (C = 2): the model
    against ``mac_pallas_hc_band`` in interpret mode (lane 0 in band 0
    only)."""
    p, c, hp, bl = 14, 2, 1024, 256
    ring, coeff = (t.astype(np.float32)
                   for t in _mac_inputs(p, c, c, hp, 100 + band))
    jr, ji = JK.mac_pallas_hc_band(jnp.asarray(ring), jnp.asarray(coeff),
                                   jnp.int32(4), band * bl, bl,
                                   interpret=True)
    plan = K.mac_hc_plan(p, c, bl, 132)
    assert plan.slices > 1
    got = mac_hc_model(ring, coeff, 4, plan, band * bl, bl, lane0=True)
    _close32(got[0], jr)
    _close32(got[1], ji)


def test_mac_packed_model_matches_pallas():
    """float32, K8 over [16, 2C, 256] planes with N + 1 = 129 live lanes
    (132 computed; the rows are zero beyond 129, as the engine keeps
    them): the model against ``mac_pallas_packed`` in interpret mode."""
    p, c, fp, nf = 16, 2, 256, 129
    ring, coeff = (t.astype(np.float32) for t in _mac_inputs(p, c, c, fp, 110))
    ring[..., nf:] = 0
    coeff[..., nf:] = 0
    jr, ji = JK.mac_pallas_packed(jnp.asarray(ring), jnp.asarray(coeff),
                                  jnp.int32(9), interpret=True)
    nb = K._packed_lanes(fp, nf)
    plan = K.mac_hc_plan(p, c, nb, 132)
    assert plan.slices > 1
    got = mac_hc_model(ring, coeff, 9, plan, 0, nb, lane0=False)
    _close32(got[0], np.asarray(jr)[:, :nb])
    _close32(got[1], np.asarray(ji)[:, :nb])
