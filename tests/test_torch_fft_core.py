"""The register-radix, self-sorting FFT core of every FFT kernel of the
port, K4 and K14-K18 (``bfir_tpu_torch/csrc/fft_common.cuh``, namespace
``bfir::fft::core``), modelled in numpy on the CPU, where no CUDA compiler
runs.

The model runs the core's passes with the same plan (parsed from the CUDA
source), the same shared-memory index maps and swizzles, the same twiddle
indices (the quarter table staged from ``_device_table(h)``, powers of two
loaded and the rest multiplied out), the same in-register radix-R DFT and
the same tail selection. It is held against ``numpy.fft`` in float64
(rel 1e-12 x max) and float32 (2e-5 x max, the reference's own bound), for
the complex transform forward, inverse and inverse-tail (K14), for the
tangle-on-load inverse tail of K4, K16 and K17 (one kernel, its points a
thread parsed from ``tail_points``) against ``np.fft.irfft(...)[n/2:]``,
and for the forward real route of K15/K18 (sample pairs loaded, Z kept in
shared memory, the untangle in pairs (k, h - k)) against ``np.fft.rfft``
packed as halfcomplex planes. A second group of tests enumerates every
pass's shared-memory accesses per thread, the kept output's stores and the
untangle's reads, and asserts that each 16-lane half-warp touches 16
distinct 8-byte bank pairs (data) or distinct bank pairs for distinct
addresses (twiddles)"""

import os
import re

import numpy as np
import pytest
import torch

from bfir_tpu_torch.kernels import fft_fused as FF
from bfir_tpu_torch.kernels import fft_pallas as FP

SRC = os.path.join(os.path.dirname(FF.__file__), os.pardir, "csrc",
                   "fft_common.cuh")
FAMILY = os.path.join(os.path.dirname(SRC), "fft_family.cu")
TAIL = os.path.join(os.path.dirname(SRC), "irfft_hc_tail.cu")
SIZES = [512, 1024, 2048, 4096, 8192, 16384]  # every h the kernels take
K14_SIZES = [h for h in SIZES if h >= 1024]  # K14's domain


def _plan_table():
    """log2 radix of each pass by log2 h, from ``core::kPlan``."""
    with open(SRC) as f:
        text = f.read()
    m = re.search(r"kPlan\[6\]\[3\]\s*=\s*\{(.*?)\};", text, re.S)
    rows = re.findall(r"\{\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\}", m.group(1))
    return {9 + i: [int(v) for v in row if int(v)]
            for i, row in enumerate(rows)}


PLAN = _plan_table()


def _log2(v):
    return int(v).bit_length() - 1


def k14_points(h):
    return 32 if h == 8192 else 16


def _points_rule(path, name):
    """(op, log2 h, its points, every other h's points) of the kernel's
    ``constexpr int name(int L) { return L == a ? b : c; }`` (or ``L >=
    a``) in ``path``, so the model tests the kernel's own rule."""
    with open(path) as f:
        text = f.read()
    m = re.search(rf"constexpr int {name}\(int L\)\s*\{{\s*return\s+L\s*"
                  r"(==|>=)\s*(\d+)\s*\?\s*(\d+)\s*:\s*(\d+)\s*;\s*\}",
                  text)
    assert m, (f"{name} in {os.path.basename(path)} is no longer "
               "`L == a ? b : c` or `L >= a ? b : c`")
    return m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4))


def _points(rule, h):
    """The points a thread that ``rule`` gives at h."""
    op, lh, pts, other = rule
    hit = _log2(h) == lh if op == "==" else _log2(h) >= lh
    return pts if hit else other


RFFT_RULE = _points_rule(FAMILY, "rfft_points")
TAIL_RULE = _points_rule(TAIL, "tail_points")


def rfft_points(h):
    """K15/K18's points a thread (``rfft_points`` in csrc/fft_family.cu)."""
    return _points(RFFT_RULE, h)


def tail_points(h):
    """The inverse tail's (K4, K16, K17) points a thread (``tail_points``
    in csrc/irfft_hc_tail.cu)."""
    return _points(TAIL_RULE, h)


def core_points(h):
    """The core's shape in the model of the complex transform: K14's, and
    K15/K18's at h = 512, below K14's domain."""
    return k14_points(h) if h >= 1024 else rfft_points(h)


# (h, points a thread) of the kernels' shapes: K14 holds 16 points a
# thread, 32 at h = 8192; the inverse tail and K15/K18 as tail_points and
# rfft_points, down to h = 512
SHAPES = sorted({(h, k14_points(h)) for h in K14_SIZES}
                | {(h, tail_points(h)) for h in SIZES}
                | {(h, rfft_points(h)) for h in SIZES})
# every shape the core's forward real route can take: h in [512, 16384],
# 8, 16 or 32 points a thread, at most 1024 threads
RFFT_SHAPES = [(1 << lh, pts) for lh in range(9, 15) for pts in (8, 16, 32)
               if (1 << lh) // pts <= 1024]


def window(h, pts):
    """The data swizzle's window (``core::Shape::W``): log2 min(pass 0's
    radix, 2 pts)."""
    return min(PLAN[_log2(h)][0], 4 if pts == 8 else 5)


def swz(i, w):
    """The data buffer's swizzle (``core::swz``): the low nibble XOR the
    four bits from bit w, rotated left by 2."""
    n = (i >> w) & 15
    return i ^ (((n << 2) | (n >> 2)) & 15)


def lane_digit(g, g_count):
    """``core::lane_digit``: the output digit lane g ends with."""
    return ((g & 1) << 1) | (g >> 1) if g_count == 4 else g


def qswz(m):
    """The quarter table's swizzle (``core::qswz``): low nibble XOR every
    higher nibble."""
    return m ^ ((m >> 4) & 15) ^ ((m >> 8) & 15)


def _w32(dtype):
    """W_32^k = e^{-2 pi i k / 32}, k < 16, rounded once (``core::w32``);
    k = 8 is exactly -i."""
    k = np.arange(16)
    w = np.exp(-2j * np.pi * k / 32)
    w[8] = -1j
    return w.astype(dtype)


def _table(h, dtype):
    """``_device_table(h)`` as complex: e^{-2 pi i t / 2h}, t < 2h, built
    in float64 and rounded once."""
    tw = FP._device_table(h, torch.device("cpu")).numpy()
    if dtype == np.complex128:
        ang = -np.pi * np.arange(2 * h) / h
        return np.exp(1j * ang)
    return (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)


def _quarter(h, tw):
    """The staged quarter table: q[qswz(m)] = tw[2m] = W_h^m, m < h/4."""
    q = np.zeros(h // 4, tw.dtype)
    m = np.arange(h // 4)
    q[qswz(m)] = tw[2 * m]
    return q


def _qtw(q, e, h, inverse):
    """W_h^e from the quarter table (``core::qtw``)."""
    lq = _log2(h) - 2
    a = q[qswz(e & ((1 << lq) - 1))]
    quad = (e >> lq) & 3
    w = a * np.array([1, -1j, -1, 1j], a.dtype)[quad]
    return np.conj(w) if inverse else w


def _dft(v, inverse):
    """The in-register radix-R DFT (``core::dft``): radix-2 Stockham over
    the last axis, natural order in and out, constants W_32^k."""
    r_ = v.shape[-1]
    w32 = _w32(v.dtype)
    if inverse:
        w32 = np.conj(w32)
    ns = 1
    while ns < r_:
        b = np.empty_like(v)
        for j in range(r_ // 2):
            k = j & (ns - 1)
            x0 = v[..., j]
            x1 = v[..., j + r_ // 2] * w32[k * (16 // ns)]
            d = 2 * (j - k) + k
            b[..., d] = x0 + x1
            b[..., d + ns] = x0 - x1
        v = b
        ns *= 2
    return v


def _passes(h):
    """(log2 radix, log2 Ns) of each pass."""
    out, lns = [], 0
    for lr in PLAN[_log2(h)]:
        out.append((lr, lns))
        lns += lr
    return out


def _split(r_, pts):
    """(G, PL, B) of a pass of radix R (``core::Pass``): lanes a
    butterfly, its points a lane, butterflies a thread."""
    g = max(1, r_ // pts)
    return g, r_ // g, pts // (r_ // g)


def _butterfly_dft(v, pts, inverse):
    """``core::butterflies`` on butterflies v [..., R] indexed by point r:
    a radix-R DFT in registers, or, over G lanes, the radix-PL DFT of lane
    g's points r = g + G s, W_R^{g k1}, and the radix-G DFT across lanes
    (decimation in frequency); returns outputs indexed by k."""
    r_ = v.shape[-1]
    g_count, pl, _ = _split(r_, pts)
    if g_count == 1:
        return _dft(v, inverse)
    w32 = _w32(v.dtype)
    w32 = np.concatenate([w32, -w32])  # W_32^e, e < 32
    if inverse:
        w32 = np.conj(w32)
    step = 32 // r_
    k1 = np.arange(pl)
    a = [_dft(v[..., g::g_count], inverse) for g in range(g_count)]
    a = [a[g] * w32[(step * g * k1) % 32] if g else a[g]
         for g in range(g_count)]
    if g_count == 4:
        rot = 1j if inverse else -1j
        a = [a[0] + a[2], a[1] + a[3], a[0] - a[2], (a[1] - a[3]) * rot]
        a = [a[0] + a[1], a[0] - a[1], a[2] + a[3], a[2] - a[3]]
    else:
        a = [a[0] + a[1], a[0] - a[1]]
    out = np.empty_like(v)
    for g in range(g_count):
        out[..., pl * lane_digit(g, g_count) + k1] = a[g]
    return out


def _twiddle(v, q, j, h, pts, lr, lns, inverse):
    """``core::twiddles``: point r of butterfly j times
    W_{Ns R}^{(j mod Ns) r}, from log2 R quarter-table loads and their
    products: W^{u G s} lowest set bit first, then lane g's W^{u g}."""
    r_ = 1 << lr
    g_count, pl, _ = _split(r_, pts)
    k = j & ((1 << lns) - 1)
    lu = _log2(h) - lns - lr
    wp = [_qtw(q, (k << (lu + e)) & (h - 1), h, inverse) for e in range(lr)]
    w = [None] * pl
    for s_ in range(1, pl):
        r = g_count * s_
        low = r & -r
        e = _log2(low)
        w[s_] = wp[e] if r == low else w[s_ - low // g_count] * wp[e]
    wg = [None, wp[0], wp[1] if lr > 1 else None,
          wp[0] * wp[1] if lr > 1 else None]
    v = v.copy()
    for g in range(g_count):
        for s_ in range(pl):
            r = g + g_count * s_
            if s_:
                v[..., r] = v[..., r] * w[s_]
            if g:
                v[..., r] = v[..., r] * wg[g]
    return v


def core_model(load, h, pts, q, inverse, tail):
    """The core on a batch of rows: ``load(k)`` gives input points k
    [rows, len(k)]; returns the natural-order outputs [rows, h] (only
    [h/2, h) written where ``tail``), the shared-memory buffer modelled
    through the swizzle."""
    s = window(h, pts)
    passes = _passes(h)
    rows = load(np.zeros(1, np.int64)).shape[0]
    z = None
    out = None
    for p, (lr, lns) in enumerate(passes):
        r_, ns = 1 << lr, 1 << lns
        j = np.arange(h // r_)                      # every butterfly
        r = np.arange(r_)
        src = j[:, None] + r[None, :] * (h // r_)   # [h/R, R]
        if p == 0:
            v = load(src.ravel()).reshape(rows, h // r_, r_)
        else:
            v = _twiddle(z[:, swz(src, s)], q, j, h, pts, lr, lns,
                         inverse)
        v = _butterfly_dft(v, pts, inverse)
        k = j & (ns - 1)
        dst = ((j >> lns) << (lns + lr))[:, None] + k[:, None] + r * ns
        if p < len(passes) - 1:
            z = np.zeros((rows, h), v.dtype)
            z[:, swz(dst, s)] = v
        else:
            keep = r >= r_ // 2 if tail else np.ones(r_, bool)
            out = np.zeros((rows, h), v.dtype)
            out[:, dst[:, keep]] = v[:, :, keep]
    return out


def k14_model(z, h, inverse, tail, dtype):
    tw = _table(h, dtype)
    q = _quarter(h, tw)
    zz = z.astype(dtype)
    y = core_model(lambda k: zz[:, k], h, core_points(h), q, inverse, tail)
    if inverse:
        y = y * np.asarray(1.0 / h, dtype=np.float64 if dtype ==
                           np.complex128 else np.float32)
    return y[:, h // 2:] if tail else y


def _tangle(hr, hi, k, h, tw):
    """``fft::tangle`` on load: Z[k] from halfcomplex planes."""
    k = np.asarray(k)
    nz = k != 0
    xr = hr[:, k]
    xi = np.where(nz, hi[:, k], 0)
    vr = np.where(nz, hr[:, (h - k) % h], hi[:, 0:1])
    vi = np.where(nz, hi[:, (h - k) % h], 0)
    half = hr.dtype.type(0.5)
    ar, ai = half * (xr + vr), half * (xi - vi)
    dr, di = half * (xr - vr), half * (xi + vi)
    w = np.conj(tw[k])
    er = w.real * dr - w.imag * di
    ei = w.real * di + w.imag * dr
    return (ar - ei) + 1j * (ai + er)


def k4_model(hr, hi, h, dtype):
    real = np.float64 if dtype == np.complex128 else np.float32
    tw = _table(h, dtype)
    q = _quarter(h, tw)
    hr, hi = hr.astype(real), hi.astype(real)
    c = core_model(lambda k: _tangle(hr, hi, k, h, tw).astype(dtype), h,
                   tail_points(h), q, True, True)[:, h // 2:]
    c = c * real(1.0 / h)
    out = np.empty((hr.shape[0], h), real)
    out[:, 0::2], out[:, 1::2] = c.real, c.imag
    return out


def zslot(i, h):
    """``core::zslot``: the kept output's slot of point i, natural order
    with bit 3 flipped in the upper half."""
    return i ^ ((i >> (_log2(h) - 1)) << 3)


def _mirror(k, h):
    """The untangle's partner of k < h/2: h - k, and h/2 for k = 0."""
    return np.where(k == 0, h // 2, h - k)


def rfft_model(x, h, dtype):
    """K15/K18 on rows x [rows, 2h]: sample pairs z[k] = x[2k] + i x[2k+1]
    into the forward core, Z kept in shared memory in zslot order, then
    the untangle in pairs (k, h - k) with W = tw[k], in the kernel's order
    of float operations -> halfcomplex planes (hr, hi) [rows, h]."""
    real = np.float64 if dtype == np.complex128 else np.float32
    tw = _table(h, dtype)
    q = _quarter(h, tw)
    xr = x.astype(real)
    z = (xr[:, 0::2] + 1j * xr[:, 1::2]).astype(dtype)
    zn = core_model(lambda k: z[:, k], h, rfft_points(h), q, False, False)
    buf = np.zeros_like(zn)
    buf[:, zslot(np.arange(h), h)] = zn            # the KEEP store
    k = np.arange(h // 2)
    p = buf[:, zslot(k, h)]
    m = buf[:, zslot(_mirror(k, h), h)]
    half = real(0.5)
    ar, ai = half * (p.real + m.real), half * (p.imag - m.imag)
    br, bi = half * (p.imag + m.imag), -half * (p.real - m.real)
    w = tw[k]
    cr = w.real * br - w.imag * bi
    ci = w.real * bi + w.imag * br
    hr = np.empty((x.shape[0], h), real)
    hi = np.empty_like(hr)
    hr[:, k[1:]], hi[:, k[1:]] = (ar + cr)[:, 1:], (ai + ci)[:, 1:]
    hr[:, h - k[1:]], hi[:, h - k[1:]] = (ar - cr)[:, 1:], (ci - ai)[:, 1:]
    p0, mh = p[:, 0], m[:, 0]
    hr[:, 0], hi[:, 0] = p0.real + p0.imag, p0.real - p0.imag
    hr[:, h // 2], hi[:, h // 2] = mh.real, -mh.imag
    return hr, hi


def _hc_planes(x):
    """np.fft.rfft(x) packed as halfcomplex planes (lane 0 = (DC.re,
    Nyquist.re))."""
    h = x.shape[-1] // 2
    spec = np.fft.rfft(x)
    return spec.real[:, :h], np.concatenate([spec.real[:, h:h + 1],
                                             spec.imag[:, 1:h]], 1)


def _rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("h", SIZES)
@pytest.mark.parametrize("mode", ["forward", "inverse", "inverse_tail"])
@pytest.mark.parametrize("dtype, rel", [(np.complex128, 1e-12),
                                        (np.complex64, 2e-5)],
                         ids=["float64", "float32"])
def test_core_model_matches_numpy(h, mode, dtype, rel):
    """K14's core: the complex FFT of rows, forward, inverse (with 1/h)
    and inverse tail-only (outputs [h/2, h))."""
    rng = np.random.default_rng(h + len(mode))
    z = rng.standard_normal((3, h)) + 1j * rng.standard_normal((3, h))
    inverse, tail = mode != "forward", mode == "inverse_tail"
    got = k14_model(z, h, inverse, tail, dtype)
    ref = np.fft.ifft(z) if inverse else np.fft.fft(z)
    ref = ref[:, h // 2:] if tail else ref
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= rel


@pytest.mark.parametrize("h", SIZES)
@pytest.mark.parametrize("dtype, rel", [(np.complex128, 1e-12),
                                        (np.complex64, 2e-5)],
                         ids=["float64", "float32"])
def test_k4_tangle_on_load_matches_irfft(h, dtype, rel):
    """The inverse tail (K4, K16, K17: one kernel) at every h it takes:
    halfcomplex planes, tangled as the first pass loads them, the inverse
    core with only the tail half computed and stored as (re, im) sample
    pairs x 1/h == np.fft.irfft(spec, 2h)[h:]; the plain wrappers of the
    three agree too, each in its own domain."""
    rng = np.random.default_rng(h)
    n = 2 * h
    x = rng.standard_normal((3, n))
    spec = np.fft.rfft(x)
    hr = spec.real[:, :h]
    hi = np.concatenate([spec.real[:, h:h + 1], spec.imag[:, 1:h]], 1)
    got = k4_model(hr, hi, h, dtype)
    ref = np.fft.irfft(spec, n)[:, h:]
    assert _rel_err(got, ref) <= rel
    plains = [FP.irfft_hc_tail_pallas_plain]  # K17 from h = 512
    if h >= 1024:
        plains += [FF.irfft_split_hc_tail_plain, FF.irfft_hc_tail_fused_plain]
    for plain in plains:
        got = plain(torch.from_numpy(hr), torch.from_numpy(hi), n).numpy()
        assert _rel_err(got, ref) <= 1e-12


@pytest.mark.parametrize("h", SIZES)
@pytest.mark.parametrize("dtype, rel", [(np.complex128, 1e-12),
                                        (np.complex64, 2e-5)],
                         ids=["float64", "float32"])
def test_rfft_pairs_untangle_matches_rfft(h, dtype, rel):
    """K15/K18: sample pairs loaded as complex points, the forward core
    with Z left in shared memory, the untangle in pairs (k, h - k) ==
    np.fft.rfft packed as halfcomplex planes; both plain wrappers agree
    too."""
    rng = np.random.default_rng(h + 1)
    x = rng.standard_normal((3, 2 * h))
    ref = np.concatenate(_hc_planes(x), 1)
    got = np.concatenate(rfft_model(x, h, dtype), 1)
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= rel
    for plain in (FF.rfft_hc_fused_plain, FP.rfft_hc_pallas_plain):
        pr, pi = plain(torch.from_numpy(x), 2 * h)
        assert _rel_err(np.concatenate([pr.numpy(), pi.numpy()], 1),
                        ref) <= 1e-12


def _half_warps(lanes):
    """Split the per-thread index array [T, ...] into half-warps of 16
    consecutive threads: [T/16, 16, ...]."""
    return lanes.reshape(lanes.shape[0] // 16, 16, *lanes.shape[1:])


def _threads(h, pts, lr):
    """Per slot group b: the butterfly j [T] and lane g [T] of every thread
    (``core::butterfly``, ``core::group_lane``)."""
    t = np.arange(h // pts)
    g_count, _, b_count = _split(1 << lr, pts)
    if g_count > 1:
        lg = _log2(g_count)
        return [(((t >> 5) << (5 - lg)) + (t & ((32 >> lg) - 1)),
                 (t >> (5 - lg)) & (g_count - 1))]
    return [(t + b * t.size, np.zeros_like(t)) for b in range(b_count)]


def _data_accesses(h, pts, keep=False):
    """Every shared-memory data access of the core, by instruction: a list
    of (what, idx [T] of physical float2 slots, one per thread); with
    ``keep``, the last pass's stores of the kept output (zslot) too."""
    s = window(h, pts)
    out = []
    passes = _passes(h)
    for p, (lr, lns) in enumerate(passes):
        r_, ns = 1 << lr, 1 << lns
        g_count, pl, _ = _split(r_, pts)
        for b, (j, g) in enumerate(_threads(h, pts, lr)):
            k = j & (ns - 1)
            d = ((j >> lns) << (lns + lr)) + k
            digit = lane_digit(g, g_count)
            for s_ in range(pl):
                if p > 0:
                    out.append((f"pass {p} load b {b} s {s_}",
                                swz(j + (g + g_count * s_) * (h // r_), s)))
                if p < len(passes) - 1:
                    out.append((f"pass {p} store b {b} s {s_}",
                                swz(d + (s_ + pl * digit) * ns, s)))
                elif keep:
                    out.append((f"kept store b {b} s {s_}",
                                zslot(d + (s_ + pl * digit) * ns, h)))
    return out


def _untangle_reads(h, pts, slot):
    """The untangle's reads of the kept output, thread t taking k = t + b T
    < h/2: (what, slot [T]) for Z[k] and for its partner Z[h - k] (Z[h/2]
    at k = 0), under the slot map ``slot``."""
    t = np.arange(h // pts)
    out = []
    for b in range(pts // 2):
        k = t + b * t.size
        out.append((f"untangle b {b} Z[k]", slot(k, h)))
        out.append((f"untangle b {b} Z[h-k]", slot(_mirror(k, h), h)))
    return out


def _conflicts(accesses):
    """(what, extra bank-pair wavefronts) of each access that some
    half-warp serves in more than one."""
    out = []
    for what, idx in accesses:
        extra = sum(16 - len(set(hw.tolist())) for hw in _half_warps(idx) % 16)
        if extra:
            out.append((what, extra))
    return out


def _twiddle_accesses(h, pts):
    """Every quarter-table load of the core: (what, slot [T])."""
    out = []
    for p, (lr, lns) in enumerate(_passes(h)):
        if p == 0:
            continue
        lu = _log2(h) - lns - lr
        for b, (j, _) in enumerate(_threads(h, pts, lr)):
            k = j & ((1 << lns) - 1)
            for e in range(lr):
                ex = (k << (lu + e)) & (h - 1)
                out.append((f"pass {p} twiddle b {b} e {e}",
                            qswz(ex & (h // 4 - 1))))
    m = np.arange(h // 4)
    out.append(("stage", qswz(m[:(m.size // 16) * 16])))
    return out


@pytest.mark.parametrize("h, pts", SHAPES)
def test_data_maps_are_conflict_free(h, pts):
    """Each pass's loads and stores: the 16 lanes of every half-warp hit 16
    distinct 8-byte bank pairs; and the swizzle is a bijection of the
    row's h slots (every store map covers all of them once)."""
    stores = []
    for what, idx in _data_accesses(h, pts):
        banks = _half_warps(idx) % 16
        for hw in banks:
            assert len(set(hw.tolist())) == 16, (h, what, hw)
        if "store" in what:
            stores.append(idx)
    if stores:
        allslots = np.concatenate(stores)
        per_pass = len(allslots) // h
        assert sorted(np.bincount(allslots, minlength=h).tolist()) == \
            [per_pass] * h


@pytest.mark.parametrize("h, pts", SHAPES)
def test_twiddle_maps_are_conflict_free(h, pts):
    """Quarter-table loads (and the staging stores): within each
    half-warp, distinct addresses fall in distinct bank pairs (equal
    addresses are one broadcast)."""
    for what, idx in _twiddle_accesses(h, pts):
        for hw in _half_warps(idx):
            slots = set(hw.tolist())
            assert len({s % 16 for s in slots}) == len(slots), (h, what, hw)


@pytest.mark.parametrize("h, pts", RFFT_SHAPES)
def test_rfft_kept_output_and_untangle_are_conflict_free(h, pts):
    """K15/K18 at every shape the core can take: the passes, the last
    pass's stores of the kept output and the untangle's reads of Z[k] and
    Z[h - k] hit 16 distinct bank pairs in every half-warp; the kept
    stores fill each of the h slots once and the untangle reads each
    once; the twiddle loads stay conflict-free. Under the passes' swizzle
    the partner reads would not: 16 consecutive k have mirrors h - k in
    two 16-point groups, which swz XORs differently."""
    data = _data_accesses(h, pts, keep=True)
    reads = _untangle_reads(h, pts, zslot)
    assert _conflicts(data) == [] and _conflicts(reads) == []
    twiddles = _twiddle_accesses(h, pts)
    assert [w for w, idx in twiddles for hw in _half_warps(idx)
            if len({s % 16 for s in set(hw.tolist())})
            != len(set(hw.tolist()))] == []
    for accesses in ([idx for what, idx in data if "kept" in what],
                     [idx for _, idx in reads]):
        assert np.bincount(np.concatenate(accesses), minlength=h).tolist() \
            == [1] * h
    swizzled = _untangle_reads(h, pts, lambda i, n: swz(i, window(n, pts)))
    assert _conflicts(swizzled)


def test_plan_barriers_and_radices():
    """Radices 8, 16 or 32 whose product is h; ceil(log_R h) - 1 exchanges
    through shared memory: one at h = 512 and 1024, at most three (block
    barriers: one after pass 0, two around each middle pass) at
    h <= 16384; every size from 512 has a plan."""
    assert sorted(PLAN) == list(range(9, 15))
    for lh, plan in PLAN.items():
        assert sum(plan) == lh
        assert all(3 <= lr <= 5 for lr in plan)
        barriers = 1 + 2 * (len(plan) - 2)
        assert barriers <= (1 if lh <= 10 else 3)
        assert all(_split(1 << lr, pts)[0] <= 4 for lr in plan
                   for pts in (8, 16))


