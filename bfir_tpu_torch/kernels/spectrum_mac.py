"""The uniform engines and their ring-MAC kernels (K1-K3, K5, K6, K8,
K10-K13).

Counterpart of ``bfir_tpu/kernels/spectrum_mac.py``. The ring of input
spectra stays fixed in memory, one slot is overwritten per block, and the
MAC reads partition p from slot ``(pos - p) mod P`` (brutefir's
``(blockcounter - i) % n_blocks``). Spectra are packed halfcomplex planes
``[P, 2C, Hp]``: re rows, then im rows; lane 0 = (DC.re, Nyquist.re);
``Hp`` is n_fft/2 rounded up to 128. Shared coefficients are ``[P, 2, Hp]``.
The packed engine keeps split re/im planes ``[P, 2C, Fp]`` of the full
N + 1 bins, ``Fp`` = N + 1 rounded up to 128, with no lane-0 law.

The uniform-step family, one engine per layout of the same convolution:

- ``step_hc`` (K1) and ``step_packed`` (K8), which the session runs;
- ``step_split`` (K11): four separate planes ``[P, C, Fp]``;
- ``step_chunked`` (K10): the packed ring doubled to ``[2P, 2C, Fp]``
  (slot s mirrored at s + P) against chunk-reversed coefficients;
- ``step_hc2`` (K13): ``step_hc`` with the ring-slot insert inside the MAC
  kernel;
- ``step_hc_fused`` (K12): ``step_hc`` with the MAC and the overlap-save
  inverse in one kernel.

Kernel wrappers (``mac_hc``, ``mac_hc_tiled``, ``mac_hc_tiled_int``, the
split-tail schedule's one-band ``mac_hc_band``, ``mac_hc_band_int``, the
packed engine's ``mac_packed``, and ``mac_chunked``, ``mac_split``,
``mac_tail_hc``, ``mac_hc_insert``) take their plain PyTorch version for
CPU tensors and launch the CUDA kernel in ``csrc/mac_hc.cu``,
``csrc/mac_variants.cu`` or ``csrc/mac_tail_hc.cu`` for CUDA tensors (or
raise); each counts its launches in its ``launches`` attribute. K10-K13
compute in float32 on CUDA (float64 there raises ``NotImplementedError``);
on the CPU their plain versions run in the tensors' dtype. ``blockcounter``
is a host int, so no step reads the device to pick a ring slot. Ring
inserts update the ring in place: a state passed to a step must not be
used again.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from bfir_tpu_torch.core.spec import FilterSpec
from bfir_tpu_torch.kernels import cuda_lib
from bfir_tpu_torch.ops import fft as F


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Block-scaled integer planes (the int24 / int16 storage tiers)
# ---------------------------------------------------------------------------


class IntPlanes(NamedTuple):
    """Block-scaled integer spectra: ``hi`` int16 [..., H], ``lo`` uint8
    [..., H] (None for the int16 tier), ``scale`` f32 [..., 128] (the row's
    scale repeated along 128 lanes, the reference's layout)."""

    hi: torch.Tensor
    lo: Optional[torch.Tensor]
    scale: torch.Tensor


_I24_MAX = float(2 ** 23 - 1)
_I16_MAX = 32767.0


def quantize_planes(planes: torch.Tensor, bits: int) -> IntPlanes:
    """Quantize planes [..., H] per row: q = round(a / s), s = rowmax / qmax;
    int24 splits q into an arithmetic high int16 (q >> 8) and an unsigned
    low byte (q & 255)."""
    if bits not in (16, 24):
        raise ValueError(f"bits must be 16 or 24, got {bits}")
    qmax = _I24_MAX if bits == 24 else _I16_MAX
    planes = planes.to(torch.float32)
    s = torch.clamp_min(planes.abs().amax(dim=-1, keepdim=True) / qmax, 1e-30)
    q = torch.clamp(torch.round(planes / s), -qmax, qmax).to(torch.int32)
    scale = s.expand(*s.shape[:-1], 128).contiguous()
    if bits == 16:
        return IntPlanes(hi=q.to(torch.int16), lo=None, scale=scale)
    return IntPlanes(hi=(q >> 8).to(torch.int16),
                     lo=(q & 255).to(torch.uint8), scale=scale)


def dequantize_planes(ip: IntPlanes) -> torch.Tensor:
    """Inverse of ``quantize_planes``."""
    q = ip.hi.to(torch.int32)
    if ip.lo is not None:
        q = q * 256 + ip.lo.to(torch.int32)
    return q.to(torch.float32) * ip.scale[..., :1]


# ---------------------------------------------------------------------------
# Plain versions of the MAC kernels
# ---------------------------------------------------------------------------


def mac_reference_hc(ring_re, ring_im, coeff_re, coeff_im, pos: int,
                     lane0: bool = True):
    """Halfcomplex MAC ``sum_p coeff[p] * ring[(pos - p) mod P]`` on split
    planes; lane 0 is two real products (DC.re and Nyquist.re) where
    ``lane0`` says the planes start at the spectrum's lane 0."""
    p = ring_re.shape[0]
    idx = torch.remainder(pos - torch.arange(p), p).to(ring_re.device)
    rr = ring_re.index_select(0, idx)
    ri = ring_im.index_select(0, idx)
    p1 = coeff_re * rr
    p2 = coeff_im * ri
    a_r = p1 - p2
    a_i = coeff_re * ri + coeff_im * rr
    if lane0:
        a_r[..., 0] = p1[..., 0]
        a_i[..., 0] = p2[..., 0]
    return a_r.sum(dim=0), a_i.sum(dim=0)


def mac_hc_plain(ring, coeff, pos: int, lane0: bool = True):
    """Plain version of K1 and K2: ``mac_reference_hc`` on packed planes
    [P, 2C, Hp] and [P, 2C | 2, Hp]; bf16 planes compute in float32."""
    if ring.dtype == torch.bfloat16:
        ring = ring.to(torch.float32)
    if coeff.dtype == torch.bfloat16:
        coeff = coeff.to(torch.float32)
    c = ring.shape[1] // 2
    cs = coeff.shape[1] // 2
    return mac_reference_hc(ring[:, :c], ring[:, c:], coeff[:, :cs],
                            coeff[:, cs:], pos, lane0)


# ``y = sum_p coeff[p] * ring[(pos - p) mod P]``, a complex multiply on split
# planes (ring_re, ring_im, coeff_re, coeff_im, pos): the packed engine's MAC
mac_reference = functools.partial(mac_reference_hc, lane0=False)


def _packed_lanes(fp: int, n_freq: int) -> int:
    """The lanes K8 computes: ``n_freq`` rounded up to the kernel's 4-lane
    vectors."""
    if not 1 <= n_freq <= fp:
        raise ValueError(f"n_freq {n_freq} outside [1, Fp={fp}]")
    return min(_round_up(n_freq, 4), fp)


def mac_packed_plain(ring_pk, coeff_pk, pos: int, n_freq: int):
    """Plain version of K8: ``mac_hc_plain`` without the lane-0 law on
    packed planes [P, 2C, Fp], over the first ``n_freq`` lanes rounded up
    to 4 -> (yr, yi) [C, that many lanes]."""
    nb = _packed_lanes(ring_pk.shape[-1], n_freq)
    return mac_hc_plain(ring_pk[..., :nb], coeff_pk[..., :nb], pos,
                        lane0=False)


def mac_split_plain(ring_re, ring_im, coeff_re, coeff_im, pos: int,
                    n_freq: int):
    """Plain version of K11: ``mac_reference`` on four planes [P, C, Fp]
    over the first ``n_freq`` lanes rounded up to 4 -> (yr, yi) [C, that
    many lanes]."""
    nb = _packed_lanes(ring_re.shape[-1], n_freq)
    return mac_reference(ring_re[..., :nb], ring_im[..., :nb],
                         coeff_re[..., :nb], coeff_im[..., :nb], pos)


def _check_chunk(p: int, k: int) -> None:
    if k < 1 or p % k:
        raise ValueError(f"chunk size {k} must divide partition count {p}")


def mac_chunked_plain(ring2, coeff_rk, pos: int, n_freq: int, k: int = 4):
    """Plain version of K10, reading the layouts as the kernel does: chunk
    i, element t pairs ring2 [2P, 2C, Fp] slot ``pos + P - (i+1)k + 1 + t``
    with row ``i k + t`` of the chunk-reversed coefficients [P, 2C, Fp]
    (no lane-0 law) -> (yr, yi) [C, ``n_freq`` rounded up to 4]."""
    p, c = ring2.shape[0] // 2, ring2.shape[1] // 2
    _check_chunk(p, k)
    nb = _packed_lanes(ring2.shape[-1], n_freq)
    j = torch.arange(p)
    slots = pos % p + p - (j // k + 1) * k + 1 + j % k
    r = ring2[..., :nb].index_select(0, slots.to(ring2.device))
    g = coeff_rk[..., :nb]
    rr, ri, cr, ci = r[:, :c], r[:, c:], g[:, :c], g[:, c:]
    return (cr * rr - ci * ri).sum(dim=0), (cr * ri + ci * rr).sum(dim=0)


def mac_hc_insert_plain(ring_pk, coeff_pk, xpk, pos: int):
    """Plain version of K13: write ``xpk`` [2C, Hp] into ring slot ``pos``
    (in place), then ``mac_hc_plain`` -> (yr, yi, ring)."""
    ring_pk[pos] = xpk
    yr, yi = mac_hc_plain(ring_pk, coeff_pk, pos)
    return yr, yi, ring_pk


def mac_tail_hc_plain(ring_pk, coeff_pk, wr, wi, pos: int):
    """Plain version of K12: ``mac_hc_plain``, then the tail basis product
    ``yr @ wr + yi @ wi`` -> out [C, Hp]."""
    yr, yi = mac_hc_plain(ring_pk, coeff_pk, pos)
    return yr @ wr + yi @ wi


def mac_reference_hc_int(ring: IntPlanes, coeff: IntPlanes, pos: int):
    """Plain version of K3: decode, then ``mac_reference_hc`` (f32)."""
    return mac_hc_plain(dequantize_planes(ring), dequantize_planes(coeff), pos)


def mac_reference_hc_band(ring_pk, coeff_pk, pos: int, band_start: int,
                          band_len: int):
    """Plain version of K5: ``mac_hc_plain`` over the lanes
    [band_start, band_start + band_len) -> (yr, yi) [C, band_len]; the lane-0
    law holds only in the band that starts at lane 0."""
    sl = slice(band_start, band_start + band_len)
    return mac_hc_plain(ring_pk[..., sl], coeff_pk[..., sl], pos,
                        lane0=band_start == 0)


def mac_reference_hc_band_int(ring: IntPlanes, coeff: IntPlanes, pos: int,
                              band_start: int, band_len: int):
    """Plain version of K6: decode, then ``mac_reference_hc_band``."""
    return mac_reference_hc_band(dequantize_planes(ring),
                                 dequantize_planes(coeff), pos, band_start,
                                 band_len)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# storage kinds of csrc/mac_hc.cu
_F32, _BF16, _I24, _I16 = 0, 1, 2, 3


def _float_plane(x: torch.Tensor, name: str, device):
    cuda_lib.require_cuda(x, name, (torch.float32, torch.bfloat16), device)
    kind = _F32 if x.dtype == torch.float32 else _BF16
    return kind, x.data_ptr(), None, None, x.shape


def _int_plane(ip: IntPlanes, name: str, device):
    cuda_lib.require_cuda(ip.hi, name + ".hi", (torch.int16,), device)
    cuda_lib.require_cuda(ip.scale, name + ".scale", (torch.float32,), device)
    p, rows, _ = ip.hi.shape
    if tuple(ip.scale.shape) != (p, rows, 128):
        raise ValueError(f"{name}.scale must be [{p}, {rows}, 128], got "
                         f"{tuple(ip.scale.shape)}")
    if ip.lo is None:
        return _I16, ip.hi.data_ptr(), None, ip.scale.data_ptr(), ip.hi.shape
    cuda_lib.require_cuda(ip.lo, name + ".lo", (torch.uint8,), device)
    if ip.lo.shape != ip.hi.shape:
        raise ValueError(f"{name}.lo shape {tuple(ip.lo.shape)} != hi shape "
                         f"{tuple(ip.hi.shape)}")
    return (_I24, ip.hi.data_ptr(), ip.lo.data_ptr(), ip.scale.data_ptr(),
            ip.hi.shape)


# csrc/mac_hc.cu's kThreads (quads a block walks), kMaxSlices, kMaxBlock
# (threads a block) and kSliceUnroll
_MAC_THREADS, _MAC_SLICES, _MAC_BLOCK, _MAC_UNROLL = 64, 16, 512, 2
# Threads an SM that fill the card for the MAC (a quarter of its 2048: the
# loads in flight that reach HBM's bandwidth); with a chain of at most
# _MAC_SHORT_CHAIN partitions, _MAC_FILL_SHORT an SM do (see mac_hc_plan)
_MAC_FILL, _MAC_FILL_SHORT, _MAC_SHORT_CHAIN = 512, 64, 16


class MacPlan(NamedTuple):
    """A launch of csrc/mac_hc.cu: ``slices`` partition slices (S), the
    ``unroll`` of each slice's loop, blocks of ``width`` x S threads on a
    ``grid`` of (quad blocks, channels)."""

    slices: int
    unroll: int
    width: int
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=None)
def mac_hc_plan(p: int, c: int, band_len: int, sms: int) -> MacPlan:
    """The plan of a ring MAC over ``p`` partitions, ``c`` channels and
    ``band_len`` lanes (4 to a thread) on a card of ``sms`` SMs.

    One thread a quad a channel (S = 1: the partitions summed in one
    loop) where that fills the card, ``_MAC_FILL`` threads an SM, or where
    each thread's chain is at most ``_MAC_SHORT_CHAIN`` partitions and
    the quads give ``_MAC_FILL_SHORT`` threads an SM: the flagship's K1
    [16, 128, 1024], K2/K3 [14, 128, 8192] and K5/K6 bands keep the
    schedule and sum order they had at their bound. Elsewhere the
    partitions are cut into the fewest slices that fill the card, at most
    ``_MAC_SLICES`` and P; a block that would pass ``_MAC_BLOCK`` threads
    walks 32 quads instead of 64. Sliced threads keep ``_MAC_UNROLL``
    partitions' loads in flight."""
    quads = -(-band_len // 4)
    threads = c * quads
    fill = sms * _MAC_FILL
    if threads >= fill or (p <= _MAC_SHORT_CHAIN
                           and threads >= sms * _MAC_FILL_SHORT):
        slices = 1
    else:
        slices = min(_MAC_SLICES, p, -(-fill // threads))
    width = (32 if quads <= 32 or slices * _MAC_THREADS > _MAC_BLOCK
             else _MAC_THREADS)
    return MacPlan(slices, 1 if slices == 1 else _MAC_UNROLL, width,
                   (-(-quads // width), c))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _mac_plan_for(p: int, c: int, band_len: int, device) -> MacPlan:
    """``mac_hc_plan`` on ``device``'s SM count."""
    return mac_hc_plan(p, c, band_len, _sm_count(device))


def _mac_out(c: int, lanes: int, device):
    yr = torch.empty((c, lanes), dtype=torch.float32, device=device)
    return yr, torch.empty_like(yr)


def _launch_mac(r, g, pos: int, device, band=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/mac_hc.cu on plane descriptors from _float_plane /
    _int_plane over the lanes ``band`` = (start, length) (all of Hp when
    None); returns (yr, yi) [C, length] float32."""
    r_kind, r_a, r_lo, r_s, (p, c2, hp) = r
    g_kind, g_a, g_lo, g_s, (gp, gc2, ghp) = g
    c, cs = c2 // 2, gc2 // 2
    if c2 % 2 or gc2 % 2 or gp != p or ghp != hp or cs not in (1, c):
        raise ValueError(f"ring [{p}, {c2}, {hp}] and coefficients "
                         f"[{gp}, {gc2}, {ghp}] do not pair")
    if hp % 128:
        raise ValueError(f"Hp {hp} must be a multiple of 128")
    b0, bl = band or (0, hp)
    plan = _mac_plan_for(p, c, bl, device)
    yr, yi = _mac_out(c, bl, device)
    lib = cuda_lib.load()
    with torch.cuda.device(device):
        err = lib.bfir_mac_hc(r_a, r_lo, r_s, r_kind, g_a, g_lo, g_s, g_kind,
                              yr.data_ptr(), yi.data_ptr(), p, c, cs, hp, b0,
                              bl, pos % p, *plan[:3], cuda_lib.stream_of(yr))
    cuda_lib.check(err, "mac_hc")
    return yr, yi


def mac_hc(ring_pk: torch.Tensor, coeff_pk: torch.Tensor, pos: int):
    """K1: halfcomplex ring MAC over ring [P, 2C, Hp] and coefficients
    [P, 2C | 2, Hp], float32 or bf16 storage, float32 arithmetic ->
    (yr, yi) [C, Hp]. Replaces
    ``spectrum_mac.mac_pallas_hc``."""
    if ring_pk.device.type == "cpu":
        return mac_hc_plain(ring_pk, coeff_pk, pos)
    dev = ring_pk.device
    out = _launch_mac(_float_plane(ring_pk, "ring", dev),
                      _float_plane(coeff_pk, "coeff", dev), pos, dev)
    mac_hc.launches += 1
    return out


def _check_tile(hp: int, tile: int) -> None:
    if hp % tile:
        raise ValueError(f"freq tile {tile} must divide Hp {hp}")


def mac_hc_tiled(ring_pk: torch.Tensor, coeff_pk: torch.Tensor, pos: int,
                 tile: int = 2048):
    """K2: ``mac_hc`` for the two-stage tail, with float32 or bf16 storage
    (accumulated in float32). ``tile`` is validated like the reference's
    (it must divide Hp) but only shaped the TPU's VMEM use. Replaces
    ``spectrum_mac.mac_pallas_hc_tiled``."""
    _check_tile(ring_pk.shape[-1], tile)
    if ring_pk.device.type == "cpu":
        return mac_hc_plain(ring_pk, coeff_pk, pos)
    dev = ring_pk.device
    out = _launch_mac(_float_plane(ring_pk, "ring", dev),
                      _float_plane(coeff_pk, "coeff", dev), pos, dev)
    mac_hc_tiled.launches += 1
    return out


def mac_hc_tiled_int(ring: IntPlanes, coeff: IntPlanes, pos: int,
                     tile: int = 2048):
    """K3: ``mac_hc_tiled`` on block-scaled integer planes (int24 or int16,
    separately for ring and coefficients), decoded in the kernel and
    accumulated in float32. Replaces
    ``spectrum_mac.mac_pallas_hc_tiled_int``."""
    _check_tile(ring.hi.shape[-1], tile)
    if ring.hi.device.type == "cpu":
        return mac_reference_hc_int(ring, coeff, pos)
    dev = ring.hi.device
    out = _launch_mac(_int_plane(ring, "ring", dev),
                      _int_plane(coeff, "coeff", dev), pos, dev)
    mac_hc_tiled_int.launches += 1
    return out


def _check_band(hp: int, band_start: int, band_len: int) -> None:
    if band_start % 128 or band_len % 128 or band_len < 128:
        raise ValueError(f"band [{band_start}, {band_start + band_len}) must "
                         "be 128-lane aligned")
    if band_start < 0 or band_start + band_len > hp:
        raise ValueError(f"band [{band_start}, {band_start + band_len}) "
                         f"outside Hp={hp}")


def mac_hc_band(ring_pk: torch.Tensor, coeff_pk: torch.Tensor, pos: int,
                band_start: int, band_len: int):
    """K5: ``mac_hc_tiled`` over one 128-aligned frequency band
    [band_start, band_start + band_len): all partitions, one slice of the
    spectrum, float32 or bf16 storage, per-channel or shared coefficients ->
    (yr, yi) [C, band_len] float32. The split-tail schedule runs one band
    per streaming phase. Replaces ``spectrum_mac.mac_pallas_hc_band``."""
    _check_band(ring_pk.shape[-1], band_start, band_len)
    if ring_pk.device.type == "cpu":
        return mac_reference_hc_band(ring_pk, coeff_pk, pos, band_start,
                                     band_len)
    dev = ring_pk.device
    out = _launch_mac(_float_plane(ring_pk, "ring", dev),
                      _float_plane(coeff_pk, "coeff", dev), pos, dev,
                      (band_start, band_len))
    mac_hc_band.launches += 1
    return out


def mac_hc_band_int(ring: IntPlanes, coeff: IntPlanes, pos: int,
                    band_start: int, band_len: int):
    """K6: ``mac_hc_band`` on block-scaled integer planes (int24 or int16,
    per-row ``[P, 2C, 128]`` scales), decoded in the kernel. Replaces
    ``spectrum_mac.mac_pallas_hc_band_int``."""
    _check_band(ring.hi.shape[-1], band_start, band_len)
    if ring.hi.device.type == "cpu":
        return mac_reference_hc_band_int(ring, coeff, pos, band_start,
                                         band_len)
    dev = ring.hi.device
    out = _launch_mac(_int_plane(ring, "ring", dev),
                      _int_plane(coeff, "coeff", dev), pos, dev,
                      (band_start, band_len))
    mac_hc_band_int.launches += 1
    return out


def mac_packed(ring_pk: torch.Tensor, coeff_pk: torch.Tensor, pos: int,
               n_freq: int):
    """K8: the packed engine's ring MAC over float32 ring and coefficients
    [P, 2C, Fp] (re rows, then im rows; no lane-0 law) -> (yr, yi) float32
    [C, L], L = ``n_freq`` rounded up to 4 (at most Fp). The engine passes
    its N + 1 bins, so the kernel neither reads nor writes the zero lanes
    that pad a row to Fp. Replaces ``spectrum_mac.mac_pallas_packed``."""
    if ring_pk.device.type == "cpu":
        return mac_packed_plain(ring_pk, coeff_pk, pos, n_freq)
    dev = ring_pk.device
    cuda_lib.require_cuda(ring_pk, "ring", (torch.float32,), dev)
    cuda_lib.require_cuda(coeff_pk, "coeff", (torch.float32,), dev)
    p, c2, fp = ring_pk.shape
    if c2 % 2 or tuple(coeff_pk.shape) != (p, c2, fp):
        raise ValueError(f"ring {list(ring_pk.shape)} and coefficients "
                         f"{list(coeff_pk.shape)} must both be [P, 2C, Fp]")
    if fp % 4:
        raise ValueError(f"Fp {fp} must be a multiple of 4")
    c, nb = c2 // 2, _packed_lanes(fp, n_freq)
    plan = _mac_plan_for(p, c, nb, dev)
    yr, yi = _mac_out(c, nb, dev)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        err = lib.bfir_mac_packed(ring_pk.data_ptr(), coeff_pk.data_ptr(),
                                  yr.data_ptr(), yi.data_ptr(), p, c, fp, nb,
                                  pos % p, *plan[:3], cuda_lib.stream_of(yr))
    cuda_lib.check(err, "mac_packed")
    mac_packed.launches += 1
    return yr, yi


def _f32_cuda(x: torch.Tensor, name: str, device) -> None:
    """Raise unless ``x`` is a float32 CUDA tensor that K10-K13 take; a
    float64 one raises ``NotImplementedError``."""
    cuda_lib.require_cuda(x, name, (torch.float32, torch.float64), device)
    if x.dtype == torch.float64:
        raise NotImplementedError(
            f"{name} is float64: the kernel computes in float32; float64 on "
            'CUDA runs on engine_mode="extended" (or "auto")')


def _same_shape(shape, expect, what: str) -> None:
    if tuple(shape) != tuple(expect):
        raise ValueError(f"{what} must be {list(expect)}, got {list(shape)}")


def mac_split(ring_re: torch.Tensor, ring_im: torch.Tensor,
              coeff_re: torch.Tensor, coeff_im: torch.Tensor, pos: int,
              n_freq: int):
    """K11: the split-plane ring MAC over four float32 planes [P, C, Fp]
    (ring re/im, per-channel coefficient re/im; no lane-0 law) -> (yr, yi)
    float32 [C, L], L = ``n_freq`` rounded up to 4 (at most Fp). Replaces
    ``spectrum_mac.mac_pallas``."""
    planes = {"ring_re": ring_re, "ring_im": ring_im, "coeff_re": coeff_re,
              "coeff_im": coeff_im}
    if ring_re.device.type == "cpu":
        return mac_split_plain(ring_re, ring_im, coeff_re, coeff_im, pos,
                               n_freq)
    dev = ring_re.device
    p, c, fp = ring_re.shape
    for name, t in planes.items():
        _f32_cuda(t, name, dev)
        _same_shape(t.shape, (p, c, fp), name)
    if fp % 4:
        raise ValueError(f"Fp {fp} must be a multiple of 4")
    nb = _packed_lanes(fp, n_freq)
    yr, yi = _mac_out(c, nb, dev)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        err = lib.bfir_mac_split(*(t.data_ptr() for t in planes.values()),
                                 yr.data_ptr(), yi.data_ptr(), p, c, fp, nb,
                                 pos % p, cuda_lib.stream_of(yr))
    cuda_lib.check(err, "mac_split")
    mac_split.launches += 1
    return yr, yi


def mac_chunked(ring2: torch.Tensor, coeff_rk: torch.Tensor, pos: int,
                n_freq: int, k: int = 4):
    """K10: the packed ring MAC over the doubled ring [2P, 2C, Fp] (slot s
    mirrored at s + P) and chunk-reversed coefficients [P, 2C, Fp]
    (``chunk_reverse_coeffs(..., k)``), float32 -> (yr, yi) float32
    [C, L], L = ``n_freq`` rounded up to 4. ``k`` must divide P; it set the
    TPU kernel's DMA granule and sets the CUDA kernel's unroll depth, not
    the sum. Replaces ``spectrum_mac.mac_pallas_chunked``."""
    p2, c2, fp = ring2.shape
    _check_chunk(p2 // 2, k)
    if ring2.device.type == "cpu":
        return mac_chunked_plain(ring2, coeff_rk, pos, n_freq, k)
    dev = ring2.device
    _f32_cuda(ring2, "ring2", dev)
    _f32_cuda(coeff_rk, "coeff_rk", dev)
    p = p2 // 2
    if p2 % 2 or c2 % 2:
        raise ValueError(f"ring2 {list(ring2.shape)} must be [2P, 2C, Fp]")
    _same_shape(coeff_rk.shape, (p, c2, fp), "coeff_rk")
    if fp % 4:
        raise ValueError(f"Fp {fp} must be a multiple of 4")
    nb = _packed_lanes(fp, n_freq)
    yr, yi = _mac_out(c2 // 2, nb, dev)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        err = lib.bfir_mac_chunked(ring2.data_ptr(), coeff_rk.data_ptr(),
                                   yr.data_ptr(), yi.data_ptr(), p, c2 // 2,
                                   fp, nb, pos % p, k, cuda_lib.stream_of(yr))
    cuda_lib.check(err, "mac_chunked")
    mac_chunked.launches += 1
    return yr, yi


def _check_hc_pair(ring_pk, coeff_pk) -> None:
    """K12 and K13 take per-channel coefficients only, as the reference's
    BlockSpecs do (on the CPU too)."""
    _same_shape(coeff_pk.shape, ring_pk.shape,
                "coefficients (per channel, as the ring)")
    if ring_pk.shape[1] % 2 or ring_pk.shape[-1] % 4:
        raise ValueError(f"ring {list(ring_pk.shape)} must be [P, 2C, Hp] "
                         "with Hp a multiple of 4")


def mac_hc_insert(ring_pk: torch.Tensor, coeff_pk: torch.Tensor,
                  xpk: torch.Tensor, pos: int):
    """K13: the halfcomplex ring MAC (``mac_hc``) over float32 ring and
    per-channel coefficients [P, 2C, Hp], where partition 0 multiplies the
    new frame spectrum ``xpk`` [2C, Hp] and the kernel writes ``xpk`` into
    ring slot ``pos`` in place -> (yr, yi, ring). Replaces
    ``spectrum_mac.mac_pallas_hc_insert``."""
    _check_hc_pair(ring_pk, coeff_pk)
    if ring_pk.device.type == "cpu":
        return mac_hc_insert_plain(ring_pk, coeff_pk, xpk, pos)
    dev = ring_pk.device
    for name, t in (("ring", ring_pk), ("coeff", coeff_pk), ("xpk", xpk)):
        _f32_cuda(t, name, dev)
    p, c2, hp = ring_pk.shape
    _same_shape(xpk.shape, (c2, hp), "xpk")
    yr, yi = _mac_out(c2 // 2, hp, dev)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        err = lib.bfir_mac_hc_insert(ring_pk.data_ptr(), coeff_pk.data_ptr(),
                                     xpk.data_ptr(), yr.data_ptr(),
                                     yi.data_ptr(), p, c2 // 2, hp, pos % p,
                                     cuda_lib.stream_of(yr))
    cuda_lib.check(err, "mac_hc_insert")
    mac_hc_insert.launches += 1
    return yr, yi, ring_pk


# K12's product tile (channels x samples) and k-slice, csrc/mac_tail_hc.cu's
# kTile and kSlice
_TAIL_TILE, _TAIL_SLICE = 64, 16


def mac_tail_plan(c: int, hp: int, grid: int) -> Tuple[int, int, int]:
    """K12's product work for a grid of ``grid`` blocks -> (splits, k rows
    a split, scratch floats). The [C, 2Hp] x [2Hp, Hp] product is cut into
    64 x 64 output tiles, and the k range into splits of whole 16-row
    slices, at least four a split, so that tiles x splits is about the
    grid. The scratch holds the accumulator [2Hp, C rounded up to 64] and,
    with more than one split, the partial sums [splits, C, Hp]."""
    tiles = -(-c // _TAIL_TILE) * -(-hp // _TAIL_TILE)
    slices = -(-2 * hp // _TAIL_SLICE)
    splits = max(1, min(grid // tiles, slices // 4))
    per = -(-slices // splits)
    splits = -(-slices // per)
    scratch = 2 * hp * _round_up(c, _TAIL_TILE)
    if splits > 1:
        scratch += splits * c * hp
    return splits, per * _TAIL_SLICE, scratch


@functools.lru_cache(maxsize=None)
def _tail_grid(device: torch.device) -> int:
    """Blocks of K12's cooperative grid on ``device``."""
    grid = ctypes.c_int()
    lib = cuda_lib.load()
    with torch.cuda.device(device):
        err = lib.bfir_mac_tail_hc_grid(ctypes.byref(grid))
    cuda_lib.check(err, "mac_tail_hc grid")
    return grid.value


def mac_tail_hc(ring_pk: torch.Tensor, coeff_pk: torch.Tensor,
                wr: torch.Tensor, wi: torch.Tensor, pos: int):
    """K12: the halfcomplex ring MAC over float32 ring and per-channel
    coefficients [P, 2C, Hp] followed, in the same kernel, by the tail
    product ``acc_r @ wr + acc_i @ wi`` against the half-DFT basis
    [Hp, Hp] (``_tail_basis``) -> out float32 [C, Hp], the time-domain
    overlap-save tail. One cooperative launch over a grid that fills the
    card (``mac_tail_plan``). Replaces ``spectrum_mac.mac_tail_pallas_hc``."""
    _check_hc_pair(ring_pk, coeff_pk)
    if ring_pk.device.type == "cpu":
        return mac_tail_hc_plain(ring_pk, coeff_pk, wr, wi, pos)
    dev = ring_pk.device
    for name, t in (("ring", ring_pk), ("coeff", coeff_pk), ("wr", wr),
                    ("wi", wi)):
        _f32_cuda(t, name, dev)
    p, c2, hp = ring_pk.shape
    c = c2 // 2
    _same_shape(wr.shape, (hp, hp), "wr")
    _same_shape(wi.shape, (hp, hp), "wi")
    grid = _tail_grid(dev)
    splits, ks, floats = mac_tail_plan(c, hp, grid)
    out = torch.empty((c, hp), dtype=torch.float32, device=dev)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        err = lib.bfir_mac_tail_hc(ring_pk.data_ptr(), coeff_pk.data_ptr(),
                                   wr.data_ptr(), wi.data_ptr(),
                                   out.data_ptr(), scratch.data_ptr(), p, c,
                                   hp, pos % p, grid, splits, ks,
                                   cuda_lib.stream_of(out))
    cuda_lib.check(err, "mac_tail_hc")
    mac_tail_hc.launches += 1
    return out


mac_hc.launches = 0
mac_hc_tiled.launches = 0
mac_hc_tiled_int.launches = 0
mac_hc_band.launches = 0
mac_hc_band_int.launches = 0
mac_packed.launches = 0
mac_split.launches = 0
mac_chunked.launches = 0
mac_hc_insert.launches = 0
mac_tail_hc.launches = 0


# ---------------------------------------------------------------------------
# The halfcomplex streaming engine
# ---------------------------------------------------------------------------


class HcState(NamedTuple):
    """Packed halfcomplex streaming state: ring [P, 2C, Hp] (or IntPlanes),
    prev_block [C, N], blockcounter a host int."""

    ring: torch.Tensor
    prev_block: torch.Tensor
    blockcounter: int


def init_hc_state(spec: FilterSpec, n_channels: int, *, device) -> HcState:
    hp = _round_up(spec.n_fft // 2, 128)
    dt = getattr(torch, spec.dtype)
    return HcState(
        ring=torch.zeros((spec.n_partitions, 2 * n_channels, hp), dtype=dt,
                         device=device),
        prev_block=torch.zeros((n_channels, spec.block_length), dtype=dt,
                               device=device),
        blockcounter=0,
    )


def hc_coeffs(impulse, spec: FilterSpec, n_channels: int, scale: float = 1.0,
              precise: bool = False, shared: bool = False, *,
              device) -> torch.Tensor:
    """Partitioned coefficient spectra as packed halfcomplex planes
    [P, 2C, Hp], built on the host and moved to ``device`` once.

    ``shared``: one filter's planes [P, 2, Hp] for chains whose channels all
    carry the same filter (the MAC kernels read them for every channel).
    ``precise``: partition FFTs in float64, rounded once to the engine
    dtype; otherwise they run in the engine dtype, as the reference's."""
    n, p = spec.block_length, spec.n_partitions
    hp = _round_up(spec.n_fft // 2, 128)
    half = spec.n_fft // 2
    if shared:
        imp = np.asarray(impulse)
        if imp.ndim == 2 and imp.shape[0] > 1:
            imp = imp[:1]  # caller asserts all rows identical
        return hc_coeffs(imp, spec, 1, scale=scale, precise=precise,
                         device=device)
    dt = getattr(torch, spec.dtype)
    if precise:
        h = torch.from_numpy(np.asarray(impulse, dtype=np.float64) * float(scale))
    else:
        h = (torch.as_tensor(np.asarray(impulse), dtype=dt)
             * torch.tensor(scale, dtype=dt))
    if h.ndim == 1:
        h = h[None, :]
    c0, taps = h.shape
    if taps > n * p:
        h = h[:, : n * p]
    else:
        h = torch.nn.functional.pad(h, (0, n * p - taps))
    parts = h.reshape(c0, p, n).transpose(0, 1)
    cr, ci = F.rfft_split_hc(parts, n=spec.n_fft)
    cr = torch.nn.functional.pad(cr.to(dt), (0, hp - half))
    ci = torch.nn.functional.pad(ci.to(dt), (0, hp - half))
    if c0 != n_channels:
        cr = cr.expand(p, n_channels, hp)
        ci = ci.expand(p, n_channels, hp)
    return torch.cat([cr, ci], dim=1).to(device)


def _hc_frame_spectrum(state: HcState, block: torch.Tensor, hp: int):
    """rfft of the overlap-save frame [prev | block], packed [2C, Hp].
    Returns (new prev_block, packed spectrum); the new prev_block is a view
    of the frame, so it never aliases the caller's block."""
    n = block.shape[-1]
    frame = torch.cat([state.prev_block, block.to(state.prev_block.dtype)],
                      dim=-1)
    hr, hi = F.rfft_split_hc(frame)
    pad = hp - hr.shape[-1]
    xpk = torch.cat([torch.nn.functional.pad(hr, (0, pad)),
                     torch.nn.functional.pad(hi, (0, pad))], dim=0)
    return frame[:, n:], xpk


def step_hc(state: HcState, coeff_pk: torch.Tensor,
            block: torch.Tensor) -> Tuple[HcState, torch.Tensor]:
    """One streaming block on the halfcomplex representation: frame rfft,
    ring-slot insert (in place), K1 MAC, overlap-save tail."""
    p, _, hp = state.ring.shape
    n = block.shape[-1]
    prev, xpk = _hc_frame_spectrum(state, block, hp)
    pos = state.blockcounter % p
    state.ring[pos] = xpk
    yr, yi = mac_hc(state.ring, coeff_pk, pos)
    out = F.irfft_hc_tail(yr.to(prev.dtype), yi.to(prev.dtype), n=2 * n)
    return HcState(state.ring, prev, state.blockcounter + 1), out


def step_hc_crossfade(state: HcState, coeff_old: torch.Tensor,
                      coeff_new: torch.Tensor,
                      block: torch.Tensor) -> Tuple[HcState, torch.Tensor]:
    """Glitch-free filter-change block: one ring advance, two MACs, and a
    linear ramp old -> new over the block (fftw_convolver.cpp:275-321)."""
    p, _, hp = state.ring.shape
    n = block.shape[-1]
    prev, xpk = _hc_frame_spectrum(state, block, hp)
    pos = state.blockcounter % p
    state.ring[pos] = xpk
    yo = mac_hc(state.ring, coeff_old, pos)
    yn = mac_hc(state.ring, coeff_new, pos)
    out_old = F.irfft_hc_tail(yo[0].to(prev.dtype), yo[1].to(prev.dtype),
                              n=2 * n)
    out_new = F.irfft_hc_tail(yn[0].to(prev.dtype), yn[1].to(prev.dtype),
                              n=2 * n)
    ramp = torch.arange(n, dtype=out_old.dtype, device=out_old.device) / (n - 1)
    out = out_old * (1.0 - ramp) + out_new * ramp
    return HcState(state.ring, prev, state.blockcounter + 1), out


def step_hc2(state: HcState, coeff_pk: torch.Tensor,
             block: torch.Tensor) -> Tuple[HcState, torch.Tensor]:
    """``step_hc`` with the ring-slot insert inside the MAC kernel (K13):
    the same outputs and ring, one copy launch fewer per block."""
    p, _, hp = state.ring.shape
    n = block.shape[-1]
    prev, xpk = _hc_frame_spectrum(state, block, hp)
    pos = state.blockcounter % p
    yr, yi, ring = mac_hc_insert(state.ring, coeff_pk, xpk, pos)
    out = F.irfft_hc_tail(yr.to(prev.dtype), yi.to(prev.dtype), n=2 * n)
    return HcState(ring, prev, state.blockcounter + 1), out


@functools.lru_cache(maxsize=8)
def _tail_basis(n: int, hp: int, dtype: torch.dtype, device: torch.device):
    """The half-DFT tail basis of blocks of ``n`` (``F._hc_tail_weights``),
    zero-padded to [hp, hp], as ``dtype`` tensors on ``device``."""
    wr, wi = F._hc_tail_weights(2 * n, str(dtype).split(".")[-1])
    pad = ((0, hp - n), (0, hp - n))
    return (torch.from_numpy(np.pad(wr, pad)).to(device),
            torch.from_numpy(np.pad(wi, pad)).to(device))


def step_hc_fused(state: HcState, coeff_pk: torch.Tensor,
                  block: torch.Tensor) -> Tuple[HcState, torch.Tensor]:
    """One streaming block with the partition MAC and the overlap-save
    inverse in one kernel (K12): frame rfft, ring-slot insert (in place),
    K12. Outputs match ``step_hc``."""
    p, _, hp = state.ring.shape
    n = block.shape[-1]
    prev, xpk = _hc_frame_spectrum(state, block, hp)
    pos = state.blockcounter % p
    state.ring[pos] = xpk
    wr, wi = _tail_basis(n, hp, state.ring.dtype, state.ring.device)
    out = mac_tail_hc(state.ring, coeff_pk, wr, wi, pos)
    return (HcState(state.ring, prev, state.blockcounter + 1),
            out[..., :n].to(prev.dtype))


# ---------------------------------------------------------------------------
# The packed streaming engines (full-width split planes: K8, K10, K11)
# ---------------------------------------------------------------------------


class PackedState(NamedTuple):
    """Packed streaming state: ring [P, 2C, Fp] (re rows 0..C-1, im rows
    C..2C-1), prev_block [C, N], blockcounter a host int."""

    ring: torch.Tensor
    prev_block: torch.Tensor
    blockcounter: int


def init_packed_state(spec: FilterSpec, n_channels: int, *,
                      device) -> PackedState:
    fp = _round_up(spec.n_freq, 128)
    dt = getattr(torch, spec.dtype)
    return PackedState(
        ring=torch.zeros((spec.n_partitions, 2 * n_channels, fp), dtype=dt,
                         device=device),
        prev_block=torch.zeros((n_channels, spec.block_length), dtype=dt,
                               device=device),
        blockcounter=0,
    )


def split_coeffs(impulse, spec: FilterSpec, scale: float = 1.0, *, device):
    """Partition spectra as split planes (re, im), each [P, C, Fp], computed
    on the host in the engine dtype and moved to ``device``."""
    dt = getattr(torch, spec.dtype)
    h = (torch.as_tensor(np.asarray(impulse), dtype=dt)
         * torch.tensor(scale, dtype=dt))
    if h.ndim == 1:
        h = h[None, :]
    c, taps = h.shape
    n, p = spec.block_length, spec.n_partitions
    if taps > n * p:
        h = h[:, : n * p]
    else:
        h = torch.nn.functional.pad(h, (0, n * p - taps))
    parts = h.reshape(c, p, n).transpose(0, 1)
    cr, ci = F.rfft_split(parts, n=spec.n_fft)
    pad = _round_up(spec.n_freq, 128) - cr.shape[-1]
    return (torch.nn.functional.pad(cr, (0, pad)).to(device),
            torch.nn.functional.pad(ci, (0, pad)).to(device))


def pack_coeffs(impulse, spec: FilterSpec, n_channels: int,
                scale: float = 1.0, *, device) -> torch.Tensor:
    """``split_coeffs`` stacked to [P, 2C, Fp] (one filter broadcast to
    ``n_channels``)."""
    cr, ci = split_coeffs(impulse, spec, scale, device=device)
    p, c0, fp = cr.shape
    if c0 != n_channels:
        cr = cr.expand(p, n_channels, fp)
        ci = ci.expand(p, n_channels, fp)
    return torch.cat([cr, ci], dim=1)


def _packed_frame_spectrum(prev_block: torch.Tensor, block: torch.Tensor,
                           fp: int):
    """rfft of the overlap-save frame [prev | block], split planes stacked
    to [2C, Fp]. Returns (new prev_block, spectrum); the new prev_block is
    a view of the frame."""
    n = block.shape[-1]
    frame = torch.cat([prev_block, block.to(prev_block.dtype)], dim=-1)
    xr, xi = F.rfft_split(frame)
    pad = fp - (n + 1)
    return frame[:, n:], torch.cat([torch.nn.functional.pad(xr, (0, pad)),
                                    torch.nn.functional.pad(xi, (0, pad))],
                                   dim=0)


def _packed_advance(state: PackedState, block: torch.Tensor):
    """The frame's spectrum written into ring slot ``blockcounter % P`` in
    place. Returns (new prev_block, pos)."""
    p, _, fp = state.ring.shape
    prev, xpk = _packed_frame_spectrum(state.prev_block, block, fp)
    pos = state.blockcounter % p
    state.ring[pos] = xpk
    return prev, pos


def _split_tail(yr, yi, n: int, dtype) -> torch.Tensor:
    """The overlap-save tail of the inverse of the N + 1 bins of (yr, yi)."""
    f = n + 1
    return F.irfft_split(yr[..., :f].to(dtype), yi[..., :f].to(dtype),
                         n=2 * n)[..., n:]


def _packed_mac_tail(ring, coeff_pk, pos: int, n: int, dtype) -> torch.Tensor:
    """K8 over the N + 1 live bins, then the overlap-save tail of the
    inverse."""
    return _split_tail(*mac_packed(ring, coeff_pk, pos, n + 1), n, dtype)


def step_packed(state: PackedState, coeff_pk: torch.Tensor,
                block: torch.Tensor) -> Tuple[PackedState, torch.Tensor]:
    """One streaming block on the packed representation: frame rfft, ring
    insert (in place), K8 MAC, overlap-save tail."""
    prev, pos = _packed_advance(state, block)
    out = _packed_mac_tail(state.ring, coeff_pk, pos, block.shape[-1],
                           prev.dtype)
    return PackedState(state.ring, prev, state.blockcounter + 1), out


def step_packed_crossfade(state: PackedState, coeff_old: torch.Tensor,
                          coeff_new: torch.Tensor, block: torch.Tensor
                          ) -> Tuple[PackedState, torch.Tensor]:
    """A filter-change block on the packed engine: one ring advance, two K8
    MACs (old and new coefficients) and a linear ramp old -> new over the
    block (fftw_convolver.cpp:275-321)."""
    n = block.shape[-1]
    prev, pos = _packed_advance(state, block)
    out_old = _packed_mac_tail(state.ring, coeff_old, pos, n, prev.dtype)
    out_new = _packed_mac_tail(state.ring, coeff_new, pos, n, prev.dtype)
    ramp = torch.arange(n, dtype=out_old.dtype, device=out_old.device) / (n - 1)
    out = out_old * (1.0 - ramp) + out_new * ramp
    return PackedState(state.ring, prev, state.blockcounter + 1), out


class DoubledState(NamedTuple):
    """Packed state with the ring doubled: ring2 [2P, 2C, Fp], slot s
    mirrored at s + P, so that K10 reads any run of delayed slots without
    a wrap; prev_block [C, N], blockcounter a host int."""

    ring2: torch.Tensor
    prev_block: torch.Tensor
    blockcounter: int


def init_doubled_state(spec: FilterSpec, n_channels: int, *,
                       device) -> DoubledState:
    st = init_packed_state(spec, n_channels, device=device)
    return DoubledState(ring2=st.ring.repeat(2, 1, 1),
                        prev_block=st.prev_block, blockcounter=0)


def chunk_reverse_coeffs(coeff_pk: torch.Tensor, k: int) -> torch.Tensor:
    """Packed coefficients [P, 2C, Fp] with the partition order reversed
    inside each chunk of ``k`` (the layout K10 reads; ``k`` divides P)."""
    p, c2, fp = coeff_pk.shape
    _check_chunk(p, k)
    return coeff_pk.reshape(p // k, k, c2, fp).flip(1).reshape(p, c2, fp)


def step_chunked(state: DoubledState, coeff_rk: torch.Tensor,
                 block: torch.Tensor,
                 k: int = 4) -> Tuple[DoubledState, torch.Tensor]:
    """One streaming block on the doubled ring (coefficients from
    ``chunk_reverse_coeffs(pack_coeffs(...), k)``): frame rfft, the slot
    written at pos and at pos + P (one copy, in place), K10 over the N + 1
    live bins, overlap-save tail. Outputs match ``step_packed``."""
    p2, _, fp = state.ring2.shape
    p = p2 // 2
    n = block.shape[-1]
    prev, xpk = _packed_frame_spectrum(state.prev_block, block, fp)
    pos = state.blockcounter % p
    state.ring2[pos::p] = xpk  # slots pos and pos + P
    out = _split_tail(*mac_chunked(state.ring2, coeff_rk, pos, n + 1, k), n,
                      prev.dtype)
    return DoubledState(state.ring2, prev, state.blockcounter + 1), out


class SplitState(NamedTuple):
    """Streaming state in four-plane form: ring_re and ring_im [P, C, Fp],
    prev_block [C, N], blockcounter a host int."""

    ring_re: torch.Tensor
    ring_im: torch.Tensor
    prev_block: torch.Tensor
    blockcounter: int


def init_split_state(spec: FilterSpec, n_channels: int, *,
                     device) -> SplitState:
    fp = _round_up(spec.n_freq, 128)
    dt = getattr(torch, spec.dtype)
    shape = (spec.n_partitions, n_channels, fp)
    return SplitState(
        ring_re=torch.zeros(shape, dtype=dt, device=device),
        ring_im=torch.zeros(shape, dtype=dt, device=device),
        prev_block=torch.zeros((n_channels, spec.block_length), dtype=dt,
                               device=device),
        blockcounter=0,
    )


def step_split(state: SplitState, coeff_re: torch.Tensor,
               coeff_im: torch.Tensor,
               block: torch.Tensor) -> Tuple[SplitState, torch.Tensor]:
    """One streaming block on four planes (coefficients from
    ``split_coeffs``): frame rfft, ring inserts (in place), K11 over the
    N + 1 live bins, overlap-save tail. Shared coefficients [P, 1, Fp] are
    materialised per channel, as the reference does: K11 reads contiguous
    per-channel planes."""
    p, c, fp = state.ring_re.shape
    n = block.shape[-1]
    if coeff_re.shape[1] != c:
        coeff_re = coeff_re.expand(p, c, fp).contiguous()
        coeff_im = coeff_im.expand(p, c, fp).contiguous()
    prev, xpk = _packed_frame_spectrum(state.prev_block, block, fp)
    pos = state.blockcounter % p
    state.ring_re[pos] = xpk[:c]
    state.ring_im[pos] = xpk[c:]
    out = _split_tail(*mac_split(state.ring_re, state.ring_im, coeff_re,
                                 coeff_im, pos, n + 1), n, prev.dtype)
    return (SplitState(state.ring_re, state.ring_im, prev,
                       state.blockcounter + 1), out)
