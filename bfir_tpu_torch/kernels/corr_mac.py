"""Correlation MAC of the G-cycle batched bulk scan (K7).

Counterpart of ``bfir_tpu/kernels/corr_mac.py``. For an ordered
(newest-last) spectrum history ``hist`` [P-1+B, 2C, Hp] and coefficient
planes ``coeff`` [P, 2cs, Hp] (cs = C, or 1 for one shared filter), the B
batched halfcomplex MACs

    out[b] = sum_q coeff[q] (*) hist[P-1+b-q],   b = 0..B-1

with the lane-0 law of ``spectrum_mac.mac_reference_hc`` (DC.re and
Nyquist.re are two real products) at global lane 0. The wrapper takes the
plain version for CPU tensors and launches ``csrc/corr_mac.cu`` for CUDA
tensors (or raises), counting launches in ``corr_mac.launches``. The
launch follows ``corr_mac_plan``: the kernel's variant for the call's
shape, its work items and its persistent grid.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from bfir_tpu_torch.kernels import cuda_lib

_QW = 16  # taps held in registers: kQW in csrc/corr_mac.cu
# (consumer threads, lanes a thread, ring stages): kVariants in
# csrc/corr_mac.cu, by index
_VARIANTS = ((64, 2, 16), (128, 2, 16))


def corr_mac_plain(hist: torch.Tensor, coeff: torch.Tensor,
                   nblocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7 (``core/nubatch._corr_mac`` of the reference):
    P shifted elementwise products, accumulated in the history's type
    (float32 for bf16)."""
    p = coeff.shape[0]
    cs = coeff.shape[1] // 2
    c = hist.shape[1] // 2
    acc = torch.float32 if hist.dtype == torch.bfloat16 else hist.dtype
    ar = torch.zeros((nblocks, c, hist.shape[2]), dtype=acc,
                     device=hist.device)
    ai = torch.zeros_like(ar)
    for q in range(p):
        w = hist[p - 1 - q:p - 1 - q + nblocks].to(acc)
        wr, wi = w[:, :c], w[:, c:]
        cr = coeff[q, :cs].to(acc)
        ci = coeff[q, cs:].to(acc)
        p1 = cr * wr
        p2 = ci * wi
        dr = p1 - p2
        di = cr * wi + ci * wr
        dr[..., 0] = p1[..., 0]  # (DC.re, Nyquist.re): two real products
        di[..., 0] = p2[..., 0]
        ar += dr
        ai += di
    return ar, ai


def _variant(hp: int) -> int:
    """The launch variant for a call shape: 128-lane tiles up to Hp =
    2048, 256-lane tiles above, the fastest at the flagship's head (Hp =
    1024) and tail (Hp = 8192) calls on the H100 (PERF.md, section 6)."""
    return 0 if hp <= 2048 else 1


class CorrPlan(NamedTuple):
    """How one K7 call is cut: the variant, the lane tile (its threads x
    lanes a thread), the b range of an item and the number of such ranges,
    the work items (channels x lane tiles x ranges) and the grid; and the
    bytes the ring streams in all against the bytes of the inputs read
    once (what a split or Cs = 1 reads again, from L2 or device memory)."""
    variant: int
    tile: int
    b_chunk: int
    nsplit: int
    items: int
    grid: int
    streamed: int
    inputs: int


def corr_mac_plan(p: int, nblocks: int, c: int, cs: int, hp: int,
                  h_size: int, c_size: int, per_sm: int, sms: int,
                  variant: int = None) -> CorrPlan:
    """K7's plan for hist [P-1+B, 2C, Hp] and coeff [P, 2cs, Hp] of
    ``h_size`` / ``c_size`` bytes an element, on a device that holds
    ``per_sm`` blocks of the variant on each of its ``sms`` SMs. B is
    split in halves (whole multiples of the register window) only while
    the items leave SMs idle; the grid is occupancy x SMs, capped at the
    items. Raises ValueError where a row is not a whole number of 16-byte
    chunks (the unit of the kernel's copies) or the device fits no
    block."""
    for size in (h_size, c_size):
        if hp < 4 or hp * size % 16:
            raise ValueError(f"Hp {hp} of {size}-byte elements is not a "
                             "whole number of 16-byte chunks")
    if per_sm < 1:
        raise ValueError("the device fits no block of corr_mac")
    variant = _variant(hp) if variant is None else variant
    threads, lanes, _ = _VARIANTS[variant]
    tile = threads * lanes
    tiles = -(-hp // tile)
    b_chunk = -(-nblocks // _QW) * _QW
    while b_chunk > _QW and c * tiles * -(-nblocks // b_chunk) < sms:
        b_chunk = -(-b_chunk // (2 * _QW)) * _QW
    nsplit = -(-nblocks // b_chunk)
    items = c * tiles * nsplit
    rows = 0  # history rows the ring streams for one channel's lanes
    for b0 in range(0, nblocks, b_chunk):
        b1 = min(nblocks, b0 + b_chunk)
        for q0 in range(0, p, _QW):
            base = p - 1 - q0
            rows += base + b1 - max(0, base + b0 - _QW + 1)
    streamed = c * 2 * hp * (rows * h_size + nsplit * p * c_size)
    inputs = 2 * hp * ((p - 1 + nblocks) * c * h_size + p * cs * c_size)
    return CorrPlan(variant, tile, b_chunk, nsplit, items,
                    min(items, per_sm * sms), streamed, inputs)


@functools.lru_cache(maxsize=None)
def _occupancy(device: torch.device, variant: int, h_kind: int,
               c_kind: int) -> Tuple[int, int]:
    """(blocks of the variant on one SM, SMs) of a CUDA device."""
    per_sm, sms = ctypes.c_int(), ctypes.c_int()
    lib = cuda_lib.load()
    with torch.cuda.device(device):
        err = lib.bfir_corr_mac_occupancy(variant, h_kind, c_kind,
                                          ctypes.byref(per_sm),
                                          ctypes.byref(sms))
    cuda_lib.check(err, "corr_mac occupancy")
    return per_sm.value, sms.value


def plan_for(hist: torch.Tensor, coeff: torch.Tensor,
             nblocks: int) -> CorrPlan:
    """``corr_mac_plan`` for CUDA tensors on their device."""
    kinds = (torch.float32, torch.bfloat16)
    p, c, cs, hp = (coeff.shape[0], hist.shape[1] // 2, coeff.shape[1] // 2,
                    hist.shape[2])
    variant = _variant(hp)
    per_sm, sms = _occupancy(hist.device, variant, kinds.index(hist.dtype),
                             kinds.index(coeff.dtype))
    return corr_mac_plan(p, nblocks, c, cs, hp, hist.element_size(),
                         coeff.element_size(), per_sm, sms, variant)


def corr_mac(hist: torch.Tensor, coeff: torch.Tensor,
             nblocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: (yr, yi) [nblocks, C, Hp] float32 from ``hist`` [P-1+nblocks,
    2C, Hp] and ``coeff`` [P, 2C | 2, Hp], float32 or bf16 storage.
    Replaces ``corr_mac.corr_mac_pallas``."""
    h, c2, hp = hist.shape
    p, gc2, ghp = coeff.shape
    if h != p - 1 + nblocks:
        raise ValueError(f"hist rows {h} != P-1+B = {p - 1 + nblocks}")
    c, cs = c2 // 2, gc2 // 2
    if c2 % 2 or gc2 % 2 or ghp != hp or cs not in (1, c):
        raise ValueError(f"hist [{h}, {c2}, {hp}] and coefficients "
                         f"[{p}, {gc2}, {ghp}] do not pair")
    if hist.device.type == "cpu":
        return corr_mac_plain(hist, coeff, nblocks)
    dev = hist.device
    kinds = (torch.float32, torch.bfloat16)
    cuda_lib.require_cuda(hist, "hist", kinds, dev)
    cuda_lib.require_cuda(coeff, "coeff", kinds, dev)
    plan = plan_for(hist, coeff, nblocks)
    yr = torch.empty((nblocks, c, hp), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        err = lib.bfir_corr_mac(
            hist.data_ptr(), kinds.index(hist.dtype), coeff.data_ptr(),
            kinds.index(coeff.dtype), yr.data_ptr(), yi.data_ptr(), p,
            nblocks, c, cs, hp, plan.variant, plan.b_chunk, plan.grid,
            cuda_lib.stream_of(yr))
    cuda_lib.check(err, "corr_mac")
    corr_mac.launches += 1
    return yr, yi


corr_mac.launches = 0
