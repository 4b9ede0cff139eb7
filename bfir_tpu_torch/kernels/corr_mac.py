"""Correlation MAC of the G-cycle batched bulk scan (K7).

Counterpart of ``bfir_tpu/kernels/corr_mac.py``. For an ordered
(newest-last) spectrum history ``hist`` [P-1+B, 2C, Hp] and coefficient
planes ``coeff`` [P, 2cs, Hp] (cs = C, or 1 for one shared filter), the B
batched halfcomplex MACs

    out[b] = sum_q coeff[q] (*) hist[P-1+b-q],   b = 0..B-1

with the lane-0 law of ``spectrum_mac.mac_reference_hc`` (DC.re and
Nyquist.re are two real products) at global lane 0. The wrapper takes the
plain version for CPU tensors and launches ``csrc/corr_mac.cu`` for CUDA
tensors (or raises), counting launches in ``corr_mac.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bfir_tpu_torch.kernels import cuda_lib

_QC = 16  # coefficients per register chunk in csrc/corr_mac.cu
_MIN_BLOCKS = 4 * 132  # aim for four blocks of 128 threads per H100 SM


def corr_mac_plain(hist: torch.Tensor, coeff: torch.Tensor,
                   nblocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7 (``core/nubatch._corr_mac`` of the reference):
    P shifted elementwise products, accumulated in float32."""
    p = coeff.shape[0]
    cs = coeff.shape[1] // 2
    c = hist.shape[1] // 2
    ar = torch.zeros((nblocks, c, hist.shape[2]), dtype=torch.float32,
                     device=hist.device)
    ai = torch.zeros_like(ar)
    for q in range(p):
        w = hist[p - 1 - q:p - 1 - q + nblocks].to(torch.float32)
        wr, wi = w[:, :c], w[:, c:]
        cr = coeff[q, :cs].to(torch.float32)
        ci = coeff[q, cs:].to(torch.float32)
        p1 = cr * wr
        p2 = ci * wi
        dr = p1 - p2
        di = cr * wi + ci * wr
        dr[..., 0] = p1[..., 0]  # (DC.re, Nyquist.re): two real products
        di[..., 0] = p2[..., 0]
        ar += dr
        ai += di
    return ar, ai


def _b_chunk(b: int, lane_blocks: int) -> int:
    """b range of one grid z slice: all of B unless the lane x channel grid
    leaves SMs idle, then halves down to 32 (each split re-reads QC-1
    history rows); a multiple of QC."""
    chunk = -(-b // _QC) * _QC
    while chunk >= 4 * _QC and lane_blocks * -(-b // chunk) < _MIN_BLOCKS:
        chunk //= 2
    return chunk


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
    if hp % 2:
        raise ValueError(f"Hp {hp} must be even")
    yr = torch.empty((nblocks, c, hp), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    lane_blocks = -(-hp // 256) * c
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        err = lib.bfir_corr_mac(
            hist.data_ptr(), kinds.index(hist.dtype), coeff.data_ptr(),
            kinds.index(coeff.dtype), yr.data_ptr(), yi.data_ptr(), p,
            nblocks, c, cs, hp, _b_chunk(nblocks, lane_blocks),
            cuda_lib.stream_of(yr))
    cuda_lib.check(err, "corr_mac")
    corr_mac.launches += 1
    return yr, yi


corr_mac.launches = 0
