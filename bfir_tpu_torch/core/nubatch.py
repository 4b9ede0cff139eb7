"""G-cycle batched (bulk/offline) formulation of the two-stage engine.

Counterpart of ``bfir_tpu/core/nubatch.py``. Each iteration consumes G
whole M-cycles (G*R N-blocks) and runs every stage as one batched call:

- all G*R head forward transforms as one [G*R*C, 2N] ``rfft_split_hc``;
- the head MAC as a correlation along the block axis against an ordered
  spectrum history (K7, ``kernels.corr_mac``), the [p_head, 2C, Hp]
  coefficient planes read once per G*R blocks instead of once per block;
- the tail the same way across the G M-cycles: one [G*C, 2M] forward, a
  p_tail-tap correlation (K7) along the cycle axis, one batched inverse
  (K4 where ``nonuniform._tail_inverse`` takes it).

The arithmetic is that of R*G calls of ``step_nu`` from phase 0, so
outputs match ``process_blocks_nu_fast`` to float32 rounding.
``nu_to_gbatch`` / ``gbatch_to_nu`` reorder the rings into newest-last
histories (a roll) at M-cycle boundaries, so the bulk scan and the
per-block step interchange. Float plane storage only (float32 / bf16).
``counter`` is a host int.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from bfir_tpu_torch.core.nonuniform import (NuCoeffs, NuState,
                                            _tail_inverse)
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.kernels.corr_mac import corr_mac
from bfir_tpu_torch.ops import fft as F


class NuGBatchState(NamedTuple):
    """Bulk-scan carry: ordered (newest-last) spectrum histories instead of
    position-indexed rings."""

    head_hist: torch.Tensor  # [p_head-1, 2C, Hp]
    prev_block: torch.Tensor  # [C, N]
    tail_hist: torch.Tensor  # [p_tail-1, 2C, Hpt]
    prev_mblock: torch.Tensor  # [C, M]
    pending: torch.Tensor  # [D, C, M] tail outputs awaiting consumption
    counter: int  # N-blocks processed


def _require_float(coeffs: NuCoeffs, state: NuState):
    for plane in (coeffs.head, coeffs.tail, state.head.ring,
                  state.tail.ring):
        if isinstance(plane, K.IntPlanes):
            raise ValueError(
                "the G-batched bulk scan supports float plane storage only "
                "(int16/int24 tiers keep process_blocks_nu_fast)")


def nu_to_gbatch(state: NuState) -> NuGBatchState:
    """Reorder ring slots (slot = blockcounter mod P) into newest-last
    histories; valid at any M-cycle boundary. hist[j] holds block
    counter-(P-1)+j, whose slot is (counter+1+j) mod P."""
    h, t = state.head, state.tail
    p_h, p_t = h.ring.shape[0], t.ring.shape[0]
    head_hist = torch.roll(h.ring, -(h.blockcounter + 1), 0)[:p_h - 1]
    tail_hist = torch.roll(t.ring, -(t.blockcounter + 1), 0)[:p_t - 1]
    return NuGBatchState(head_hist=head_hist, prev_block=h.prev_block,
                         tail_hist=tail_hist, prev_mblock=state.inbuf,
                         pending=state.pending, counter=h.blockcounter)


def gbatch_to_nu(gb: NuGBatchState) -> NuState:
    """Inverse of ``nu_to_gbatch``: scatter the histories back into
    position-indexed rings (the slot about to be overwritten is zero; the
    per-block step never reads it before inserting)."""
    ratio = gb.prev_mblock.shape[-1] // gb.prev_block.shape[-1]
    mcounter = gb.counter // ratio

    def ring(hist, counter):
        zero = torch.zeros_like(hist[:1])
        return torch.roll(torch.cat([zero, hist]), counter, 0)

    return NuState(
        head=K.HcState(ring(gb.head_hist, gb.counter), gb.prev_block,
                       gb.counter),
        tail=K.HcState(ring(gb.tail_hist, mcounter), gb.prev_mblock,
                       mcounter),
        inbuf=gb.prev_mblock.clone(),  # steps fill inbuf in place
        pending=gb.pending,
    )


def _batch_spectrum(blocks, prev, hp: int) -> torch.Tensor:
    """Batched overlap-save forward: blocks [B, C, W] after the carried
    previous block -> packed halfcomplex spectra [B, 2C, hp] (one
    [B*C, 2W] transform)."""
    b, c, w = blocks.shape
    xprev = torch.cat([prev[None].to(blocks.dtype), blocks[:-1]], dim=0)
    frames = torch.cat([xprev, blocks], dim=-1).reshape(b * c, 2 * w)
    hr, hi = F.rfft_split_hc(frames)
    pad = hp - hr.shape[-1]
    hr = torch.nn.functional.pad(hr, (0, pad)).reshape(b, c, hp)
    hi = torch.nn.functional.pad(hi, (0, pad)).reshape(b, c, hp)
    return torch.cat([hr, hi], dim=1)


def step_nu_gbatch(gb: NuGBatchState, coeffs: NuCoeffs, blocks: torch.Tensor,
                   ratio: int) -> Tuple[NuGBatchState, torch.Tensor]:
    """G*R N-blocks ([GR, C, N], M-cycle aligned) in one batched pass ->
    (state, outputs [GR, C, N])."""
    gr, c, n = blocks.shape
    if gr % ratio:
        raise ValueError(f"block count {gr} not a multiple of R={ratio}")
    g = gr // ratio
    m = gb.prev_mblock.shape[-1]
    hp_h = gb.head_hist.shape[-1]
    hp_t = gb.tail_hist.shape[-1]
    blocks = blocks.to(gb.prev_block.dtype)

    # head: one forward, one correlation MAC (K7), one inverse
    xpk = _batch_spectrum(blocks, gb.prev_block, hp_h)
    fh = torch.cat([gb.head_hist.to(xpk.dtype), xpk], dim=0)
    ar, ai = corr_mac(fh, coeffs.head, gr)
    y_head = F.irfft_hc_tail(ar.reshape(gr * c, hp_h).to(blocks.dtype),
                             ai.reshape(gr * c, hp_h).to(blocks.dtype),
                             n=2 * n).reshape(gr, c, n)

    # tail: the same schedule across the G M-cycles
    mblocks = (blocks.reshape(g, ratio, c, n).transpose(1, 2)
               .reshape(g, c, m))
    txpk = _batch_spectrum(mblocks, gb.prev_mblock, hp_t)
    th = torch.cat([gb.tail_hist.to(txpk.dtype), txpk], dim=0)
    br, bi = corr_mac(th, coeffs.tail, g)
    z = _tail_inverse(br.reshape(g * c, hp_t).to(blocks.dtype),
                      bi.reshape(g * c, hp_t).to(blocks.dtype),
                      m).reshape(g, c, m)

    # cycle j consumes the tail output queued for it
    d = gb.pending.shape[0]
    queue = torch.cat([gb.pending, z.to(gb.pending.dtype)], dim=0)
    zfeed = queue[:g]  # [G, C, M]
    outs = (y_head.reshape(g, ratio, c, n)
            + zfeed.reshape(g, c, ratio, n).transpose(1, 2))

    gb2 = NuGBatchState(
        head_hist=fh[fh.shape[0] - gb.head_hist.shape[0]:].to(
            gb.head_hist.dtype),
        prev_block=blocks[-1],
        tail_hist=th[th.shape[0] - gb.tail_hist.shape[0]:].to(
            gb.tail_hist.dtype),
        prev_mblock=mblocks[-1],
        pending=queue[g:g + d],
        counter=gb.counter + gr,
    )
    return gb2, outs.reshape(gr, c, n)


def process_blocks_nu_gbatch(state: NuState, coeffs: NuCoeffs,
                             blocks: torch.Tensor, cycles_per_step: int = 4
                             ) -> Tuple[NuState, torch.Tensor]:
    """Bulk path: ``step_nu_gbatch`` over iterations of G =
    ``cycles_per_step`` M-cycles. ``blocks`` [B, C, N] with B a multiple of
    G*R and ``state`` at an M-cycle boundary. Returns (NuState, out),
    interchangeable with the per-block engines."""
    b, c, n = blocks.shape
    ratio = state.inbuf.shape[-1] // n
    gr = cycles_per_step * ratio
    if b % gr:
        raise ValueError(
            f"block count {b} not a multiple of G*R={gr} "
            f"(G={cycles_per_step}, R={ratio})")
    if state.head.blockcounter % ratio:
        raise ValueError("process_blocks_nu_gbatch needs the state at an "
                         "M-cycle boundary, got blockcounter "
                         f"{state.head.blockcounter}")
    _require_float(coeffs, state)
    gb = nu_to_gbatch(state)
    outs = []
    for chunk in blocks.reshape(b // gr, gr, c, n):
        gb, y = step_nu_gbatch(gb, coeffs, chunk, ratio)
        outs.append(y)
    return gbatch_to_nu(gb), torch.cat(outs)
