"""Partitioned overlap-save FFT convolution: the uniform ``complex`` engine.

Counterpart of ``bfir_tpu/core/convolver.py`` (brutefir.cpp:244-343): each
N-block forms the 2N frame [previous block | block], its spectrum goes into
a ring of the last P spectra (slot ``blockcounter % P``), the MAC sums
``coeff[p] * ring[(blockcounter - p) mod P]`` over partitions, and the upper
half of the inverse is the output. ``irfft`` carries the 1/n scale.

``blockcounter`` is a host int and the ring insert updates the ring in
place: a state passed to ``step`` must not be used again.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from bfir_tpu_torch.core.spec import FilterSpec
from bfir_tpu_torch.ops import fft as F


class ConvolverState(NamedTuple):
    """spectra_ring [P, C, F] complex (slot ``blockcounter % P`` holds the
    newest spectrum), prev_block [C, N] real, blockcounter a host int."""

    spectra_ring: torch.Tensor
    prev_block: torch.Tensor
    blockcounter: int


def init_state(spec: FilterSpec, n_channels: int, *, device) -> ConvolverState:
    """Fresh zeroed state (reference reset(), brutefir.cpp:345-367): cold
    partitions contribute exactly zero."""
    rdt = getattr(torch, spec.dtype)
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    return ConvolverState(
        spectra_ring=torch.zeros((spec.n_partitions, n_channels, spec.n_freq),
                                 dtype=cdt, device=device),
        prev_block=torch.zeros((n_channels, spec.block_length), dtype=rdt,
                               device=device),
        blockcounter=0,
    )


def coeffs_to_spectra(impulse, spec: FilterSpec, scale: float = 1.0, *,
                      device) -> torch.Tensor:
    """Per-partition spectra [P, C, F] of an impulse [taps] or [C, taps]
    (each N-tap slice zero-padded to 2N; taps beyond P*N are dropped),
    computed on the host in the engine dtype and moved to ``device``."""
    dt = getattr(torch, spec.dtype)
    h = torch.as_tensor(np.asarray(impulse), dtype=dt) * torch.tensor(scale, dtype=dt)
    if h.ndim == 1:
        h = h[None, :]
    c, taps = h.shape
    n, p = spec.block_length, spec.n_partitions
    if taps > n * p:
        h = h[:, : n * p]
    else:
        h = torch.nn.functional.pad(h, (0, n * p - taps))
    parts = h.reshape(c, p, n).transpose(0, 1)
    return F.rfft(parts, n=spec.n_fft).to(device)


def spectra_to_impulse(coeff_spectra: torch.Tensor,
                       spec: FilterSpec) -> torch.Tensor:
    """Invert per-partition coefficient spectra [P, C, F] back to the
    time-domain impulse [C, P * N], on their device: the reference's debug
    facility ``convolver_debug_dump_cbuf`` (fftw_convolver.cpp:604-651).
    The inverse of ``coeffs_to_spectra`` to float rounding."""
    parts = F.irfft(coeff_spectra, n=spec.n_fft)[..., : spec.block_length]
    p, c, n = parts.shape
    return parts.transpose(0, 1).reshape(c, p * n)


def _advance(state: ConvolverState, block: torch.Tensor):
    """Frame spectrum into the ring (in place); returns (ring, prev, pos)."""
    n = block.shape[-1]
    frame = torch.cat([state.prev_block, block.to(state.prev_block.dtype)],
                      dim=-1)
    ring = state.spectra_ring
    pos = state.blockcounter % ring.shape[0]
    ring[pos] = F.rfft(frame)
    return ring, frame[:, n:], pos


def _mac_inverse(ring: torch.Tensor, coeff_spectra: torch.Tensor, pos: int,
                 n: int) -> torch.Tensor:
    p = ring.shape[0]
    idx = torch.remainder(pos - torch.arange(p), p).to(ring.device)
    y = (coeff_spectra * ring.index_select(0, idx)).sum(dim=0)
    return F.irfft(y)[..., n:]


def step(state: ConvolverState, coeff_spectra: torch.Tensor,
         block: torch.Tensor) -> Tuple[ConvolverState, torch.Tensor]:
    """One N-block through the partitioned convolver (one brutefir::run).
    coeff_spectra: [P, C | 1, F] complex; block: [C, N]."""
    n = block.shape[-1]
    ring, prev, pos = _advance(state, block)
    out = _mac_inverse(ring, coeff_spectra, pos, n)
    return ConvolverState(ring, prev, state.blockcounter + 1), out


def step_rolled(state: ConvolverState, coeff_spectra: torch.Tensor,
                block: torch.Tensor) -> Tuple[ConvolverState, torch.Tensor]:
    """``step`` on the *rolled* ring: ``ring[i]`` holds the spectrum of the
    block i blocks ago (newest at 0), so the MAC is an aligned product
    with no gather, and a ring split over partitions advances by passing
    each piece's oldest slot to the next (``parallel.sharded``). The ring
    is rebuilt out of place. Same outputs as ``step``."""
    n = block.shape[-1]
    frame = torch.cat([state.prev_block, block.to(state.prev_block.dtype)],
                      dim=-1)
    ring = torch.cat([F.rfft(frame)[None], state.spectra_ring[:-1]], dim=0)
    out = F.irfft((coeff_spectra * ring).sum(dim=0))[..., n:]
    return ConvolverState(ring, frame[:, n:], state.blockcounter + 1), out


def _unroll_index(state: ConvolverState) -> torch.Tensor:
    p = state.spectra_ring.shape[0]
    idx = torch.remainder(state.blockcounter - 1 - torch.arange(p), p)
    return idx.to(state.spectra_ring.device)


def rolled_from_state(state: ConvolverState) -> ConvolverState:
    """Pointer ring (``step``) -> rolled ring (``step_rolled``):
    rolled[i] = ring[(blockcounter - 1 - i) mod P]."""
    return state._replace(spectra_ring=state.spectra_ring.index_select(
        0, _unroll_index(state)))


def state_from_rolled(state: ConvolverState) -> ConvolverState:
    """Inverse of ``rolled_from_state`` (the same permutation, an
    involution): ring[s] = rolled[(blockcounter - 1 - s) mod P]."""
    return rolled_from_state(state)


def step_crossfade(state: ConvolverState, coeff_old: torch.Tensor,
                   coeff_new: torch.Tensor,
                   block: torch.Tensor) -> Tuple[ConvolverState, torch.Tensor]:
    """One block during a filter change: both coefficient sets, linearly
    crossfaded over the block (convolver_crossfade_inplace,
    fftw_convolver.cpp:275-321)."""
    n = block.shape[-1]
    ring, prev, pos = _advance(state, block)
    out_old = _mac_inverse(ring, coeff_old, pos, n)
    out_new = _mac_inverse(ring, coeff_new, pos, n)
    ramp = torch.arange(n, dtype=out_old.dtype, device=out_old.device) / (n - 1)
    out = out_old * (1.0 - ramp) + out_new * ramp
    return ConvolverState(ring, prev, state.blockcounter + 1), out


def process_blocks(state: ConvolverState, coeff_spectra: torch.Tensor,
                   blocks: torch.Tensor) -> Tuple[ConvolverState, torch.Tensor]:
    """``step`` over blocks [B, C, N] -> (state, out [B, C, N])."""
    outs = []
    for blk in blocks:
        state, y = step(state, coeff_spectra, blk)
        outs.append(y)
    return state, torch.stack(outs)


def batch_fft_len(b: int, p: int) -> int:
    """Block-axis FFT length for a B-block batch with P partitions."""
    return int(2 ** np.ceil(np.log2(max(b + 2 * (p - 1), 2))))


def prepare_batch_coeffs(coeff_spectra: torch.Tensor, b: int) -> torch.Tensor:
    """The block-axis FFT of the coefficient spectra for ``process_batch``
    at batch size ``b`` ([L, C, F] complex): static per filter, so it is
    computed once, not per batch."""
    p = coeff_spectra.shape[0]
    return torch.fft.fft(coeff_spectra, n=batch_fft_len(b, p), dim=0)


def process_batch(state: ConvolverState, coeff_spectra: torch.Tensor,
                  blocks: torch.Tensor,
                  coeff_batch_fft: Optional[torch.Tensor] = None
                  ) -> Tuple[ConvolverState, torch.Tensor]:
    """Batched processing of ``blocks`` [B, C, N], the offline engine of
    short filters. Same outputs as ``process_blocks`` to float rounding:
    all B block FFTs run as one batch, and the partition MAC, a causal
    convolution along the block index (Y[b] = sum_p H[p] X[b-p]), runs as
    a second FFT over the block axis. Pass ``coeff_batch_fft =
    prepare_batch_coeffs(coeff_spectra, B)`` to reuse the coefficients'
    block-axis transform. The ring is updated in place."""
    p = coeff_spectra.shape[0]
    b, c, n = blocks.shape
    blocks = blocks.to(state.prev_block.dtype)
    ring = state.spectra_ring

    # overlapped 2N frames: frame[i] = [block_{i-1} | block_i]
    prev = torch.cat([state.prev_block[None], blocks[:-1]], dim=0)
    x = F.rfft(torch.cat([prev, blocks], dim=-1))  # [B, C, F]

    # history: spectra of blocks counter-(P-1) .. counter-1, oldest first,
    # so xpad[k] is the spectrum of block counter-(P-1)+k
    k = torch.arange(p - 1, 0, -1)
    hist_idx = torch.remainder(state.blockcounter - k, p).to(ring.device)
    xpad = torch.cat([ring.index_select(0, hist_idx), x], dim=0)

    # causal convolution along the block axis, zero-padded to L so the
    # history's tail does not wrap
    l = batch_fft_len(b, p)
    hs = coeff_batch_fft
    if hs is None or hs.shape[0] != l:
        hs = torch.fft.fft(coeff_spectra, n=l, dim=0)
    y = torch.fft.ifft(torch.fft.fft(xpad, n=l, dim=0) * hs, dim=0)
    out = F.irfft(y[p - 1:p - 1 + b])[..., n:]  # [B, C, N]

    # the last P spectra of xpad go to their ring slots
    last = xpad[-p:]
    first = state.blockcounter + b - last.shape[0]
    slots = torch.remainder(torch.arange(first, first + last.shape[0]), p)
    ring[slots.to(ring.device)] = last
    return ConvolverState(ring, blocks[-1], state.blockcounter + b), out


def direct_convolve_spectra(impulse_a, impulse_b,
                            max_taps: Optional[int] = None,
                            dtype=torch.float64) -> torch.Tensor:
    """Compose two impulses by one full-length FFT convolution (what the
    reference's block-wise preprocessor.cpp:33-233 computes)."""
    a = torch.as_tensor(np.asarray(impulse_a), dtype=dtype)
    b = torch.as_tensor(np.asarray(impulse_b), dtype=dtype)
    out_len = a.shape[-1] + b.shape[-1] - 1
    nfft = int(2 ** np.ceil(np.log2(max(out_len, 2))))
    y = F.irfft(F.rfft(a, n=nfft) * F.rfft(b, n=nfft), n=nfft)[..., :out_len]
    if max_taps is not None:
        y = y[..., :max_taps]
    return y
