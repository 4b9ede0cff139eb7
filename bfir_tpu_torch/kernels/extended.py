"""The ``extended`` engine: the reference plugin's double precision
(REALSIZE 8, foo_dsp_bfir/common.h:17) as native float64.

Counterpart of ``bfir_tpu/kernels/extended.py``. The reference runs on a
chip without float64, so it carries every spectrum as a df64 pair of
float32 planes (hi, lo) with df64 transforms and a compensated MAC. The
H100 computes float64 natively: here the ring, the overlap-save previous
block, the coefficients and the MAC are plain float64 tensors and the
transforms are ``torch.fft`` at float64. The ``df`` prefix of the names
(``DfState``, ``df_coeffs``, ``mac_df``, ``step_df``) only names the
reference counterpart; the arithmetic is float64 throughout, about 2^-53
relative against df64's ~2^-48.

The layout is the hc path's (kernels.spectrum_mac): packed ``[P, 2C, Hp]``
planes, re rows then im rows, lane 0 holding (DC.re, Nyquist.re), shared
coefficients ``[P, 2, Hp]``. ``blockcounter`` is a host int and the ring
insert updates the ring in place: a state passed to a step must not be
used again. The MAC is one gather over all partitions and complex
arithmetic in PyTorch; the reference computes it outside any Pallas kernel
too, so it is no kernel's plain version. Every output is float64 (the
reference's ``_emit`` gives float64 only on x64 hosts).

With a tracer current (``utils.profiling.current``), a step records its
phases as spans: ``engine.rfft`` (the frame, its float64 cast and
transform), ``engine.insert`` (the ring-slot writes), ``engine.mac`` and
``engine.irfft``, a MAC and an inverse per filter on a crossfade block.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from bfir_tpu_torch.core.spec import FilterSpec
from bfir_tpu_torch.kernels.spectrum_mac import _round_up, mac_reference_hc
from bfir_tpu_torch.ops import fft as F
from bfir_tpu_torch.utils import profiling as P
from bfir_tpu_torch.utils.device import resolve_device


class DfState(NamedTuple):
    """Extended-precision streaming state: ring [P, 2C, Hp] float64, prev
    [C, N] float64 (the overlap-save previous block), blockcounter a host
    int. The reference keeps each as a (hi, lo) float32 pair
    (``convert.df_state_from_numpy`` sums them)."""

    ring: torch.Tensor
    prev: torch.Tensor
    blockcounter: int


def init_df_state(spec: FilterSpec, n_channels: int, *, device) -> DfState:
    dev = resolve_device(device)
    hp = _round_up(spec.n_fft // 2, 128)
    return DfState(
        ring=torch.zeros((spec.n_partitions, 2 * n_channels, hp),
                         dtype=torch.float64, device=dev),
        prev=torch.zeros((n_channels, spec.block_length), dtype=torch.float64,
                         device=dev),
        blockcounter=0,
    )


def df_coeffs(impulse, spec: FilterSpec, n_channels: int, scale: float = 1.0,
              shared: bool = False, *, device) -> torch.Tensor:
    """Partitioned coefficient spectra as one float64 packed plane
    [P, 2C, Hp] from the host float64 rfft of the reference (without its
    hi/lo split). ``shared`` (every channel carries the same filter): one
    filter's plane [P, 2, Hp], which ``mac_df`` broadcasts over the
    channels."""
    n, p = spec.block_length, spec.n_partitions
    hp = _round_up(spec.n_fft // 2, 128)
    h64 = np.asarray(impulse, dtype=np.float64) * float(scale)
    if h64.ndim == 1:
        h64 = h64[None, :]
    if shared:
        h64 = h64[:1]  # caller asserts all rows identical
    c0, taps = h64.shape
    if taps > n * p:
        h64 = h64[:, : n * p]
    else:
        h64 = np.pad(h64, ((0, 0), (0, n * p - taps)))
    parts = h64.reshape(c0, p, n).transpose(1, 0, 2)
    sp = np.fft.rfft(parts, n=spec.n_fft, axis=-1)
    half = spec.n_fft // 2
    cr = sp.real[..., :half]
    ci = np.concatenate([sp.real[..., half:half + 1], sp.imag[..., 1:half]],
                        -1)
    if c0 != n_channels and not shared:
        cr = np.broadcast_to(cr, (p, n_channels, half))
        ci = np.broadcast_to(ci, (p, n_channels, half))
    pk = np.concatenate([cr, ci], axis=1)  # [P, 2C0, half]
    pk = np.pad(pk, ((0, 0), (0, 0), (0, hp - half)))
    return torch.from_numpy(pk).to(resolve_device(device))


def mac_df(ring: torch.Tensor, coeff: torch.Tensor,
           pos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partition MAC on packed float64 planes: for each partition i,
    coeff[i] times ring slot (pos - i) mod P, summed (lane 0 as two real
    products). ``coeff`` is [P, 2C, Hp] or shared [P, 2, Hp]. Returns
    (yr, yi), each [C, Hp]."""
    c = ring.shape[1] // 2
    cs = coeff.shape[1] // 2
    return mac_reference_hc(ring[:, :c], ring[:, c:], coeff[:, :cs],
                            coeff[:, cs:], pos)


def _advance(state: DfState, block: torch.Tensor, tr):
    """Frame spectrum into ring slot ``blockcounter % P`` (in place);
    returns (ring, new prev, pos). ``tr``: the tracer to record into, or
    None."""
    p, c2, _ = state.ring.shape
    n = block.shape[-1]
    if tr is not None:
        tr.begin("engine.rfft")
    frame = torch.cat([state.prev, block.to(torch.float64)], dim=-1)
    hr, hi = F.rfft_split_hc(frame)
    if tr is not None:
        tr.next("engine.insert")
    pos = state.blockcounter % p
    h = hr.shape[-1]  # lanes [h, Hp) stay zero
    state.ring[pos, : c2 // 2, :h] = hr
    state.ring[pos, c2 // 2:, :h] = hi
    if tr is not None:
        tr.end()
    return state.ring, frame[:, n:], pos


def _render(ring, coeff, pos: int, n: int, tr) -> torch.Tensor:
    if tr is not None:
        tr.begin("engine.mac")
    yr, yi = mac_df(ring, coeff, pos)
    if tr is not None:
        tr.next("engine.irfft")
    out = F.irfft_hc_tail(yr, yi, n=2 * n)
    if tr is not None:
        tr.end()
    return out


def step_df(state: DfState, coeff: torch.Tensor,
            block: torch.Tensor) -> Tuple[DfState, torch.Tensor]:
    """One streaming block at float64: frame rfft, ring-slot insert, MAC,
    overlap-save tail. ``block`` [C, N] of any float dtype; the output
    [C, N] is float64."""
    n = block.shape[-1]
    tr = P.current()
    ring, prev, pos = _advance(state, block, tr)
    out = _render(ring, coeff, pos, n, tr)
    return DfState(ring, prev, state.blockcounter + 1), out


def step_df_crossfade(state: DfState, coeff_old: torch.Tensor,
                      coeff_new: torch.Tensor,
                      block: torch.Tensor) -> Tuple[DfState, torch.Tensor]:
    """Glitch-free filter-change block: one ring advance, two MACs, and a
    linear ramp old -> new over the block (fftw_convolver.cpp:275-321)."""
    n = block.shape[-1]
    tr = P.current()
    ring, prev, pos = _advance(state, block, tr)
    out_old = _render(ring, coeff_old, pos, n, tr)
    out_new = _render(ring, coeff_new, pos, n, tr)
    ramp = torch.arange(n, dtype=out_old.dtype, device=out_old.device) / (n - 1)
    out = out_old * (1.0 - ramp) + out_new * ramp
    return DfState(ring, prev, state.blockcounter + 1), out
