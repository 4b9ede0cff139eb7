"""Two-stage non-uniform partitioned convolution (Gardner 1995).

Counterpart of ``bfir_tpu/core/nonuniform.py`` (two-stage part). A head
engine at the streaming block size N covers the first ``p_head * N`` taps
and runs every block; a tail engine with partition size M = R*N covers the
rest and fires once every R blocks, on the phase R-1 block. Tail output
z[k], computed when input M-block k completes, is the tail's contribution
to output M-block k + D; it waits in the pending queue [D, C, M], whose
slot 0 is consumed N samples per block.

Differences from the reference, all on the host side:

- ``blockcounter`` is a host int, so the fire decision is a Python branch
  on it (the reference's ``lax.cond``) and no step waits on the device;
- ring inserts update the rings in place, and ``inbuf`` is filled in
  place: a state passed to a step must not be used again;
- kernel selection follows the tensors' device (CPU tensors take the
  kernels' plain versions), so there is no ``use_pallas`` / ``interpret``.

Tail storage (``NuSpec.tail_store``): float32, bfloat16, or block-scaled
int24 / int16 (``kernels.spectrum_mac.IntPlanes``); the MAC accumulates in
float32 for every tier. ``head_store`` takes float32, int24 or int16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from bfir_tpu.core.spec import FilterSpec
from bfir_tpu_torch.kernels import fft_fused as FF
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.ops import fft as F


@dataclass(frozen=True)
class NuSpec:
    """Two-stage geometry. ``block_length``/``dtype`` as FilterSpec; the
    head runs ``p_head`` partitions at N, the tail ``p_tail`` partitions at
    M = ratio*N starting at tap offset p_head*N (an integer multiple D >= 2
    of M — the scheduling slack)."""

    block_length: int = 1024
    ratio: int = 8
    p_head: int = 16
    p_tail: int = 14
    dtype: str = "float32"
    tail_store: str = "float32"
    head_store: str = "float32"

    def __post_init__(self):
        if self.tail_store not in ("float32", "bfloat16", "int16", "int24"):
            raise ValueError(
                "tail_store must be float32/bfloat16/int16/int24, "
                f"got {self.tail_store!r}")
        if self.head_store not in ("float32", "int16", "int24"):
            raise ValueError(
                "head_store must be float32/int16/int24, "
                f"got {self.head_store!r}")
        if self.ratio < 2 or (self.ratio & (self.ratio - 1)):
            raise ValueError(f"ratio must be a power of two >= 2, got {self.ratio}")
        if self.p_head % self.ratio:
            raise ValueError(
                f"p_head ({self.p_head}) must be a multiple of ratio ({self.ratio})")
        if self.delay_blocks < 2:
            raise ValueError(
                "head must cover >= 2 tail partitions of taps (D >= 2): "
                f"p_head={self.p_head}, ratio={self.ratio}")
        if self.p_tail < 1:
            raise ValueError(f"p_tail must be >= 1, got {self.p_tail}")

    @property
    def m(self) -> int:
        """Tail partition / tail block size."""
        return self.ratio * self.block_length

    @property
    def delay_blocks(self) -> int:
        """D: tail-output delay in M-blocks (= head taps / M)."""
        return self.p_head // self.ratio

    @property
    def max_taps(self) -> int:
        return self.p_head * self.block_length + self.p_tail * self.m

    @property
    def head_spec(self) -> FilterSpec:
        return FilterSpec(self.block_length, self.p_head, self.dtype)

    @property
    def tail_spec(self) -> FilterSpec:
        return FilterSpec(self.m, self.p_tail, self.dtype)


def nu_geometry(taps: int, block_length: int = 1024, ratio: int = 8,
                dtype: str = "float32", tail_store: str = "float32",
                head_store: str = "float32") -> NuSpec:
    """The two-stage geometry covering ``taps``: minimal head (D = 2) and as
    many M-partitions as the rest needs."""
    p_head = 2 * ratio
    m = ratio * block_length
    rest = max(0, taps - p_head * block_length)
    p_tail = max(1, -(-rest // m))
    return NuSpec(block_length, ratio, p_head, p_tail, dtype, tail_store,
                  head_store)


class NuState(NamedTuple):
    """Streaming state: the two engine states, the M-block input
    accumulator and the pending tail-output queue (pending[0] is the
    M-block being consumed now; pending[-1] the most recent z)."""

    head: K.HcState
    tail: K.HcState
    inbuf: torch.Tensor  # [C, M]
    pending: torch.Tensor  # [D, C, M]


def _zero_int_ring(shape, bits: int, device) -> K.IntPlanes:
    p, c2, _ = shape
    return K.IntPlanes(
        hi=torch.zeros(shape, dtype=torch.int16, device=device),
        lo=(torch.zeros(shape, dtype=torch.uint8, device=device)
            if bits == 24 else None),
        scale=torch.full((p, c2, 128), 1e-30, dtype=torch.float32,
                         device=device))


_BITS = {"int16": 16, "int24": 24}


def init_nu_state(spec: NuSpec, n_channels: int, *, device) -> NuState:
    dt = getattr(torch, spec.dtype)
    head = K.init_hc_state(spec.head_spec, n_channels, device=device)
    if spec.head_store in _BITS:
        head = head._replace(ring=_zero_int_ring(
            head.ring.shape, _BITS[spec.head_store], device))
    tail = K.init_hc_state(spec.tail_spec, n_channels, device=device)
    if spec.tail_store == "bfloat16":
        tail = tail._replace(ring=tail.ring.to(torch.bfloat16))
    elif spec.tail_store in _BITS:
        tail = tail._replace(ring=_zero_int_ring(
            tail.ring.shape, _BITS[spec.tail_store], device))
    return NuState(
        head=head,
        tail=tail,
        inbuf=torch.zeros((n_channels, spec.m), dtype=dt, device=device),
        pending=torch.zeros((spec.delay_blocks, n_channels, spec.m),
                            dtype=dt, device=device),
    )


class NuCoeffs(NamedTuple):
    head: object  # [p_head, 2C | 2, Hp_head] tensor or IntPlanes
    tail: object  # [p_tail, 2C | 2, Hp_tail] tensor or IntPlanes


def nu_coeffs(impulse, spec: NuSpec, n_channels: int, scale: float = 1.0,
              precise: bool = False, shared: bool = False, *,
              device) -> NuCoeffs:
    """Split the impulse at the head/tail boundary and build each stage's
    packed halfcomplex planes (``spectrum_mac.hc_coeffs``, with its
    ``precise`` and ``shared`` forms), stored in each stage's tier."""
    h = np.asarray(impulse)
    if h.ndim == 1:
        h = h[None, :]
    if h.shape[-1] > spec.max_taps:
        raise ValueError(
            f"impulse ({h.shape[-1]} taps) exceeds the geometry's "
            f"max_taps ({spec.max_taps}); enlarge p_tail (nu_geometry does)")
    t1 = spec.p_head * spec.block_length
    taps = h.shape[-1]
    head_imp = h[:, : min(taps, t1)]
    tail_imp = h[:, t1:] if taps > t1 else np.zeros((h.shape[0], 1), h.dtype)
    tail = K.hc_coeffs(tail_imp, spec.tail_spec, n_channels, scale, precise,
                       shared=shared, device=device)
    if spec.tail_store == "bfloat16":
        tail = tail.to(torch.bfloat16)
    elif spec.tail_store in _BITS:
        tail = K.quantize_planes(tail, _BITS[spec.tail_store])
    head = K.hc_coeffs(head_imp, spec.head_spec, n_channels, scale, precise,
                       shared=shared, device=device)
    if spec.head_store in _BITS:
        head = K.quantize_planes(head, _BITS[spec.head_store])
    return NuCoeffs(head=head, tail=tail)


def _tail_mac(ring, coeff, pos: int, tile: int = 2048):
    """Tail-stage MAC: K2 on float planes, K3 on integer planes."""
    if isinstance(ring, K.IntPlanes):
        hp = ring.hi.shape[-1]
        return K.mac_hc_tiled_int(ring, coeff, pos, tile=min(tile, hp))
    hp = ring.shape[-1]
    return K.mac_hc_tiled(ring, coeff, pos, tile=min(tile, hp))


def _tail_inverse(yr, yi, m: int):
    """Overlap-save inverse of an M-block tail fire: K4 where the reference
    wires its fused kernel (M a multiple of 1024, M <= 8192), the plain
    ``irfft_split_hc`` tail elsewhere."""
    if m % 128 == 0 and (m // 128) % 8 == 0 and m <= 8192:
        return FF.irfft_split_hc_tail_balanced(yr, yi, n=2 * m)
    return F.irfft_split_hc(yr, yi, n=2 * m)[..., m:]


def _ring_shape(ring):
    """Shape of a ring in either representation."""
    return ring.hi.shape if isinstance(ring, K.IntPlanes) else ring.shape


def _ring_insert(ring, xpk, pos: int):
    """Write the new packed spectrum [2C, Hp] into slot ``pos``, in place.
    Integer rings quantize the slot's rows (per-row scale) first."""
    if not isinstance(ring, K.IntPlanes):
        ring[pos] = xpk.to(ring.dtype)
        return ring
    q = K.quantize_planes(xpk, 16 if ring.lo is None else 24)
    ring.hi[pos] = q.hi
    if ring.lo is not None:
        ring.lo[pos] = q.lo
    ring.scale[pos] = q.scale
    return ring


def _advance(state: K.HcState, block):
    """Frame transform and in-place ring insert for one stage step.
    Returns (ring, new prev_block, slot position)."""
    p, _, hp = _ring_shape(state.ring)
    prev, xpk = K._hc_frame_spectrum(state, block, hp)
    pos = state.blockcounter % p
    return _ring_insert(state.ring, xpk, pos), prev, pos


def _tail_step(state: K.HcState, coeff, mblock):
    """One overlap-save step of the tail engine on an M-block: K2/K3 MAC,
    then the K4 inverse."""
    m = mblock.shape[-1]
    ring, prev, pos = _advance(state, mblock)
    yr, yi = _tail_mac(ring, coeff, pos)
    out = _tail_inverse(yr, yi, m)
    return K.HcState(ring, prev, state.blockcounter + 1), out


def _hc_mac(ring, coeff, pos: int):
    """Head-stage MAC: K1 on float planes, K3 (one tile) on integer ones."""
    if isinstance(ring, K.IntPlanes):
        hp = ring.hi.shape[-1]
        return K.mac_hc_tiled_int(ring, coeff, pos, tile=hp)
    return K.mac_hc(ring, coeff, pos)


def _head_step(state: K.HcState, coeff, block):
    """Head-stage step: ``step_hc`` for float heads, or the quantizing
    insert + K3 MAC + overlap-save tail for int16/int24 heads."""
    if not isinstance(coeff, K.IntPlanes):
        return K.step_hc(state, coeff, block)
    n = block.shape[-1]
    ring, prev, pos = _advance(state, block)
    yr, yi = _hc_mac(ring, coeff, pos)
    out = F.irfft_hc_tail(yr.to(prev.dtype), yi.to(prev.dtype), n=2 * n)
    return K.HcState(ring, prev, state.blockcounter + 1), out


def _push_pending(pending, z):
    """Drop the consumed M-block and append the newest tail output."""
    return torch.cat([pending[1:], z[None].to(pending.dtype)], dim=0)


def step_nu(state: NuState, coeffs: NuCoeffs,
            block: torch.Tensor) -> Tuple[NuState, torch.Tensor]:
    """One N-block through the two-stage engine. Outputs match the uniform
    engine (``step_hc`` at P = p_head + ratio * p_tail) to fp rounding. The
    tail fires on the phase R-1 block (a host branch)."""
    n = block.shape[-1]
    ratio = state.inbuf.shape[-1] // n
    phase = state.head.blockcounter % ratio
    head, y_head = _head_step(state.head, coeffs.head, block)
    off = phase * n
    state.inbuf[:, off:off + n] = block
    out = y_head + state.pending[0][:, off:off + n]
    tail, pending = state.tail, state.pending
    if phase == ratio - 1:
        tail, z = _tail_step(tail, coeffs.tail, state.inbuf)
        pending = _push_pending(pending, z)
    return NuState(head, tail, state.inbuf, pending), out


def _tail_step2(state: K.HcState, coeff_a, coeff_b, mblock):
    """Tail step with ONE ring advance and TWO coefficient MACs — the
    transition fire of a live filter change (see step_nu_crossfade)."""
    m = mblock.shape[-1]
    ring, prev, pos = _advance(state, mblock)
    ya = _tail_mac(ring, coeff_a, pos)
    yb = _tail_mac(ring, coeff_b, pos)
    za = _tail_inverse(ya[0], ya[1], m)
    zb = _tail_inverse(yb[0], yb[1], m)
    return K.HcState(ring, prev, state.blockcounter + 1), za, zb


def step_nu_crossfade(state: NuState, coeffs_old: NuCoeffs,
                      coeffs_new: NuCoeffs, block: torch.Tensor,
                      head_ramp: bool = True) -> Tuple[NuState, torch.Tensor]:
    """Glitch-free live filter change on the two-stage engine: the head
    runs two MACs and a linear intra-block ramp on the change block
    (``head_ramp=True``), new coefficients after; the first tail fire after
    the change computes its M-block with both coefficient sets and stores a
    full-M linear ramp old -> new. In-flight pending blocks keep the old
    filter. The caller feeds blocks through here (``head_ramp=False`` after
    the first) until a phase R-1 block has passed, then returns to
    ``step_nu`` (fftw_convolver.cpp:275-321's law, per stage)."""
    n = block.shape[-1]
    ratio = state.inbuf.shape[-1] // n
    phase = state.head.blockcounter % ratio
    if head_ramp:
        ring, prev, pos = _advance(state.head, block)
        yo = _hc_mac(ring, coeffs_old.head, pos)
        yn = _hc_mac(ring, coeffs_new.head, pos)
        out_o = F.irfft_hc_tail(yo[0].to(prev.dtype), yo[1].to(prev.dtype),
                                n=2 * n)
        out_n = F.irfft_hc_tail(yn[0].to(prev.dtype), yn[1].to(prev.dtype),
                                n=2 * n)
        ramp = torch.arange(n, dtype=out_o.dtype, device=out_o.device) / (n - 1)
        y_head = out_o * (1.0 - ramp) + out_n * ramp
        head = K.HcState(ring, prev, state.head.blockcounter + 1)
    else:
        head, y_head = _head_step(state.head, coeffs_new.head, block)
    off = phase * n
    state.inbuf[:, off:off + n] = block
    out = y_head + state.pending[0][:, off:off + n]
    tail, pending = state.tail, state.pending
    if phase == ratio - 1:
        tail, z_old, z_new = _tail_step2(tail, coeffs_old.tail,
                                         coeffs_new.tail, state.inbuf)
        m = z_old.shape[-1]
        ramp_m = torch.arange(m, dtype=z_old.dtype, device=z_old.device) / (m - 1)
        pending = _push_pending(pending, z_old * (1.0 - ramp_m) + z_new * ramp_m)
    return NuState(head, tail, state.inbuf, pending), out


def step_nu_macro(state: NuState, coeffs: NuCoeffs,
                  mblocks: torch.Tensor) -> Tuple[NuState, torch.Tensor]:
    """One full M-cycle (R consecutive N-blocks, ``mblocks`` [R, C, N])
    from phase 0: R head steps, then one tail fire. Same state evolution
    and outputs as R calls of ``step_nu``."""
    r, c, n = mblocks.shape
    if state.head.blockcounter % r:
        raise ValueError("step_nu_macro needs the state at phase 0, got "
                         f"blockcounter {state.head.blockcounter}")
    head = state.head
    outs = []
    for i in range(r):
        head, y = _head_step(head, coeffs.head, mblocks[i])
        outs.append(y + state.pending[0][:, i * n:(i + 1) * n])
    state.inbuf.copy_(mblocks.transpose(0, 1).reshape(c, r * n))
    tail, z = _tail_step(state.tail, coeffs.tail, state.inbuf)
    pending = _push_pending(state.pending, z)
    return NuState(head, tail, state.inbuf, pending), torch.stack(outs)


def process_blocks_nu(state: NuState, coeffs: NuCoeffs,
                      blocks: torch.Tensor) -> Tuple[NuState, torch.Tensor]:
    """``step_nu`` over blocks [B, C, N] from any phase -> (state,
    out [B, C, N])."""
    outs = []
    for blk in blocks:
        state, y = step_nu(state, coeffs, blk)
        outs.append(y)
    return state, torch.stack(outs)


def process_blocks_nu_fast(state: NuState, coeffs: NuCoeffs,
                           blocks: torch.Tensor) -> Tuple[NuState, torch.Tensor]:
    """``step_nu_macro`` over M-cycles: blocks [B, C, N] with B a multiple
    of R and ``state`` at phase 0. Same outputs as ``process_blocks_nu``."""
    b, c, n = blocks.shape
    ratio = state.inbuf.shape[-1] // n
    if b % ratio:
        raise ValueError(f"block count {b} not a multiple of R={ratio}")
    outs = []
    for mb in blocks.reshape(b // ratio, ratio, c, n):
        state, y = step_nu_macro(state, coeffs, mb)
        outs.append(y)
    return state, torch.cat(outs).reshape(b, c, n)
