"""Non-uniform partitioned convolution (Gardner 1995): two and three stages.

Counterpart of ``bfir_tpu/core/nonuniform.py``. A head
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

The three-stage engine (``Nu3Spec``, ``step_nu3``, below) replaces the tail
with a whole two-stage engine at block M1 = ratio1 * N.

With a tracer current (``utils.profiling.current``), the two- and
three-stage steps record each block's head step as an ``engine.head`` span
and each tail fire (the M-block's forward transform, the tail MAC, its
inverse and the pending push) as an ``engine.tail`` span, counted in
``engine.tail_fires``. A three-stage far fire is an ``engine.tail`` inside
its mid fire's, and counts too. The split-tail schedule, which spreads its
fire over the cycle, records neither.

``NuGraphStep``, the session's two-stage step, runs ``step_nu`` with its
head step on buffers of its own: on a CUDA device replayed from one graph
a head ring slot (``utils.graphs``), counted in ``engine.head_replays``;
on the CPU eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from bfir_tpu_torch.core.spec import FilterSpec
from bfir_tpu_torch.kernels import fft_fused as FF
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.ops import fft as F
from bfir_tpu_torch.utils import graphs as G
from bfir_tpu_torch.utils import profiling as P


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

    @property
    def traffic_bytes_per_block(self) -> int:
        """Amortized MAC bytes per N-block and channel (ring + coefficients,
        both stages, each at its storage tier)."""
        head = (2 * self.p_head * 2 * self.block_length
                * _ITEMSIZE[self.head_store])
        tail = (2 * self.p_tail * 2 * self.m * _ITEMSIZE[self.tail_store]
                // self.ratio)
        return head + tail


_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int16": 2, "int24": 3}


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


def _head(step, *args):
    """``step(*args)``, a block's head step, in an ``engine.head`` span
    while a tracer is current."""
    tr = P.current()
    if tr is None:
        return step(*args)
    tr.begin("engine.head")
    out = step(*args)
    tr.end()
    return out


def _push_pending(pending, z):
    """Drop the consumed M-block and append the newest tail output."""
    return torch.cat([pending[1:], z[None].to(pending.dtype)], dim=0)


def _fire(fire, tail, inbuf, pending):
    """``fire(tail, inbuf) -> (tail, z)``, z pushed to ``pending``; in an
    ``engine.tail`` span, counted in ``engine.tail_fires``, while a tracer
    is current. Returns (tail, pending)."""
    tr = P.current()
    if tr is None:
        tail, z = fire(tail, inbuf)
        return tail, _push_pending(pending, z)
    tr.count("engine.tail_fires")
    tr.begin("engine.tail")
    tail, z = fire(tail, inbuf)
    pending = _push_pending(pending, z)
    tr.end()
    return tail, pending


def _cycle(state, block, phase: int, head, y_head, fire):
    """The body every non-uniform step shares, after its head step (``head``,
    ``y_head``): ``block`` into ``inbuf`` at ``phase``, the output
    ``y_head`` plus the pending slice, and on the cycle's last phase
    ``fire(tail, inbuf) -> (tail, z)`` with z pushed to the pending queue.
    Returns a state of ``state``'s type (``NuState`` or ``Nu3State``)."""
    n = block.shape[-1]
    off = phase * n
    state.inbuf[:, off:off + n] = block
    out = y_head + state.pending[0][:, off:off + n]
    tail, pending = state.tail, state.pending
    if phase == state.inbuf.shape[-1] // n - 1:
        tail, pending = _fire(fire, tail, state.inbuf, pending)
    return type(state)(head, tail, state.inbuf, pending), out


def _phase(state, block) -> int:
    """The block's phase in the tail's cycle, from the head's counter."""
    return state.head.blockcounter % (state.inbuf.shape[-1] // block.shape[-1])


def step_nu(state: NuState, coeffs: NuCoeffs, block: torch.Tensor,
            phase: Optional[int] = None) -> Tuple[NuState, torch.Tensor]:
    """One N-block through the two-stage engine. Outputs match the uniform
    engine (``step_hc`` at P = p_head + ratio * p_tail) to fp rounding. The
    tail fires on the phase R-1 block (a host branch). ``phase``: an int
    pins the block's phase instead of the counter's (the block goes to
    ``inbuf`` at ``phase * N`` and the tail fires iff ``phase == R - 1``),
    as the per-phase latency measurement steps it; None takes it from the
    counter."""
    ratio = state.inbuf.shape[-1] // block.shape[-1]
    if phase is None:
        phase = state.head.blockcounter % ratio
    elif not 0 <= phase < ratio:
        raise ValueError(f"phase {phase} outside [0, {ratio})")
    head, y_head = _head(_head_step, state.head, coeffs.head, block)
    return _cycle(state, block, phase, head, y_head,
                  lambda tail, mb: _tail_step(tail, coeffs.tail, mb))


class NuGraphStep:
    """The session's ``nonuniform`` step for one stream: called as
    ``step(state, coeffs, block)`` and returning ``(state, out)`` as
    ``step_nu`` does. The phase comes from the host's counter and the rest
    of the block (``_cycle``: ``inbuf``, the pending slice and the eager
    tail fire) is ``step_nu``'s; the head step (``_head_step``, in its
    ``engine.head`` span) runs on buffers of the step's own: the head ring,
    ``prev``, the block's input and the head's output.

    On a CUDA device the head is replayed from one graph a head ring slot
    (``utils.graphs.StepGraphs``, whose rules say when they are captured
    and when the head runs eagerly instead): a capture of ``_head_step`` on
    ``HcState(ring, prev, s)``, so that the slot (K1's ``pos``) is fixed in
    it, reading the input buffer and copying the new ``prev`` and the
    output into the buffers. A block copies its input in and replays the
    graph of slot ``blockcounter % p_head``; ``_cycle``'s sum makes a new
    tensor of the output, so none is cloned. On the CPU the same body runs
    eagerly on the buffers, so the step is ``step_nu`` bit for bit.

    The returned state's ``head`` holds the ring and ``prev`` buffers
    themselves. A state the step did not return last (a fresh one, a
    crossfade's, a restored one) is copied into the buffers: device
    copies, no sync; a ring that is already the step's own (a crossfade or
    ``process_buffer`` wrote its slot in place) is not copied.

    ``graphs`` counts the step's captures and head replays. A kernel's
    ``launches`` counts host launches, so a K1 (or K3) in a graph counts
    once a capture, never a replay."""

    def __init__(self):
        self._key = None  # the layout the buffers were made for
        self._ring = self._prev = self._x = self._y = None
        self._state = None  # the state this step returned last
        self.graphs = G.StepGraphs(
            lambda slot, coeff: self._body(slot, coeff, self._x),
            self._warmup, "engine.head_replays")

    def __call__(self, state: NuState, coeffs: NuCoeffs,
                 block: torch.Tensor) -> Tuple[NuState, torch.Tensor]:
        if state is not self._state:
            self._load(state.head)
        cnt = state.head.blockcounter
        head, y_head = _head(self._head, cnt, coeffs.head, block)
        self._state, out = _cycle(
            state, block, _phase(state, block), head, y_head,
            lambda tail, mb: _tail_step(tail, coeffs.tail, mb))
        return self._state, out

    def _load(self, head: K.HcState) -> None:
        """Take up a head state this step did not return last: its
        layout's buffers (new ones, and no graphs, where it changed), its
        ring and its ``prev``."""
        prev = head.prev_block
        key = (G.layout(head.ring), prev.shape, prev.dtype)
        if key != self._key:
            self._key = key
            self._ring = G.map_planes(torch.zeros_like, head.ring)
            self._prev, self._x, self._y = (torch.zeros_like(prev)
                                            for _ in range(3))
            self.graphs.reset(prev.device, _ring_shape(self._ring)[0])
        if head.ring is not self._ring:
            G.copy_planes(self._ring, head.ring)
        self._prev.copy_(prev)  # a copy onto itself is no copy

    def _body(self, slot: int, coeff, block) -> None:
        """``_head_step`` at ring slot ``slot`` on the buffers."""
        head, y = _head_step(K.HcState(self._ring, self._prev, slot), coeff,
                             block)
        self._prev.copy_(head.prev_block)
        self._y.copy_(y)

    def _warmup(self, coeff) -> None:
        _head_step(K.HcState(G.map_planes(torch.clone, self._ring),
                             self._prev.clone(), 0), coeff, self._x)

    def _head(self, cnt: int, coeff, block):
        """The head step of block ``cnt``: replayed, or eagerly on the CPU
        and while the plan cache is full."""
        if self.graphs.ready(coeff, P.current()):
            self._x.copy_(block)
            self.graphs.replay(cnt % _ring_shape(self._ring)[0])
        else:
            self._body(cnt, coeff, block)
        return K.HcState(self._ring, self._prev, cnt + 1), self._y


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


def _ramp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a -> b with a linear ramp along the last axis."""
    m = a.shape[-1]
    w = torch.arange(m, dtype=a.dtype, device=a.device) / (m - 1)
    return a * (1.0 - w) + b * w


def _bridge(tail: K.HcState, coeff_old, coeff_new, mblock):
    """The bridging fire of a live change: both coefficient sets on one
    ring advance, the block ramped old -> new."""
    tail, z_old, z_new = _tail_step2(tail, coeff_old, coeff_new, mblock)
    return tail, _ramp(z_old, z_new)


def _head_ramp(state: K.HcState, coeff_old, coeff_new, block):
    """A head step on the change block: one ring advance, both MACs (K1, or
    K3 on integer planes), each output's tail, ramped old -> new."""
    n = block.shape[-1]
    ring, prev, pos = _advance(state, block)
    outs = [F.irfft_hc_tail(y[0].to(prev.dtype), y[1].to(prev.dtype),
                            n=2 * n)
            for y in (_hc_mac(ring, coeff_old, pos),
                      _hc_mac(ring, coeff_new, pos))]
    return K.HcState(ring, prev, state.blockcounter + 1), _ramp(*outs)


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
    phase = _phase(state, block)
    if head_ramp:
        head, y_head = _head(_head_ramp, state.head, coeffs_old.head,
                             coeffs_new.head, block)
    else:
        head, y_head = _head(_head_step, state.head, coeffs_new.head, block)
    return _cycle(state, block, phase, head, y_head,
                  lambda tail, mb: _bridge(tail, coeffs_old.tail,
                                           coeffs_new.tail, mb))


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
        head, y = _head(_head_step, head, coeffs.head, mblocks[i])
        outs.append(y + state.pending[0][:, i * n:(i + 1) * n])
    state.inbuf.copy_(mblocks.transpose(0, 1).reshape(c, r * n))
    tail, pending = _fire(lambda t, mb: _tail_step(t, coeffs.tail, mb),
                          state.tail, state.inbuf, state.pending)
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


# ---------------------------------------------------------------------------
# Split-tail schedule: the per-block latency smoother
# (reference core/nonuniform.py:609-871).
#
# step_nu runs the whole tail fire (forward M-transform, tail MAC, inverse)
# on the phase R-1 block. The tail output has R blocks of slack, so the
# fire spreads over the following cycle:
#
#   phase 0:    the forward M-transform of [previous M-block | completed
#               M-block] (``F.rfft_split_hc_partA``; with torch.fft this is
#               the whole transform), staged in ``xstage``; the completed
#               M-block becomes tail.prev_block;
#   phase 1:    ``partB`` (a pass-through here) and the ring insert, then
#               its MAC band;
#   phase >= 1: its frequency band(s) of the tail MAC over all partitions
#               (K5, or K6 on integer rings), written once into acc_r /
#               acc_i at band * band_len; phase 2 also runs the last band;
#   phase R-1:  the inverse of the full accumulator (K4); z joins a pending
#               queue of depth D-1, one shorter than step_nu's because it
#               joins one cycle later.
#
# Outputs equal step_nu's to float rounding. The head is the float32
# ``step_hc`` (K1). The phase is a host int, as in step_nu.
# ---------------------------------------------------------------------------


class NuSplitState(NamedTuple):
    """Split-tail streaming state: the two engine states, the banded MAC
    accumulator, the staged forward transform and a depth-(D-1) pending
    queue."""

    head: K.HcState
    tail: K.HcState
    acc_r: torch.Tensor  # [C, Hp_t] float32 banded-MAC accumulator
    acc_i: torch.Tensor
    xstage: torch.Tensor  # [2C, Hp_t] staged forward planes (phase 0)
    inbuf: torch.Tensor  # [C, M]
    pending: torch.Tensor  # [D-1, C, M]


def split_band_len(spec: NuSpec) -> int:
    """Frequency band per phase; Hp_t must split into R 128-lane-aligned
    bands (true for every power-of-two geometry with N >= 128)."""
    hp = -(-spec.m // 128) * 128
    if hp % (spec.ratio * 128):
        raise ValueError(
            f"split-tail needs Hp ({hp}) divisible into {spec.ratio} "
            "128-lane-aligned bands")
    return hp // spec.ratio


def init_nu_split_state(spec: NuSpec, n_channels: int, *,
                        device) -> NuSplitState:
    dt = getattr(torch, spec.dtype)
    hp_t = -(-spec.m // 128) * 128
    split_band_len(spec)  # geometry check
    if spec.head_store != "float32":
        raise ValueError(
            "split-tail schedule supports integer storage on the TAIL only "
            "(the head runs the plain hc step); set head_store='float32'")
    st = init_nu_state(spec, n_channels, device=device)
    # accumulate in float32 for float32 engines, in the engine dtype else
    acc_dt = torch.float32 if dt == torch.float32 else dt
    return NuSplitState(
        head=st.head,
        tail=st.tail,
        acc_r=torch.zeros((n_channels, hp_t), dtype=acc_dt, device=device),
        acc_i=torch.zeros((n_channels, hp_t), dtype=acc_dt, device=device),
        xstage=torch.zeros((2 * n_channels, hp_t), dtype=dt, device=device),
        inbuf=st.inbuf,
        pending=torch.zeros((max(1, spec.delay_blocks - 1), n_channels,
                             spec.m), dtype=dt, device=device),
    )


def _split_band_mac(ring, coeff, pos: int, band: int, band_len: int):
    """One band of the tail MAC: K5 on float rings, K6 on integer rings."""
    if isinstance(ring, K.IntPlanes):
        return K.mac_hc_band_int(ring, coeff, pos, band * band_len, band_len)
    return K.mac_hc_band(ring, coeff, pos, band * band_len, band_len)


def _split_schedule(ratio: int):
    """Static phase plan: (fwd_split, bands_by_phase). With the two-phase
    forward (R >= 4) bands run on phases 1..R-1 after the ring insert, the
    leftover band riding phase 2; the one-phase form keeps band p on phase
    p."""
    fwd_split = 2 if ratio >= 4 else 1
    if fwd_split == 1:
        bands = {p: [p] for p in range(ratio)}
    else:
        bands = {p: [p - 1] for p in range(1, ratio)}
        bands[2] = [1, ratio - 1]
        bands[0] = []
    return fwd_split, bands


def _pad_planes(hr, hi, hp: int):
    """(hr, hi) [C, h] -> packed [2C, hp], zero lane padding."""
    pad = hp - hr.shape[-1]
    return torch.cat([torch.nn.functional.pad(hr, (0, pad)),
                      torch.nn.functional.pad(hi, (0, pad))], dim=0)


def _split_phase(state: NuSplitState, coeffs: NuCoeffs, block,
                 phase: int) -> Tuple[NuSplitState, torch.Tensor]:
    """One block at host phase ``phase`` of the split-tail schedule. The
    rings, ``acc_*`` and ``inbuf`` update in place."""
    n = block.shape[-1]
    c, m = state.inbuf.shape
    ratio = m // n
    hp_t = state.acc_r.shape[-1]
    band_len = hp_t // ratio
    fwd_split, bands = _split_schedule(ratio)

    head, y_head = K.step_hc(state.head, coeffs.head, block)
    off = phase * n
    tail_slice = state.pending[0][:, off:off + n]

    tail, xstage = state.tail, state.xstage
    p_t = _ring_shape(tail.ring)[0]
    if phase == 0:
        # the M-block completed last cycle (inbuf, before this block's
        # slice-0 write) is framed now; the new prev_block is a view of the
        # frame, so the write below cannot reach it
        frame = torch.cat([tail.prev_block, state.inbuf], dim=-1)
        hr, hi = F.rfft_split_hc_partA(frame)
        if fwd_split == 1:
            pos = tail.blockcounter % p_t
            ring = _ring_insert(tail.ring, _pad_planes(hr, hi, hp_t), pos)
            tail = K.HcState(ring, frame[:, m:], tail.blockcounter + 1)
        else:
            xstage = _pad_planes(hr, hi, hp_t)
            tail = K.HcState(tail.ring, frame[:, m:], tail.blockcounter)
    elif phase == 1 and fwd_split == 2:
        hr, hi = F.rfft_split_hc_partB(xstage[:c, :m], xstage[c:, :m], 2 * m)
        pos = tail.blockcounter % p_t
        ring = _ring_insert(tail.ring, _pad_planes(hr, hi, hp_t), pos)
        tail = K.HcState(ring, tail.prev_block, tail.blockcounter + 1)

    state.inbuf[:, off:off + n] = block

    # band MACs: the newest ring slot is (counter - 1) mod P
    pos_now = (tail.blockcounter - 1) % p_t
    for band in bands[phase]:
        br, bi = _split_band_mac(tail.ring, coeffs.tail, pos_now, band,
                                 band_len)
        boff = band * band_len
        state.acc_r[:, boff:boff + band_len] = br
        state.acc_i[:, boff:boff + band_len] = bi

    pending = state.pending
    if phase == ratio - 1:
        dt = state.inbuf.dtype
        z = _tail_inverse(state.acc_r.to(dt), state.acc_i.to(dt), m)
        pending = _push_pending(pending, z)

    out = y_head + tail_slice
    return NuSplitState(head, tail, state.acc_r, state.acc_i, xstage,
                        state.inbuf, pending), out


def step_nu_split(state: NuSplitState, coeffs: NuCoeffs,
                  block: torch.Tensor) -> Tuple[NuSplitState, torch.Tensor]:
    """One N-block through the split-tail two-stage engine (the phase is a
    host branch on the head's block counter); outputs match ``step_nu`` to
    float rounding. Needs D >= 2 (every ``nu_geometry`` has it)."""
    ratio = state.inbuf.shape[-1] // block.shape[-1]
    return _split_phase(state, coeffs, block,
                        state.head.blockcounter % ratio)


def process_blocks_nu_split(state: NuSplitState, coeffs: NuCoeffs,
                            blocks: torch.Tensor
                            ) -> Tuple[NuSplitState, torch.Tensor]:
    """``step_nu_split`` over M-cycle-aligned blocks [B, C, N] (B a
    multiple of R, state at phase 0) -> (state, out [B, C, N])."""
    b, c, n = blocks.shape
    ratio = state.inbuf.shape[-1] // n
    if b % ratio:
        raise ValueError(f"block count {b} not a multiple of R={ratio}")
    if state.head.blockcounter % ratio:
        raise ValueError("process_blocks_nu_split needs the state at phase "
                         f"0, got blockcounter {state.head.blockcounter}")
    outs = []
    for i, blk in enumerate(blocks):
        state, y = _split_phase(state, coeffs, blk, i % ratio)
        outs.append(y)
    return state, torch.stack(outs)


# ---------------------------------------------------------------------------
# Three-stage partitioning (reference core/nonuniform.py:873-1276): the
# two-stage schedule composed recursively. The tail engine of ``step_nu`` is
# replaced by a whole two-stage engine at block size M1 = ratio1 * N: its
# head (p_head partitions at M1, every ratio1 blocks, the mid stage) and its
# far stage (M2 = ratio2 * M1, every ratio1 * ratio2 blocks). The inner
# engine produces its M1-block output with no extra latency, its own far
# stage hiding inside its own pending queue (D2 >= 2), so the outer queue's
# D1 >= 2 slack composes unchanged.
#
# Kernels: the outer head is ``step_hc`` (K1); the mid stage runs
# ``_tail_step`` at M1 (K2, or K3 on integer planes, and K4 for M1 <= 8192);
# the far stage runs ``_tail_step`` at M2 (K2 or K3, and ``torch.fft`` for
# its inverse above K4's sizes, as the reference takes XLA there).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Nu3Spec:
    """Three-stage geometry: outer head (``p_head`` partitions at N) plus an
    inner two-stage ``NuSpec`` at block M1 = ratio1 * N covering the rest."""

    block_length: int
    ratio1: int
    p_head: int
    inner: NuSpec

    def __post_init__(self):
        if self.ratio1 < 2 or (self.ratio1 & (self.ratio1 - 1)):
            raise ValueError(
                f"ratio1 must be a power of two >= 2, got {self.ratio1}")
        if self.p_head % self.ratio1:
            raise ValueError(
                f"p_head ({self.p_head}) must be a multiple of ratio1 "
                f"({self.ratio1})")
        if self.delay_blocks < 2:
            raise ValueError("outer head must cover >= 2 M1-blocks of taps")
        if self.inner.block_length != self.ratio1 * self.block_length:
            raise ValueError("inner block length must equal ratio1 * N")

    @property
    def m1(self) -> int:
        """Inner (mid-stage) block size."""
        return self.ratio1 * self.block_length

    @property
    def delay_blocks(self) -> int:
        """D1: inner-output delay in M1-blocks (= outer head taps / M1)."""
        return self.p_head // self.ratio1

    @property
    def max_taps(self) -> int:
        return self.p_head * self.block_length + self.inner.max_taps

    @property
    def head_spec(self) -> FilterSpec:
        return FilterSpec(self.block_length, self.p_head, self.inner.dtype)

    @property
    def traffic_bytes_per_block(self) -> int:
        """Amortized MAC bytes per N-block and channel, all three stages."""
        it = np.dtype(self.inner.dtype).itemsize
        head = 2 * self.p_head * 2 * self.block_length * it
        return head + self.inner.traffic_bytes_per_block // self.ratio1


def nu3_geometry(taps: int, block_length: int = 1024, ratio1: int = 8,
                 ratio2: int = 8, dtype: str = "float32",
                 tail_store: str = "float32") -> Nu3Spec:
    """The minimal-head three-stage geometry covering ``taps``."""
    p_head = 2 * ratio1
    m1 = ratio1 * block_length
    rest = max(1, taps - p_head * block_length)
    inner = nu_geometry(rest, m1, ratio2, dtype, tail_store)
    return Nu3Spec(block_length, ratio1, p_head, inner)


class Nu3State(NamedTuple):
    head: K.HcState
    tail: NuState  # the inner two-stage engine at M1
    inbuf: torch.Tensor  # [C, M1]
    pending: torch.Tensor  # [D1, C, M1]


def init_nu3_state(spec: Nu3Spec, n_channels: int, *, device) -> Nu3State:
    dt = getattr(torch, spec.inner.dtype)
    return Nu3State(
        head=K.init_hc_state(spec.head_spec, n_channels, device=device),
        tail=init_nu_state(spec.inner, n_channels, device=device),
        inbuf=torch.zeros((n_channels, spec.m1), dtype=dt, device=device),
        pending=torch.zeros((spec.delay_blocks, n_channels, spec.m1),
                            dtype=dt, device=device),
    )


class Nu3Coeffs(NamedTuple):
    head: torch.Tensor  # [p_head, 2C | 2, Hp]
    tail: NuCoeffs  # the inner two-stage coefficients


def nu3_coeffs(impulse, spec: Nu3Spec, n_channels: int, scale: float = 1.0,
               precise: bool = False, shared: bool = False, *,
               device) -> Nu3Coeffs:
    """Split the impulse at the outer head's end: the outer head's planes
    (``spectrum_mac.hc_coeffs``) and the inner engine's ``nu_coeffs`` of
    the rest."""
    h = np.asarray(impulse)
    if h.ndim == 1:
        h = h[None, :]
    if h.shape[-1] > spec.max_taps:
        raise ValueError(
            f"impulse ({h.shape[-1]} taps) exceeds the geometry's "
            f"max_taps ({spec.max_taps}); enlarge the far stage "
            "(nu3_geometry does)")
    t1 = spec.p_head * spec.block_length
    taps = h.shape[-1]
    head_imp = h[:, : min(taps, t1)]
    tail_imp = h[:, t1:] if taps > t1 else np.zeros((h.shape[0], 1), h.dtype)
    return Nu3Coeffs(
        head=K.hc_coeffs(head_imp, spec.head_spec, n_channels, scale, precise,
                         shared=shared, device=device),
        tail=nu_coeffs(tail_imp, spec.inner, n_channels, scale, precise,
                       shared=shared, device=device),
    )


def _step_nu_tiled_head(state: NuState, coeffs: NuCoeffs,
                        block) -> Tuple[NuState, torch.Tensor]:
    """``step_nu`` with the head run through ``_tail_step`` (K2 or K3, K4):
    the inner engine of the three-stage schedule, whose head runs at block
    M1."""
    phase = _phase(state, block)
    head, y_head = _tail_step(state.head, coeffs.head, block)
    return _cycle(state, block, phase, head, y_head,
                  lambda tail, mb: _tail_step(tail, coeffs.tail, mb))


def step_nu3(state: Nu3State, coeffs: Nu3Coeffs,
             block: torch.Tensor) -> Tuple[Nu3State, torch.Tensor]:
    """One N-block through the three-stage engine (outputs match the
    uniform engine to float rounding). The structure of ``step_nu``: the
    fire on phase R1-1 runs one step of the inner two-stage engine on the
    completed M1-block, which fires its far stage every R2 such steps."""
    phase = _phase(state, block)
    head, y_head = _head(K.step_hc, state.head, coeffs.head, block)
    return _cycle(state, block, phase, head, y_head,
                  lambda tail, mb: _step_nu_tiled_head(tail, coeffs.tail, mb))


def step_nu_crossfade_tiled_head(state: NuState, coeffs_old: NuCoeffs,
                                 coeffs_new: NuCoeffs, mblock: torch.Tensor,
                                 head_ramp: bool = True
                                 ) -> Tuple[NuState, torch.Tensor]:
    """``step_nu_crossfade`` with the head run through ``_tail_step`` /
    ``_bridge``: the inner engine's step during a three-stage transition.
    ``head_ramp=True`` ramps the head over the (M1-sized) change block; the
    first far fire after the change runs both far coefficient sets on one
    ring advance and stores a full-M2 ramp."""
    phase = _phase(state, mblock)
    if head_ramp:
        head, y_head = _bridge(state.head, coeffs_old.head, coeffs_new.head,
                               mblock)
    else:
        head, y_head = _tail_step(state.head, coeffs_new.head, mblock)
    return _cycle(state, mblock, phase, head, y_head,
                  lambda tail, mb: _bridge(tail, coeffs_old.tail,
                                           coeffs_new.tail, mb))


def step_nu3_crossfade(state: Nu3State, coeffs_old: Nu3Coeffs,
                       coeffs_new: Nu3Coeffs, block: torch.Tensor,
                       head_ramp: bool = True, inner_mode: str = "ramp"
                       ) -> Tuple[Nu3State, torch.Tensor]:
    """Glitch-free live filter change on the three-stage engine: the
    two-stage law applied per stage, each bridging at its own boundary
    (fftw_convolver.cpp:275-321's law, composed twice).

    - outer head: an intra-block ramp on the change block
      (``head_ramp=True``), the new coefficients afterwards;
    - inner engine: its first step after the change is its own ramp step
      (``inner_mode="ramp"``); later steps run ``inner_mode="hold"`` (new
      inner head, the far stage bridging at its first fire with a full-M2
      ramp). Once the far stage has fired the transition is complete.

    The caller tracks the stage from the block counter (``engine.session``):
    the outer fire is at ``cnt % r1 == r1 - 1``, and the inner step there
    sits at inner phase ``(cnt // r1) % r2``. Pending queues are never
    touched: they carry the old filter's output, where each ramp starts."""
    phase = _phase(state, block)
    if head_ramp:
        head, y_head = _head(_head_ramp, state.head, coeffs_old.head,
                             coeffs_new.head, block)
    else:
        head, y_head = _head(K.step_hc, state.head, coeffs_new.head, block)
    return _cycle(state, block, phase, head, y_head,
                  lambda tail, mb: step_nu_crossfade_tiled_head(
                      tail, coeffs_old.tail, coeffs_new.tail, mb,
                      head_ramp=inner_mode == "ramp"))


def process_blocks_nu3(state: Nu3State, coeffs: Nu3Coeffs,
                       blocks: torch.Tensor) -> Tuple[Nu3State, torch.Tensor]:
    """``step_nu3`` over blocks [B, C, N] from any phase -> (state,
    out [B, C, N])."""
    outs = []
    for blk in blocks:
        state, y = step_nu3(state, coeffs, blk)
        outs.append(y)
    return state, torch.stack(outs)
