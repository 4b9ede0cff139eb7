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

The ring position a step reads is ``slot_order``, a device index, so the
step can be captured. ``GraphStep``, the session's step, runs ``step_df``'s
body on buffers of its own: on a CUDA device as one graph of the port's
graph mechanism (``utils.graphs``), replayed for each block in one
``engine.replay`` span and counted in ``engine.graph_replays``; on the CPU
eagerly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from bfir_tpu_torch.core.spec import FilterSpec
from bfir_tpu_torch.kernels.spectrum_mac import _round_up
from bfir_tpu_torch.ops import fft as F
from bfir_tpu_torch.utils import graphs as G
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


def slot_order(pos: int, p: int, device) -> torch.Tensor:
    """``mac_df``'s gather order at ring position ``pos``: [P] int64, entry
    i = (pos - i) mod P, the ring slot partition i reads; entry 0 is the
    slot a block's spectrum goes to."""
    return torch.remainder(pos - torch.arange(p, device=device), p)


def mac_df(ring: torch.Tensor, coeff: torch.Tensor,
           idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partition MAC on packed float64 planes: for each partition i,
    coeff[i] times ring slot ``idx[i]`` (``slot_order``), summed (lane 0 as
    two real products): ``mac_reference_hc``'s products, lane-0 law and
    sum, gathered in one pass over the packed ring at an order kept on the
    device, so a CUDA graph can hold it. ``coeff`` is [P, 2C, Hp] or shared
    [P, 2, Hp]. Returns (yr, yi), each [C, Hp]."""
    c = ring.shape[1] // 2
    cs = coeff.shape[1] // 2
    slots = ring.index_select(0, idx)
    rr, ri = slots[:, :c], slots[:, c:]
    coeff_re, coeff_im = coeff[:, :cs], coeff[:, cs:]
    p1 = coeff_re * rr
    p2 = coeff_im * ri
    a_r = p1 - p2
    a_i = coeff_re * ri + coeff_im * rr
    a_r[..., 0] = p1[..., 0]
    a_i[..., 0] = p2[..., 0]
    return a_r.sum(dim=0), a_i.sum(dim=0)


def _insert(ring: torch.Tensor, frame: torch.Tensor, idx: torch.Tensor,
            tr) -> None:
    """The spectrum of ``frame`` [C, 2N] float64 (the previous block, then
    this one) into ring slot ``idx[0]``, in place. ``tr``: the tracer, its
    ``engine.rfft`` span open since the frame's making, or None."""
    c = ring.shape[1] // 2
    hr, hi = F.rfft_split_hc(frame)
    if tr is not None:
        tr.next("engine.insert")
    h = hr.shape[-1]  # lanes [h, Hp) stay zero
    ring[:, :c, :h].index_copy_(0, idx[:1], hr[None])
    ring[:, c:, :h].index_copy_(0, idx[:1], hi[None])
    if tr is not None:
        tr.end()


def _render(ring, coeff, idx, n: int, tr) -> torch.Tensor:
    if tr is not None:
        tr.begin("engine.mac")
    yr, yi = mac_df(ring, coeff, idx)
    if tr is not None:
        tr.next("engine.irfft")
    out = F.irfft_hc_tail(yr, yi, n=2 * n)
    if tr is not None:
        tr.end()
    return out


def _step_at(ring: torch.Tensor, frame: torch.Tensor, idx: torch.Tensor,
             coeff: torch.Tensor, tr) -> torch.Tensor:
    """The block step on buffers updated in place, its ring position on the
    device: ``frame`` [C, 2N] float64 holds the previous block, then this
    one, and ``idx`` is ``slot_order`` at this block. Afterwards the frame's
    first half holds this block (the next step's previous block) and
    ``idx`` the next block's order. Returns the output [C, N] float64.
    ``tr``: the tracer, its ``engine.rfft`` span open, or None."""
    n = frame.shape[-1] // 2
    _insert(ring, frame, idx, tr)
    frame[:, :n].copy_(frame[:, n:])
    out = _render(ring, coeff, idx, n, tr)
    idx.add_(1).remainder_(ring.shape[0])
    return out


def _frame(state: DfState, block: torch.Tensor, tr):
    """(frame, idx): ``state.prev`` then the block at float64, [C, 2N], and
    ``slot_order`` at the state's block. Opens the ``engine.rfft`` span of
    ``tr`` (the tracer, or None)."""
    if tr is not None:
        tr.begin("engine.rfft")
    frame = torch.cat([state.prev, block.to(torch.float64)], dim=-1)
    return frame, slot_order(state.blockcounter, state.ring.shape[0],
                             frame.device)


def step_df(state: DfState, coeff: torch.Tensor,
            block: torch.Tensor) -> Tuple[DfState, torch.Tensor]:
    """One streaming block at float64: frame rfft, ring-slot insert, MAC,
    overlap-save tail. ``block`` [C, N] of any float dtype; the output
    [C, N] is float64."""
    n = block.shape[-1]
    tr = P.current()
    frame, idx = _frame(state, block, tr)
    out = _step_at(state.ring, frame, idx, coeff, tr)
    return DfState(state.ring, frame[:, :n], state.blockcounter + 1), out


def step_df_crossfade(state: DfState, coeff_old: torch.Tensor,
                      coeff_new: torch.Tensor,
                      block: torch.Tensor) -> Tuple[DfState, torch.Tensor]:
    """Glitch-free filter-change block: one ring advance, two MACs, and a
    linear ramp old -> new over the block (fftw_convolver.cpp:275-321)."""
    n = block.shape[-1]
    tr = P.current()
    frame, idx = _frame(state, block, tr)
    _insert(state.ring, frame, idx, tr)
    out_old = _render(state.ring, coeff_old, idx, n, tr)
    out_new = _render(state.ring, coeff_new, idx, n, tr)
    ramp = torch.arange(n, dtype=out_old.dtype, device=out_old.device) / (n - 1)
    out = out_old * (1.0 - ramp) + out_new * ramp
    return DfState(state.ring, frame[:, n:], state.blockcounter + 1), out


class GraphStep:
    """The session's ``extended`` step for one stream: called as
    ``step(state, coeff, block)`` and returning ``(state, out)`` as
    ``step_df`` does, with its body (``_step_at``) on buffers of its own:
    a ring, a frame whose first half is ``prev``, and the ring position on
    the device, ``idx``.

    On a CUDA device the body is one graph (``utils.graphs.StepGraphs``,
    whose rules say when it is captured and when the body runs eagerly
    instead): each block is copied into the frame, the graph replayed and
    its output cloned (the caller may hold many outputs at once). On the
    CPU the body runs eagerly.

    The returned state's ``ring`` and ``prev`` are the buffers themselves,
    which the next step updates in place. A state the step did not return
    last (a fresh one, a crossfade's, a restored one) is copied into the
    buffers and the position set from its ``blockcounter``: device copies,
    no sync. ``graphs`` counts the step's captures and replays."""

    def __init__(self):
        self._ring = self._frame = self._prev = self._idx = None
        self._state = None  # the state this step returned last
        self.graphs = G.StepGraphs(
            lambda _, coeff: _step_at(self._ring, self._frame, self._idx,
                                      coeff, None),
            self._warmup, "engine.graph_replays")

    def __call__(self, state: DfState, coeff: torch.Tensor,
                 block: torch.Tensor) -> Tuple[DfState, torch.Tensor]:
        n = block.shape[-1]
        if state is not self._state:
            self._load(state, n)
        tr = P.current()
        if self.graphs.ready(coeff, tr):
            if tr is not None:
                tr.begin("engine.replay")
            self._frame[:, n:].copy_(block)
            out = self.graphs.replay().clone()
            if tr is not None:
                tr.end()
        else:
            if tr is not None:
                tr.begin("engine.rfft")
            self._frame[:, n:].copy_(block)
            out = _step_at(self._ring, self._frame, self._idx, coeff, tr)
        self._state = DfState(self._ring, self._prev, state.blockcounter + 1)
        return self._state, out

    def _load(self, state: DfState, n: int) -> None:
        """Take up a state this step did not return last: its geometry's
        buffers (new ones, and no graph, where it changed), its planes and
        its position."""
        ring = state.ring
        if (self._ring is None or self._ring.shape != ring.shape
                or self._ring.device != ring.device
                or self._frame.shape[-1] != 2 * n):
            dev = ring.device
            self._ring = torch.zeros_like(ring)
            self._frame = torch.zeros((ring.shape[1] // 2, 2 * n),
                                      dtype=torch.float64, device=dev)
            self._prev = self._frame[:, :n]
            self._idx = torch.zeros(ring.shape[0], dtype=torch.int64,
                                    device=dev)
            self.graphs.reset(dev, 1)
        self._ring.copy_(ring)  # a copy onto itself is no copy
        self._prev.copy_(state.prev)
        self._idx.copy_(slot_order(state.blockcounter, ring.shape[0],
                                   ring.device))

    def _warmup(self, coeff: torch.Tensor) -> None:
        _step_at(self._ring.clone(), self._frame.clone(), self._idx.clone(),
                 coeff, None)
