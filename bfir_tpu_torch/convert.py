"""State and coefficients between ``bfir_tpu`` (as numpy) and this port.

The port keeps the reference's layouts field for field, so a stream
started in one package can resume in the other. ``*_from_numpy`` takes any
object with the reference NamedTuple's fields holding numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, state)``) and returns the
port's NamedTuple of tensors on ``device``; ``*_to_numpy`` returns the
port's NamedTuple holding numpy arrays, whose leaves flatten in the
reference's order. ``blockcounter`` is an int32 scalar in the reference
and a host int here. bf16 planes come back to numpy as float32 (numpy has
no bfloat16; the widening is exact).

``Nu3State`` (the three-stage engine, its ``tail`` a ``NuState``),
``PackedState``, ``SplitState``, ``DoubledState``, ``DelayState`` and
``OverflowStats`` convert field for field. ``DitherState`` carries ``e0``, ``e1`` and ``prev_byte``; the
reference's threefry ``key`` has no counterpart, so ``*_from_numpy`` seeds
the port's generator from ``seed`` and ``*_to_numpy`` returns
``generator=None`` (a reference state resumed from it takes a key of its
own). The dither noise after a move is therefore new noise, with the error
feedback carried over.

``DfState`` (the ``extended`` engine) is float64 here and a df64 pair of
float32 planes (hi, lo) in the reference: ``df_state_from_numpy`` sums each
pair in float64, and ``df_state_to_numpy`` splits back as the reference
splits a float64 input (hi = f32(x), lo = f32(x - hi)) into a
``DfStatePlanes`` with the reference's fields; ``df_coeffs_*`` do the same
for the coefficient pair.

Sharded states and coefficients (``parallel.sharded.ShardedEngine``) move
in the reference's global layout: ``ConvolverState`` with the rolled ring
([P, 2, C, Hp] halfcomplex, or [P, C, F] complex), ``NuState`` and
``Nu3State`` of rolled rings, and the chunk-reordered coefficient planes
[P, 2, C | 1, Hp]. ``sharded_*_from_numpy(x, engine)`` splits them into
the engine's shards and ``sharded_*_to_numpy(x, engine)`` joins them back,
so a sharded stream started in one package resumes in the other on a mesh
of the same shape.

``NuSplitState`` (the split-tail schedule) converts field for field too,
and a state made by ``bfir_tpu`` on the CPU resumes exactly at any phase.
One made on a TPU resumes exactly at every phase but 1: after phase 0 its
``xstage`` holds the TPU's staged mid-transform planes (the matmul
four-step split at its stage boundary), while the port's phase 0 stages
the finished halfcomplex transform and its phase 1 passes it through.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from bfir_tpu_torch.core.nonuniform import (Nu3Coeffs, Nu3State, NuCoeffs,
                                           NuSplitState, NuState)
from bfir_tpu_torch.kernels.extended import DfState
from bfir_tpu_torch.kernels.spectrum_mac import (DoubledState, HcState,
                                                 IntPlanes, PackedState,
                                                 SplitState)
from bfir_tpu_torch.ops.delay import DelayState
from bfir_tpu_torch.ops.dither import (DitherState, OverflowStats,
                                       init_dither_state)
from bfir_tpu_torch.parallel import mesh as M


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> tensor on ``device``."""
    a = np.array(a)  # a private, writable copy: steps update in place
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> a numpy copy (never a view: steps update state in place)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def planes_from_numpy(p, device):
    """A plane set: an array, or IntPlanes-like (``hi``, ``lo``, ``scale``)."""
    if hasattr(p, "hi"):
        return IntPlanes(hi=tensor_from_numpy(p.hi, device),
                         lo=(None if p.lo is None
                             else tensor_from_numpy(p.lo, device)),
                         scale=tensor_from_numpy(p.scale, device))
    return tensor_from_numpy(p, device)


def planes_to_numpy(p):
    if isinstance(p, IntPlanes):
        return IntPlanes(hi=tensor_to_numpy(p.hi),
                         lo=None if p.lo is None else tensor_to_numpy(p.lo),
                         scale=tensor_to_numpy(p.scale))
    return tensor_to_numpy(p)


def hc_state_from_numpy(st, device) -> HcState:
    return HcState(ring=planes_from_numpy(st.ring, device),
                   prev_block=tensor_from_numpy(st.prev_block, device),
                   blockcounter=int(np.asarray(st.blockcounter)))


def hc_state_to_numpy(st: HcState) -> HcState:
    return HcState(ring=planes_to_numpy(st.ring),
                   prev_block=tensor_to_numpy(st.prev_block),
                   blockcounter=np.asarray(st.blockcounter, dtype=np.int32))


def nu_state_from_numpy(st, device) -> NuState:
    return NuState(head=hc_state_from_numpy(st.head, device),
                   tail=hc_state_from_numpy(st.tail, device),
                   inbuf=tensor_from_numpy(st.inbuf, device),
                   pending=tensor_from_numpy(st.pending, device))


def nu_state_to_numpy(st: NuState) -> NuState:
    return NuState(head=hc_state_to_numpy(st.head),
                   tail=hc_state_to_numpy(st.tail),
                   inbuf=tensor_to_numpy(st.inbuf),
                   pending=tensor_to_numpy(st.pending))


def nu3_state_from_numpy(st, device) -> Nu3State:
    return Nu3State(head=hc_state_from_numpy(st.head, device),
                    tail=nu_state_from_numpy(st.tail, device),
                    inbuf=tensor_from_numpy(st.inbuf, device),
                    pending=tensor_from_numpy(st.pending, device))


def nu3_state_to_numpy(st: Nu3State) -> Nu3State:
    return Nu3State(head=hc_state_to_numpy(st.head),
                    tail=nu_state_to_numpy(st.tail),
                    inbuf=tensor_to_numpy(st.inbuf),
                    pending=tensor_to_numpy(st.pending))


def nu_split_state_from_numpy(st, device) -> NuSplitState:
    return NuSplitState(head=hc_state_from_numpy(st.head, device),
                        tail=hc_state_from_numpy(st.tail, device),
                        acc_r=tensor_from_numpy(st.acc_r, device),
                        acc_i=tensor_from_numpy(st.acc_i, device),
                        xstage=tensor_from_numpy(st.xstage, device),
                        inbuf=tensor_from_numpy(st.inbuf, device),
                        pending=tensor_from_numpy(st.pending, device))


def nu_split_state_to_numpy(st: NuSplitState) -> NuSplitState:
    return NuSplitState(head=hc_state_to_numpy(st.head),
                        tail=hc_state_to_numpy(st.tail),
                        acc_r=tensor_to_numpy(st.acc_r),
                        acc_i=tensor_to_numpy(st.acc_i),
                        xstage=tensor_to_numpy(st.xstage),
                        inbuf=tensor_to_numpy(st.inbuf),
                        pending=tensor_to_numpy(st.pending))


def nu_coeffs_from_numpy(co, device) -> NuCoeffs:
    return NuCoeffs(head=planes_from_numpy(co.head, device),
                    tail=planes_from_numpy(co.tail, device))


def nu_coeffs_to_numpy(co: NuCoeffs) -> NuCoeffs:
    return NuCoeffs(head=planes_to_numpy(co.head),
                    tail=planes_to_numpy(co.tail))


def nu3_coeffs_from_numpy(co, device) -> Nu3Coeffs:
    return Nu3Coeffs(head=planes_from_numpy(co.head, device),
                     tail=nu_coeffs_from_numpy(co.tail, device))


def nu3_coeffs_to_numpy(co: Nu3Coeffs) -> Nu3Coeffs:
    return Nu3Coeffs(head=planes_to_numpy(co.head),
                     tail=nu_coeffs_to_numpy(co.tail))


def packed_state_from_numpy(st, device) -> PackedState:
    return PackedState(ring=tensor_from_numpy(st.ring, device),
                       prev_block=tensor_from_numpy(st.prev_block, device),
                       blockcounter=int(np.asarray(st.blockcounter)))


def packed_state_to_numpy(st: PackedState) -> PackedState:
    return PackedState(ring=tensor_to_numpy(st.ring),
                       prev_block=tensor_to_numpy(st.prev_block),
                       blockcounter=np.asarray(st.blockcounter, dtype=np.int32))


def split_state_from_numpy(st, device) -> SplitState:
    return SplitState(ring_re=tensor_from_numpy(st.ring_re, device),
                      ring_im=tensor_from_numpy(st.ring_im, device),
                      prev_block=tensor_from_numpy(st.prev_block, device),
                      blockcounter=int(np.asarray(st.blockcounter)))


def split_state_to_numpy(st: SplitState) -> SplitState:
    return SplitState(ring_re=tensor_to_numpy(st.ring_re),
                      ring_im=tensor_to_numpy(st.ring_im),
                      prev_block=tensor_to_numpy(st.prev_block),
                      blockcounter=np.asarray(st.blockcounter, dtype=np.int32))


def doubled_state_from_numpy(st, device) -> DoubledState:
    return DoubledState(ring2=tensor_from_numpy(st.ring2, device),
                        prev_block=tensor_from_numpy(st.prev_block, device),
                        blockcounter=int(np.asarray(st.blockcounter)))


def doubled_state_to_numpy(st: DoubledState) -> DoubledState:
    return DoubledState(ring2=tensor_to_numpy(st.ring2),
                        prev_block=tensor_to_numpy(st.prev_block),
                        blockcounter=np.asarray(st.blockcounter,
                                                dtype=np.int32))


def dither_state_from_numpy(st, device, seed: int = 1) -> DitherState:
    """``e0``, ``e1`` and ``prev_byte`` of ``st``; a generator seeded from
    ``seed`` on ``device``."""
    e0 = tensor_from_numpy(st.e0, device)
    gen = init_dither_state(e0.shape[0], seed, e0.dtype,
                            device=device).generator
    return DitherState(e0=e0, e1=tensor_from_numpy(st.e1, device),
                       prev_byte=tensor_from_numpy(
                           np.asarray(st.prev_byte, dtype=np.int32), device),
                       generator=gen)


def dither_state_to_numpy(st: DitherState) -> DitherState:
    return DitherState(e0=tensor_to_numpy(st.e0), e1=tensor_to_numpy(st.e1),
                       prev_byte=tensor_to_numpy(st.prev_byte),
                       generator=None)


def delay_state_from_numpy(st, device) -> DelayState:
    return DelayState(history=tensor_from_numpy(st.history, device))


def delay_state_to_numpy(st: DelayState) -> DelayState:
    return DelayState(history=tensor_to_numpy(st.history))


def overflow_stats_from_numpy(of, device) -> OverflowStats:
    return OverflowStats(*(tensor_from_numpy(v, device) for v in of))


def overflow_stats_to_numpy(of: OverflowStats) -> OverflowStats:
    return OverflowStats(*(tensor_to_numpy(v) for v in of))


class DfStatePlanes(NamedTuple):
    """The reference's ``DfState`` fields, as numpy: each float64 array as
    a (hi, lo) float32 pair."""

    ring_hi: np.ndarray
    ring_lo: np.ndarray
    prev_hi: np.ndarray
    prev_lo: np.ndarray
    blockcounter: np.ndarray


def _join_df(hi, lo, device) -> torch.Tensor:
    """hi + lo, summed in float64, on ``device``."""
    return tensor_from_numpy(np.asarray(hi, dtype=np.float64)
                             + np.asarray(lo, dtype=np.float64), device)


def _split_df(t: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    x = tensor_to_numpy(t).astype(np.float64)
    hi = x.astype(np.float32)
    return hi, (x - hi.astype(np.float64)).astype(np.float32)


def df_state_from_numpy(st, device) -> DfState:
    return DfState(ring=_join_df(st.ring_hi, st.ring_lo, device),
                   prev=_join_df(st.prev_hi, st.prev_lo, device),
                   blockcounter=int(np.asarray(st.blockcounter)))


def df_state_to_numpy(st: DfState) -> DfStatePlanes:
    ring_hi, ring_lo = _split_df(st.ring)
    prev_hi, prev_lo = _split_df(st.prev)
    return DfStatePlanes(ring_hi, ring_lo, prev_hi, prev_lo,
                         np.asarray(st.blockcounter, dtype=np.int32))


def df_coeffs_from_numpy(pair, device) -> torch.Tensor:
    """The reference's ``df_coeffs`` pair (hi, lo) as one float64 plane."""
    return _join_df(pair[0], pair[1], device)


def df_coeffs_to_numpy(coeff: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    return _split_df(coeff)


def _global_from_numpy(template, x):
    """Leaves of ``x`` (a reference NamedTuple, or one array) as CPU
    tensors in ``template``'s NamedTuple types (its ``Sharding`` leaves
    mark tensors, None the host blockcounter)."""
    if isinstance(template, M.Sharding):
        return tensor_from_numpy(x, "cpu")
    if template is None:
        return int(np.asarray(x))
    return type(template)(*(_global_from_numpy(t, getattr(x, f))
                            for t, f in zip(template, template._fields)))


def _global_to_numpy(template, x):
    if isinstance(template, M.Sharding):
        return tensor_to_numpy(x)
    if template is None:
        return np.asarray(x, dtype=np.int32)
    return type(template)(*(_global_to_numpy(t, v)
                            for t, v in zip(template, x)))


def sharded_state_from_numpy(st, engine):
    """A reference sharded state (numpy leaves, global layout) -> the
    engine's state of shards."""
    tpl = engine._state_shardings
    return engine.shard_state(_global_from_numpy(tpl, st))


def sharded_state_to_numpy(st, engine):
    """The engine's state -> the same NamedTuples of numpy arrays in the
    reference's global layout (leaves in the reference's order)."""
    tpl = engine._state_shardings
    return _global_to_numpy(tpl, engine.join_state(st))


def sharded_coeffs_from_numpy(co, engine):
    tpl = engine._coeff_sharding
    return engine.shard_coeffs(_global_from_numpy(tpl, co))


def sharded_coeffs_to_numpy(co, engine):
    tpl = engine._coeff_sharding
    return _global_to_numpy(tpl, engine.join_coeffs(co))
