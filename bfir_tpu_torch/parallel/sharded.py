"""Sharded engine execution over a device mesh.

Counterpart of ``bfir_tpu/parallel/sharded.py``: the explicit ring
schedule over a ``("c", "p")`` mesh (``parallel.mesh``). Channels are
sharded over "c"; the ring of delayed input spectra and the coefficient
partitions over "p". Per stage step, each shard sends its oldest ring slot
to its "p" neighbour (one ``ppermute_p`` of a [2, C/c, Hp] spectrum), MACs
its local partitions with the single-device kernel, and the partials meet
in one ``psum_p`` over "p". That is the whole communication of a step: one
ppermute and one psum per stage fire, each of 2·(C/c)·Hp·4 bytes at
float32, whatever the filter length (``parallel/COMM_MODEL.md`` of the
reference).

The per-shard bodies are the reference's ``shard_map`` bodies, run by
``mesh.shard_map`` on each process's shards. On a mesh that spans
processes (``mesh.init_distributed``) every process passes the whole input
block and receives the whole output, and its state and coefficient grids
hold its own shards only. The ring is *rolled* (slot j holds the
spectrum of j blocks ago), and each advance builds it out of place,
``[newest | ring[:-1]]`` as the reference's ``jnp.concatenate``: on a mesh
of repeated devices the received slot is the sender's own storage, so an
in-place shift would overwrite what a neighbour still has to read. That
copies a shard's ring once per stage fire. Differences from the reference:

- the frame spectrum is computed on the p = 0 shard only, its one consumer
  (the reference computes it on every shard and keeps it on shard 0);
- the block counters are host ints, so the fire decisions (the reference's
  ``lax.cond`` on the replicated counter) are host branches, identical on
  every shard;
- ``schedule="gspmd"`` (XLA's partitioner choosing the collectives) is
  not ported by design and raises ``ValueError``;
- ``process_batch`` on the complex local engine joins the state onto
  each process's first mesh device and runs
  ``core.convolver.process_batch`` there (the reference lets GSPMD
  partition it);
- the sharded engines take float32 or bf16 tail planes; integer tiers
  raise ``ValueError`` for every nu local engine.

Kernels per shard: K1 ``mac_hc`` (uniform hc local, the nu head, the nu3
outer head) and K2 ``mac_hc_tiled`` (the nu tail, the nu3 mid and far
stages), both at ring position 0 on chunk-reordered coefficients
(``_hc_chunk_reorder``); after the psum, K4 for tail inverses that
``core.nonuniform._tail_inverse`` sends to it (M <= 8192), ``torch.fft``
elsewhere. CPU shards run the kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bfir_tpu_torch.core import convolver as cv
from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.core.spec import FilterSpec
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.ops import fft as F
from bfir_tpu_torch.parallel import mesh as M
from bfir_tpu_torch.parallel.mesh import PPERMUTE, PSUM, Mesh

# PartitionSpecs of the reference's layouts
_P4 = ("p", None, "c", None)  # rolled hc rings [P, 2, C, Hp], coefficients
_P4_SHARED = ("p", None, None, None)  # shared coefficients [P, 2, 1, Hp]
_PC = ("c", None)  # prev_block, inbuf [C, N]; blocks
_PQ = (None, "c", None)  # pending [D, C, M]; block stacks [B, C, N]


def _block_grid(mesh: Mesh, block) -> np.ndarray:
    """An input block [C, N] (tensor or array) as its grid over "c" (views
    where the block already lies on a shard's device)."""
    if not torch.is_tensor(block):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return M.block_sharding(mesh).split(block, copy=False)


def _stack_grid(mesh: Mesh, blocks) -> np.ndarray:
    """Blocks [..., C, N] as their grid over "c"."""
    if not torch.is_tensor(blocks):
        blocks = torch.from_numpy(np.ascontiguousarray(blocks))
    spec = (None,) * (blocks.dim() - 2) + _PC
    return M.Sharding(mesh, spec).split(blocks, copy=False)


def _join_out(mesh: Mesh, out: np.ndarray) -> torch.Tensor:
    """Output shards [C/c, N] (replicated over "p") -> [C, N] on this
    process's first mesh device."""
    return M.block_sharding(mesh).join(out)


def _zip(mesh: Mesh, *grids) -> np.ndarray:
    """A grid of each shard's tuple of entries."""
    return mesh.grid(lambda ci, pi: tuple(g[ci, pi] for g in grids))


# ---------------------------------------------------------------------------
# The complex local engine (complex spectra, float32 or float64)
# ---------------------------------------------------------------------------


def _ring_body(mesh: Mesh, block_length: int):
    """The per-shard ring advance shared by the complex steps (a generator
    returning (ring, prev_block)): the frame spectrum on the p = 0 shard,
    every shard's oldest slot to the next "p" shard, and the new ring
    [newest | ring[:-1]] built out of place."""
    n = block_length

    def advance(pi, ring_l, prev_l, block_l):
        frame = torch.cat([prev_l, block_l.to(prev_l.dtype)], dim=-1)
        recv = yield PPERMUTE, ring_l[-1]
        newest = F.rfft(frame) if pi == 0 else recv
        return torch.cat([newest[None], ring_l[:-1]], dim=0), frame[:, n:]

    return advance


def make_ppermute_step(mesh: Mesh, spec: FilterSpec, n_channels: int):
    """The ring schedule on complex spectra: state is a
    ``core.convolver.ConvolverState`` of grids in the rolled layout (ring
    [P, C, F] over ("p", "c")), blocks and outputs [C, N]. Same outputs as
    ``core.convolver.step_rolled``."""
    n = spec.block_length
    advance = _ring_body(mesh, n)

    def body(pi, ring_l, prev_l, coeffs_l, block_l):
        ring_l, prev_l = yield from advance(pi, ring_l, prev_l, block_l)
        y = yield PSUM, (coeffs_l * ring_l).sum(dim=0)
        return ring_l, prev_l, F.irfft(y)[..., n:]

    def step(state: cv.ConvolverState, coeffs, block):
        ring, prev, out = M.shard_map(mesh, body, state.spectra_ring,
                                      state.prev_block, coeffs,
                                      _block_grid(mesh, block))
        return (cv.ConvolverState(ring, prev, state.blockcounter + 1),
                _join_out(mesh, out))

    return step


def make_ppermute_crossfade_step(mesh: Mesh, spec: FilterSpec,
                                 n_channels: int):
    """The complex step during a filter change: one ring advance, both
    coefficient sets (a psum each), a linear ramp old -> new over the block
    (``core.convolver.step_crossfade``)."""
    n = spec.block_length
    advance = _ring_body(mesh, n)

    def body(pi, ring_l, prev_l, co_old, co_new, block_l):
        ring_l, prev_l = yield from advance(pi, ring_l, prev_l, block_l)
        y_old = yield PSUM, (co_old * ring_l).sum(dim=0)
        y_new = yield PSUM, (co_new * ring_l).sum(dim=0)
        return ring_l, prev_l, NU._ramp(F.irfft(y_old)[..., n:],
                                        F.irfft(y_new)[..., n:])

    def step(state: cv.ConvolverState, coeff_old, coeff_new, block):
        ring, prev, out = M.shard_map(mesh, body, state.spectra_ring,
                                      state.prev_block, coeff_old, coeff_new,
                                      _block_grid(mesh, block))
        return (cv.ConvolverState(ring, prev, state.blockcounter + 1),
                _join_out(mesh, out))

    return step


# ---------------------------------------------------------------------------
# The halfcomplex shard-local stages (K1, K2, K4)
# ---------------------------------------------------------------------------


def _hc_chunk_reorder(coeff: torch.Tensor, p_shards: int) -> torch.Tensor:
    """Reorder each p-shard's coefficient chunk so that the single-device
    MAC (K1/K2, which pairs coefficient i with ring slot ``(pos - i) mod
    P``) computes the rolled sum ``sum_j coeff[j] * ring[j]`` at pos = 0:
    local coefficient i must hold partition ``(P_l - i) mod P_l``, i.e.
    ``[c0, c_{P_l-1}, ..., c1]`` per chunk. Done once per filter."""
    p = coeff.shape[0]
    ch = coeff.reshape(p_shards, p // p_shards, *coeff.shape[1:])
    ch = torch.cat([ch[:, :1], ch[:, 1:].flip(1)], dim=1)
    return ch.reshape(p, *coeff.shape[1:])


def _hc_advance(pi, ring_l, prev_l, block_l):
    """Rolled advance of a halfcomplex ring [P_l, 2, C_l, Hp] on a block
    of any stage's size (a generator returning (ring, prev_block))."""
    n = block_l.shape[-1]
    hp = ring_l.shape[-1]
    frame = torch.cat([prev_l, block_l.to(prev_l.dtype)], dim=-1)
    recv = yield PPERMUTE, ring_l[-1]
    if pi == 0:
        hr, hi = F.rfft_split_hc(frame)
        pad = hp - hr.shape[-1]
        newest = torch.stack([torch.nn.functional.pad(hr, (0, pad)),
                              torch.nn.functional.pad(hi, (0, pad))]
                             ).to(ring_l.dtype)
    else:
        newest = recv
    return torch.cat([newest[None], ring_l[:-1]], dim=0), frame[:, n:]


def _local_mac(ring_l, coeff_l, tiled: bool):
    """The shard's rolled MAC on its contiguous [P_l, 2·C_l, Hp] view: K1,
    or K2 for a tail stage's planes (bf16 planes accumulate in float32);
    shared coefficients [P_l, 2, 1, Hp] serve every channel."""
    pl_, _, c_l, hp = ring_l.shape
    cs = coeff_l.shape[2]
    ring2 = ring_l.reshape(pl_, 2 * c_l, hp)
    coeff2 = coeff_l.reshape(pl_, 2 * cs, hp)
    if tiled:
        return K.mac_hc_tiled(ring2, coeff2, 0, tile=min(2048, hp))
    return K.mac_hc(ring2, coeff2, 0)


def _hc_tail(yr, yi, dtype, n: int) -> torch.Tensor:
    return F.irfft_hc_tail(yr.to(dtype), yi.to(dtype), n=2 * n)


def _head(pi, ring, prev, block, coeff):
    """A head stage at N: advance, K1, one stacked psum, the overlap-save
    tail. Returns (ring, prev, y [C_l, N])."""
    ring, prev = yield from _hc_advance(pi, ring, prev, block)
    yr, yi = _local_mac(ring, coeff, tiled=False)
    s = yield PSUM, torch.stack([yr, yi])
    return ring, prev, _hc_tail(s[0], s[1], prev.dtype, block.shape[-1])


def _head_ramp(pi, ring, prev, block, c_old, c_new):
    """The head on a filter-change block: one advance, both MACs riding one
    psum, each output's tail, ramped old -> new over the block."""
    n = block.shape[-1]
    ring, prev = yield from _hc_advance(pi, ring, prev, block)
    yo = _local_mac(ring, c_old, tiled=False)
    yn = _local_mac(ring, c_new, tiled=False)
    s = yield PSUM, torch.stack([yo[0], yo[1], yn[0], yn[1]])
    return ring, prev, NU._ramp(_hc_tail(s[0], s[1], prev.dtype, n),
                                _hc_tail(s[2], s[3], prev.dtype, n))


def _fire(pi, ring, prev, mblock, coeff):
    """A tail-stage fire on an M-block: advance, K2, one stacked psum, the
    tail inverse (K4 where ``_tail_inverse`` takes it). Returns (ring,
    prev, z [C_l, M])."""
    m = mblock.shape[-1]
    ring, prev = yield from _hc_advance(pi, ring, prev, mblock)
    zr, zi = _local_mac(ring, coeff, tiled=True)
    s = yield PSUM, torch.stack([zr, zi])
    return ring, prev, NU._tail_inverse(s[0], s[1], m)


def _bridge(pi, ring, prev, mblock, c_old, c_new):
    """The bridging fire of a live change: both coefficient sets on one
    advance, one psum, the M-block ramped old -> new."""
    m = mblock.shape[-1]
    ring, prev = yield from _hc_advance(pi, ring, prev, mblock)
    zo = _local_mac(ring, c_old, tiled=True)
    zn = _local_mac(ring, c_new, tiled=True)
    s = yield PSUM, torch.stack([zo[0], zo[1], zn[0], zn[1]])
    return ring, prev, NU._ramp(NU._tail_inverse(s[0], s[1], m),
                                NU._tail_inverse(s[2], s[3], m))


def make_ppermute_step_hc(mesh: Mesh, spec: FilterSpec, n_channels: int,
                          crossfade: bool = False):
    """The ring schedule with the single-device hc engine per shard: state
    a ``ConvolverState`` of grids with the rolled ring [P, 2, C, Hp], K1
    at pos = 0 on chunk-reordered coefficients, one stacked psum, the
    overlap-save tail (``ops.fft.irfft_hc_tail``). ``crossfade``: the
    two-coefficient step (old, new) with a ramp over the block. Shared
    coefficients [P, 2, 1, Hp] are told by their shape."""

    def body(pi, ring, prev, co, block):
        if crossfade:
            ring, prev, out = yield from _head_ramp(pi, ring, prev, block,
                                                    *co)
        else:
            ring, prev, out = yield from _head(pi, ring, prev, block, *co)
        return ring, prev, out

    def step(state: cv.ConvolverState, *coeffs_and_block):
        *coeffs, block = coeffs_and_block
        ring, prev, out = M.shard_map(mesh, body, state.spectra_ring,
                                      state.prev_block, _zip(mesh, *coeffs),
                                      _block_grid(mesh, block))
        return (cv.ConvolverState(ring, prev, state.blockcounter + 1),
                _join_out(mesh, out))

    return step


# ---------------------------------------------------------------------------
# The two-stage schedule: head every block, tail every R-th
# ---------------------------------------------------------------------------


def _nu_pad_tail(nuspec: NU.NuSpec, p_shards: int) -> NU.NuSpec:
    """p_tail rounded up to a multiple of the mesh "p" axis (the padding
    partitions carry zero coefficients: exact output, storage only)."""
    pt = -(-nuspec.p_tail // p_shards) * p_shards
    if pt == nuspec.p_tail:
        return nuspec
    return NU.NuSpec(nuspec.block_length, nuspec.ratio, nuspec.p_head, pt,
                     nuspec.dtype, nuspec.tail_store, nuspec.head_store)


def _nu_body(phase: int, ratio: int, head, fire):
    """The per-shard two-stage cycle (the reference's fire ``lax.cond`` as
    a host branch on ``phase``): ``head(pi, ring, prev, block, co)``, the
    block into ``inbuf`` (in place) and the output ``y + pending`` slice,
    and on the cycle's last phase ``fire(pi, ring, prev, inbuf, co)`` with
    its output pushed to the pending queue. Both stage functions are
    generators returning (ring, prev, y)."""

    def body(pi, h_ring, h_prev, t_ring, t_prev, inbuf, pending, block, co):
        n = block.shape[-1]
        h_ring, h_prev, y = yield from head(pi, h_ring, h_prev, block, co)
        off = phase * n
        inbuf[:, off:off + n] = block
        out = y + pending[0][:, off:off + n]
        if phase == ratio - 1:
            t_ring, t_prev, z = yield from fire(pi, t_ring, t_prev, inbuf, co)
            pending = NU._push_pending(pending, z)
        return h_ring, h_prev, t_ring, t_prev, inbuf, pending, out

    return body


def _nu_step(mesh: Mesh, ratio: int, head, fire, state: NU.NuState, coeffs,
             block):
    """One block of the two-stage body over the mesh; ``coeffs`` a tuple
    of coefficient grids, handed to ``head`` and ``fire`` per shard."""
    phase = state.head.blockcounter % ratio
    body = _nu_body(phase, ratio, head, fire)
    h_ring, h_prev, t_ring, t_prev, inbuf, pending, out = M.shard_map(
        mesh, body, state.head.ring, state.head.prev_block, state.tail.ring,
        state.tail.prev_block, state.inbuf, state.pending,
        _block_grid(mesh, block), _zip(mesh, *coeffs))
    fired = int(phase == ratio - 1)
    return NU.NuState(
        K.HcState(h_ring, h_prev, state.head.blockcounter + 1),
        K.HcState(t_ring, t_prev, state.tail.blockcounter + fired),
        inbuf, pending), _join_out(mesh, out)


def make_ppermute_step_nu(mesh: Mesh, nuspec: NU.NuSpec, n_channels: int):
    """Per-block sharded two-stage step: state ``NuState`` of grids with
    rolled rings [P, 2, C, Hp], coefficients ``NuCoeffs`` of grids. Outputs
    match ``core.nonuniform.step_nu`` to float rounding."""
    head = lambda pi, r, p_, b, co: _head(pi, r, p_, b, co[0])
    fire = lambda pi, r, p_, mb, co: _fire(pi, r, p_, mb, co[1])

    def step(state: NU.NuState, coeffs: NU.NuCoeffs, block):
        return _nu_step(mesh, nuspec.ratio, head, fire, state,
                        (coeffs.head, coeffs.tail), block)

    return step


def make_ppermute_step_nu_crossfade(mesh: Mesh, nuspec: NU.NuSpec,
                                    n_channels: int, head_ramp: bool = True):
    """Sharded ``core.nonuniform.step_nu_crossfade``: ``head_ramp=True`` is
    the change block (both head MACs, a ramp over the block), False the
    blocks after it (the new head); the first tail fire after the change
    runs both tail sets on one advance and stores a full-M ramp. The extra
    partials ride the same stacked psum."""
    if head_ramp:
        head = lambda pi, r, p_, b, co: _head_ramp(pi, r, p_, b, co[0], co[1])
    else:
        head = lambda pi, r, p_, b, co: _head(pi, r, p_, b, co[1])
    fire = lambda pi, r, p_, mb, co: _bridge(pi, r, p_, mb, co[2], co[3])

    def step(state: NU.NuState, coeffs_old: NU.NuCoeffs,
             coeffs_new: NU.NuCoeffs, block):
        return _nu_step(mesh, nuspec.ratio, head, fire, state,
                        (coeffs_old.head, coeffs_new.head, coeffs_old.tail,
                         coeffs_new.tail), block)

    return step


def make_ppermute_macro_nu(mesh: Mesh, nuspec: NU.NuSpec, n_channels: int):
    """One M-cycle (``mblocks`` [R, C, N]) from phase 0 in one pass over
    the mesh: R head steps, then the tail fire on the whole M-block (the
    sharded ``step_nu_macro``). Same outputs as R per-block steps."""
    n, ratio = nuspec.block_length, nuspec.ratio

    def body(pi, h_ring, h_prev, t_ring, t_prev, pending, mblocks, co):
        outs = []
        for i in range(ratio):
            h_ring, h_prev, y = yield from _head(pi, h_ring, h_prev,
                                                 mblocks[i], co[0])
            outs.append(y + pending[0][:, i * n:(i + 1) * n])
        inbuf = mblocks.transpose(0, 1).reshape(mblocks.shape[1], -1).to(
            h_prev.dtype)
        t_ring, t_prev, z = yield from _fire(pi, t_ring, t_prev, inbuf, co[1])
        pending = NU._push_pending(pending, z)
        return (h_ring, h_prev, t_ring, t_prev, inbuf, pending,
                torch.stack(outs))

    def macro(state: NU.NuState, coeffs: NU.NuCoeffs, mblocks):
        if state.head.blockcounter % ratio:
            raise ValueError("the macro step needs the state at phase 0, got "
                             f"blockcounter {state.head.blockcounter}")
        h_ring, h_prev, t_ring, t_prev, inbuf, pending, outs = M.shard_map(
            mesh, body, state.head.ring, state.head.prev_block,
            state.tail.ring, state.tail.prev_block, state.pending,
            _stack_grid(mesh, mblocks), _zip(mesh, coeffs.head, coeffs.tail))
        return NU.NuState(
            K.HcState(h_ring, h_prev, state.head.blockcounter + ratio),
            K.HcState(t_ring, t_prev, state.tail.blockcounter + 1),
            inbuf, pending), M.Sharding(mesh, _PQ).join(outs)

    return macro


# ---------------------------------------------------------------------------
# The three-stage schedule: outer head every block, the inner head every
# r1-th, the far stage every r1·r2-th
# ---------------------------------------------------------------------------


def _nu3_pad_far(spec3: NU.Nu3Spec, p_shards: int) -> NU.Nu3Spec:
    """The far stage's partitions rounded up to a multiple of the mesh "p"
    axis (zero coefficients in the padding: exact output)."""
    inner = _nu_pad_tail(spec3.inner, p_shards)
    if inner is spec3.inner:
        return spec3
    return NU.Nu3Spec(spec3.block_length, spec3.ratio1, spec3.p_head, inner)


def make_ppermute_step_nu3(mesh: Mesh, spec3: NU.Nu3Spec, n_channels: int):
    """Per-block sharded three-stage step: state ``Nu3State`` of grids with
    rolled rings, coefficients ``Nu3Coeffs`` of grids. The outer fire runs
    one step of the sharded inner two-stage engine (its head a tiled stage
    at M1), which fires its far stage every r2 such steps. Outputs match
    ``core.nonuniform.step_nu3`` to float rounding."""
    n, r1, r2 = spec3.block_length, spec3.ratio1, spec3.inner.ratio
    inner_head = lambda pi, r, p_, b, co: _fire(pi, r, p_, b, co[1])
    far = lambda pi, r, p_, mb, co: _fire(pi, r, p_, mb, co[2])

    def step(state: NU.Nu3State, coeffs: NU.Nu3Coeffs, block):
        phase = state.head.blockcounter % r1
        fires = phase == r1 - 1
        inner = state.tail
        i_phase = inner.head.blockcounter % r2
        inner_body = _nu_body(i_phase, r2, inner_head, far)

        def body(pi, h_ring, h_prev, o_inbuf, o_pending, ih_ring, ih_prev,
                 f_ring, f_prev, i_inbuf, i_pending, block, co):
            h_ring, h_prev, y = yield from _head(pi, h_ring, h_prev, block,
                                                 co[0])
            off = phase * n
            o_inbuf[:, off:off + n] = block
            out = y + o_pending[0][:, off:off + n]
            if fires:
                (ih_ring, ih_prev, f_ring, f_prev, i_inbuf, i_pending,
                 z) = yield from inner_body(pi, ih_ring, ih_prev, f_ring,
                                            f_prev, i_inbuf, i_pending,
                                            o_inbuf, co)
                o_pending = NU._push_pending(o_pending, z)
            return (h_ring, h_prev, o_inbuf, o_pending, ih_ring, ih_prev,
                    f_ring, f_prev, i_inbuf, i_pending, out)

        (h_ring, h_prev, o_inbuf, o_pending, ih_ring, ih_prev, f_ring, f_prev,
         i_inbuf, i_pending, out) = M.shard_map(
            mesh, body, state.head.ring, state.head.prev_block, state.inbuf,
            state.pending, inner.head.ring, inner.head.prev_block,
            inner.tail.ring, inner.tail.prev_block, inner.inbuf,
            inner.pending, _block_grid(mesh, block),
            _zip(mesh, coeffs.head, coeffs.tail.head, coeffs.tail.tail))
        far_fired = int(fires and i_phase == r2 - 1)
        return NU.Nu3State(
            K.HcState(h_ring, h_prev, state.head.blockcounter + 1),
            NU.NuState(
                K.HcState(ih_ring, ih_prev,
                          inner.head.blockcounter + int(fires)),
                K.HcState(f_ring, f_prev, inner.tail.blockcounter + far_fired),
                i_inbuf, i_pending),
            o_inbuf, o_pending), _join_out(mesh, out)

    return step


def make_ppermute_macro_nu3(mesh: Mesh, spec3: NU.Nu3Spec,
                            n_channels: int):
    """One super-cycle (``sblocks`` [r2, r1, C, N]) from phase 0 in one
    pass over the mesh, every phase static: r1·r2 outer heads, r2 inner
    fires, one far fire. Same outputs as r1·r2 per-block steps."""
    n, r1 = spec3.block_length, spec3.ratio1
    r2, m1 = spec3.inner.ratio, spec3.m1

    def body(pi, h_ring, h_prev, ih_ring, ih_prev, f_ring, f_prev, i_pending,
             o_pending, sblocks, co):
        c_l = sblocks.shape[2]
        dt = h_prev.dtype
        outs = []
        for j in range(r2):
            for i in range(r1):
                h_ring, h_prev, y = yield from _head(pi, h_ring, h_prev,
                                                     sblocks[j, i], co[0])
                outs.append(y + o_pending[0][:, i * n:(i + 1) * n])
            o_inbuf = sblocks[j].transpose(0, 1).reshape(c_l, r1 * n).to(dt)
            ih_ring, ih_prev, y_inner = yield from _fire(
                pi, ih_ring, ih_prev, o_inbuf, co[1])
            z = y_inner + i_pending[0][:, j * m1:(j + 1) * m1]
            if j == r2 - 1:
                i_inbuf = sblocks.permute(2, 0, 1, 3).reshape(c_l, -1).to(dt)
                f_ring, f_prev, zf = yield from _fire(pi, f_ring, f_prev,
                                                      i_inbuf, co[2])
                i_pending = NU._push_pending(i_pending, zf)
            o_pending = NU._push_pending(o_pending, z)
        return (h_ring, h_prev, ih_ring, ih_prev, f_ring, f_prev, i_inbuf,
                i_pending, o_inbuf, o_pending, torch.stack(outs))

    def macro(state: NU.Nu3State, coeffs: NU.Nu3Coeffs, sblocks):
        if state.head.blockcounter % (r1 * r2):
            raise ValueError("the macro step needs the state at super-cycle "
                             f"phase 0, got blockcounter "
                             f"{state.head.blockcounter}")
        inner = state.tail
        (h_ring, h_prev, ih_ring, ih_prev, f_ring, f_prev, i_inbuf, i_pending,
         o_inbuf, o_pending, outs) = M.shard_map(
            mesh, body, state.head.ring, state.head.prev_block,
            inner.head.ring, inner.head.prev_block, inner.tail.ring,
            inner.tail.prev_block, inner.pending, state.pending,
            _stack_grid(mesh, sblocks),
            _zip(mesh, coeffs.head, coeffs.tail.head, coeffs.tail.tail))
        return NU.Nu3State(
            head=K.HcState(h_ring, h_prev, state.head.blockcounter + r1 * r2),
            tail=NU.NuState(
                K.HcState(ih_ring, ih_prev, inner.head.blockcounter + r2),
                K.HcState(f_ring, f_prev, inner.tail.blockcounter + 1),
                i_inbuf, i_pending),
            inbuf=o_inbuf, pending=o_pending), M.Sharding(
                mesh, _PQ).join(outs)

    return macro


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

LOCAL_IMPLS = ("hc", "complex", "nonuniform", "nonuniform3")


def nu_geometry(spec: FilterSpec, p_shards: int,
                tail_store: str = "float32") -> NU.NuSpec:
    """The two-stage geometry the sharded engine builds for ``spec`` (the
    single-device one, its tail padded to the mesh)."""
    n = spec.block_length
    return _nu_pad_tail(NU.nu_geometry(spec.n_partitions * n, n, ratio=8,
                                       dtype=spec.dtype,
                                       tail_store=tail_store), p_shards)


def nu3_geometry(spec: FilterSpec, p_shards: int,
                 tail_store: str = "float32") -> NU.Nu3Spec:
    """The three-stage geometry the sharded engine builds for ``spec``."""
    n = spec.block_length
    return _nu3_pad_far(NU.nu3_geometry(spec.n_partitions * n, n, ratio1=8,
                                        ratio2=8, dtype=spec.dtype,
                                        tail_store=tail_store), p_shards)


def geometry_refusal(local_impl: str, spec: FilterSpec, p_shards: int,
                     nuspec=None) -> Optional[str]:
    """Why ``ShardedEngine`` refuses a non-uniform ``local_impl`` for this
    filter (None: it builds). ``nuspec``: the geometry it would build (the
    default one when None). The session decides its local engine from
    this, reaching the engine the reference's fall-through reaches."""
    taps = spec.n_partitions * spec.block_length
    if local_impl == "nonuniform3":
        nu = nuspec or nu3_geometry(spec, p_shards)
        if nu.p_head % p_shards or nu.inner.p_head % p_shards:
            return (f"nu3 head partitions ({nu.p_head} outer / "
                    f"{nu.inner.p_head} inner) not divisible by mesh "
                    f"p={p_shards}")
        if taps <= nu.p_head * spec.block_length + nu.inner.p_head * nu.m1:
            return (f"filter ({taps} taps) too short for the sharded "
                    "three-stage engine (outer+inner heads alone cover it)")
    elif local_impl == "nonuniform":
        nu = nuspec or nu_geometry(spec, p_shards)
        if nu.p_head % p_shards:
            return (f"nu head partitions ({nu.p_head}) not divisible by "
                    f"mesh p={p_shards}")
        if taps <= nu.p_head * spec.block_length:
            return (f"filter ({taps} taps) too short for the sharded "
                    f"non-uniform engine (head alone covers "
                    f"{nu.p_head * spec.block_length})")
    return None


class ShardedEngine:
    """Multi-device partitioned convolver on ``mesh``.

    ``local_impl``, the shard-local compute: "nonuniform" the two-stage
    schedule sharded per stage, "nonuniform3" the three-stage one, "hc" the
    uniform halfcomplex engine (K1), "complex" the complex-spectra engine
    (float64-capable). The default is "hc" on a CUDA mesh and "complex" on
    a CPU one (the reference: by its default backend). States and
    coefficients are the reference's NamedTuples whose tensors are grids
    (``parallel.mesh``); ``join_state`` / ``shard_state`` move them to and
    from the reference's global layout."""

    def __init__(self, spec: FilterSpec, n_channels: int, mesh: Mesh,
                 schedule: str = "ppermute", local_impl: Optional[str] = None,
                 nuspec=None, nu_tail_store: str = "float32",
                 shared_coeffs: bool = False):
        p_shards, c_shards = mesh.shape["p"], mesh.shape["c"]
        if spec.n_partitions % p_shards:
            raise ValueError(f"n_partitions {spec.n_partitions} not divisible "
                             f"by mesh p={p_shards}")
        if n_channels % c_shards:
            raise ValueError(f"n_channels {n_channels} not divisible by mesh "
                             f"c={c_shards}")
        if schedule != "ppermute":
            raise ValueError(
                f"schedule must be 'ppermute', got {schedule!r}"
                + (": the GSPMD schedule (XLA's partitioner choosing the "
                   "collectives) is not ported by design"
                   if schedule == "gspmd" else ""))
        if local_impl is None:
            local_impl = "hc" if mesh.device_type == "cuda" else "complex"
        if local_impl not in LOCAL_IMPLS:
            raise ValueError("local_impl must be hc, complex, nonuniform or "
                             f"nonuniform3, got {local_impl!r}")
        if (local_impl in ("nonuniform", "nonuniform3")
                and nu_tail_store in ("int16", "int24")):
            raise ValueError("integer tail storage is single-device only "
                             "(sharded engines support float32/bfloat16)")
        self.spec = spec
        self.n_channels = n_channels
        self.mesh = mesh
        self.schedule = schedule
        self.local_impl = local_impl
        self.shared_coeffs = bool(shared_coeffs) and local_impl != "complex"
        self.nuspec = None
        self._nu_xfade = None
        self._xfade = None
        if local_impl == "nonuniform3":
            nuspec = (_nu3_pad_far(nuspec, p_shards) if nuspec else
                      nu3_geometry(spec, p_shards, nu_tail_store))
        elif local_impl == "nonuniform":
            nuspec = (_nu_pad_tail(nuspec, p_shards) if nuspec else
                      nu_geometry(spec, p_shards, nu_tail_store))
        refusal = geometry_refusal(local_impl, spec, p_shards, nuspec)
        if refusal:
            raise ValueError(refusal)
        self._layouts(nuspec)

    def _layouts(self, nuspec) -> None:
        """Shardings, zero-state shapes and step functions per local
        engine."""
        mesh, spec, c = self.mesh, self.spec, self.n_channels
        S = lambda s: M.Sharding(mesh, s)
        dt = getattr(torch, spec.dtype)
        n = spec.block_length
        hp_of = lambda m: -(-m // 128) * 128
        co = S(_P4_SHARED if self.shared_coeffs else _P4)
        hc_sh = lambda: K.HcState(S(_P4), S(_PC), None)
        hc_zero = lambda p, blk, rdt: K.HcState(
            ((p, 2, c, hp_of(blk)), rdt), ((c, blk), dt), 0)
        local = self.local_impl
        self._macro_fn = None
        if local == "nonuniform3":
            self.nuspec = nuspec
            inner = nuspec.inner
            m1, m2 = nuspec.m1, inner.m
            dt_far = torch.bfloat16 if inner.tail_store == "bfloat16" else dt
            self._state_shardings = NU.Nu3State(
                hc_sh(), NU.NuState(hc_sh(), hc_sh(), S(_PC), S(_PQ)),
                S(_PC), S(_PQ))
            self._zero = NU.Nu3State(
                hc_zero(nuspec.p_head, n, dt),
                NU.NuState(hc_zero(inner.p_head, m1, dt),
                           hc_zero(inner.p_tail, m2, dt_far),
                           ((c, m2), dt), ((inner.delay_blocks, c, m2), dt)),
                ((c, m1), dt), ((nuspec.delay_blocks, c, m1), dt))
            self._coeff_sharding = NU.Nu3Coeffs(co, NU.NuCoeffs(co, co))
            self._step_fn = make_ppermute_step_nu3(mesh, nuspec, c)
            self._macro_fn = make_ppermute_macro_nu3(mesh, nuspec, c)
        elif local == "nonuniform":
            self.nuspec = nuspec
            m = nuspec.m
            dt_tail = (torch.bfloat16 if nuspec.tail_store == "bfloat16"
                       else dt)
            self._state_shardings = NU.NuState(hc_sh(), hc_sh(), S(_PC),
                                               S(_PQ))
            self._zero = NU.NuState(
                hc_zero(nuspec.p_head, n, dt),
                hc_zero(nuspec.p_tail, m, dt_tail), ((c, m), dt),
                ((nuspec.delay_blocks, c, m), dt))
            self._coeff_sharding = NU.NuCoeffs(co, co)
            self._step_fn = make_ppermute_step_nu(mesh, nuspec, c)
            self._macro_fn = make_ppermute_macro_nu(mesh, nuspec, c)
        elif local == "hc":
            self._state_shardings = cv.ConvolverState(S(_P4), S(_PC), None)
            self._zero = cv.ConvolverState(
                ((spec.n_partitions, 2, c, hp_of(n)), dt), ((c, n), dt), 0)
            self._coeff_sharding = co
            self._step_fn = make_ppermute_step_hc(mesh, spec, c)
        else:
            cdt = torch.complex64 if dt == torch.float32 else torch.complex128
            st = M.state_shardings(mesh)
            self._state_shardings = cv.ConvolverState(
                st["spectra_ring"], st["prev_block"], None)
            self._zero = cv.ConvolverState(
                ((spec.n_partitions, c, spec.n_freq), cdt), ((c, n), dt), 0)
            self._coeff_sharding = M.coeff_sharding(mesh)
            self._step_fn = make_ppermute_step(mesh, spec, c)

    # -- state and coefficients ---------------------------------------------

    def init_state(self):
        """Zeroed state, made per shard on its device."""
        return M.zeros_tree(self._state_shardings, self._zero)

    def shard_state(self, state):
        """A state of global tensors in the reference's layout (rolled
        rings) -> this engine's state of grids."""
        return M.split_tree(self._state_shardings, state)

    def join_state(self, state, device=None):
        """This engine's state -> global tensors on ``device`` (default
        this process's first mesh device), in the reference's layout."""
        return M.join_tree(self._state_shardings, state, device)

    def shard_coeffs(self, coeffs):
        return M.split_tree(self._coeff_sharding, coeffs)

    def join_coeffs(self, coeffs, device=None):
        return M.join_tree(self._coeff_sharding, coeffs, device)

    def prepare_coeffs(self, impulse, scale: float = 1.0,
                       precise: bool = False):
        """Coefficient grids of ``impulse`` ([taps] or [C, taps]): the
        single-device planes, built on the host, each halfcomplex plane
        set in the rolled shard layout [P, 2, C | 1, Hp] with its chunks
        reordered for K1/K2 at pos = 0, then split over the mesh."""
        cpu = torch.device("cpu")
        c, local = self.n_channels, self.local_impl
        p_shards = self.mesh.shape["p"]
        shared = self.shared_coeffs

        def reorder(plane):  # [P, 2·cs, Hp] -> rolled shard layout
            p, c2, hp = plane.shape
            return _hc_chunk_reorder(plane.reshape(p, 2, c2 // 2, hp),
                                     p_shards)

        if local == "nonuniform3":
            co = NU.nu3_coeffs(impulse, self.nuspec, c, scale=scale,
                               precise=precise, shared=shared, device=cpu)
            co = NU.Nu3Coeffs(reorder(co.head),
                              NU.NuCoeffs(reorder(co.tail.head),
                                          reorder(co.tail.tail)))
        elif local == "nonuniform":
            co = NU.nu_coeffs(impulse, self.nuspec, c, scale=scale,
                              precise=precise, shared=shared, device=cpu)
            co = NU.NuCoeffs(reorder(co.head), reorder(co.tail))
        elif local == "hc":
            co = reorder(K.hc_coeffs(impulse, self.spec, c, scale=scale,
                                     precise=precise, shared=shared,
                                     device=cpu))
        else:
            imp = np.atleast_2d(np.asarray(impulse))
            imp = np.array(np.broadcast_to(imp, (c, imp.shape[-1])))
            co = cv.coeffs_to_spectra(imp, self.spec, scale=scale, device=cpu)
        return self.shard_coeffs(co)

    # -- streaming ----------------------------------------------------------

    def step(self, state, coeffs, block):
        """One block [C, N] (a tensor on any device, or an array) -> (state,
        out [C, N] on this process's first mesh device)."""
        return self._step_fn(state, coeffs, block)

    def nu_crossfade_steps(self):
        """The (ramp, hold) crossfade steps of the sharded two-stage engine,
        the protocol of ``core.nonuniform.step_nu_crossfade`` (the session
        drives it)."""
        if self.local_impl != "nonuniform":
            raise ValueError("nu_crossfade_steps is the two-stage engine's "
                             f"protocol; this engine runs {self.local_impl!r}")
        if self._nu_xfade is None:
            self._nu_xfade = tuple(
                make_ppermute_step_nu_crossfade(self.mesh, self.nuspec,
                                                self.n_channels, head_ramp=hr)
                for hr in (True, False))
        return self._nu_xfade

    def step_crossfade(self, state, coeff_old, coeff_new, block):
        """Glitch-free filter change: one block ramped old -> new (the
        uniform engines; the two-stage engine's change block, whose
        transition continues through ``nu_crossfade_steps``)."""
        if self.local_impl == "nonuniform3":
            raise NotImplementedError(
                "sharded nonuniform3 reconfigures by rebuild, not crossfade")
        if self.local_impl == "nonuniform":
            ramp, _ = self.nu_crossfade_steps()
            return ramp(state, coeff_old, coeff_new, block)
        if self._xfade is None:
            self._xfade = (
                make_ppermute_step_hc(self.mesh, self.spec, self.n_channels,
                                      crossfade=True)
                if self.local_impl == "hc" else
                make_ppermute_crossfade_step(self.mesh, self.spec,
                                             self.n_channels))
        return self._xfade(state, coeff_old, coeff_new, block)

    def _cycle_len(self) -> int:
        """Blocks per macro step (0: no macro form)."""
        if self.local_impl == "nonuniform3":
            return self.nuspec.ratio1 * self.nuspec.inner.ratio
        if self.local_impl == "nonuniform":
            return self.nuspec.ratio
        return 0

    def process_blocks(self, state, coeffs, blocks):
        """Blocks [B, C, N] -> (state, out [B, C, N]), streaming-exact. On
        the non-uniform engines, work aligned to the macro cycle (B a
        multiple of it, the state at its phase 0) takes the macro steps;
        otherwise the block loop."""
        if not torch.is_tensor(blocks):
            blocks = torch.from_numpy(np.ascontiguousarray(blocks))
        b, c, n = blocks.shape
        cyc = self._cycle_len()
        if cyc and b % cyc == 0 and state.head.blockcounter % cyc == 0:
            shape = ((self.nuspec.inner.ratio, self.nuspec.ratio1)
                     if self.local_impl == "nonuniform3" else (cyc,))
            outs = []
            for cycle in blocks.reshape(b // cyc, *shape, c, n):
                state, y = self._macro_fn(state, coeffs, cycle)
                outs.append(y)
            return state, torch.cat(outs)
        outs = []
        for blk in blocks:
            state, y = self.step(state, coeffs, blk)
            outs.append(y)
        return state, torch.stack(outs)

    def process_batch(self, state, coeffs, blocks):
        """Bulk form over [B, C, N]: on the complex engine
        ``core.convolver.process_batch`` on the state and coefficients
        joined onto this process's first mesh device (rolled <-> pointer
        ring on the way in and out, so ``step`` and ``process_batch``
        interoperate; every process of the mesh runs it whole); on the
        halfcomplex engines ``process_blocks``."""
        if self.local_impl != "complex":
            return self.process_blocks(state, coeffs, blocks)
        dev = self.mesh.local_device
        if not torch.is_tensor(blocks):
            blocks = torch.from_numpy(np.ascontiguousarray(blocks))
        st = cv.state_from_rolled(self.join_state(state))
        st, outs = cv.process_batch(st, self.join_coeffs(coeffs),
                                    blocks.to(dev))
        return self.shard_state(cv.rolled_from_state(st)), outs


def dryrun(n_devices: Optional[int] = None,
           mesh: Optional[Mesh] = None) -> None:
    """One sharded run on tiny shapes per local engine over ``mesh`` (or a
    mesh of the first ``n_devices`` CUDA devices, all of them by default),
    each checked against the single-device engine on this process's
    first mesh device (max abs error 1e-5 for the uniform engines, 1e-4
    for the non-uniform ones, the reference's bounds)."""
    if mesh is None:
        nd = n_devices or (torch.cuda.device_count()
                           if torch.cuda.is_available() else 1)
        devs = (None if n_devices is None else
                [torch.device("cuda", i) for i in range(n_devices)])
        mesh = M.make_mesh(channel_shards=2 if nd % 2 == 0 and nd > 1 else 1,
                           devices=devs)
    m = mesh
    dev = m.local_device
    c = 2 * m.shape["c"]
    p = 2 * m.shape["p"]
    spec = FilterSpec(block_length=128, n_partitions=p, dtype="float32")
    rng = np.random.default_rng(0)
    h = (rng.standard_normal((c, spec.max_taps)) * 0.05).astype(np.float32)
    x = rng.standard_normal((c, 4 * spec.block_length)).astype(np.float32)
    blocks = torch.from_numpy(x.reshape(c, 4, -1).transpose(1, 0, 2).copy())

    def check(err, bound, what):
        if not err <= bound:
            raise AssertionError(f"sharded {what} step diverged from "
                                 f"single-device: {err}")

    st2 = cv.init_state(spec, c, device=dev)
    co2 = cv.coeffs_to_spectra(h, spec, device=dev)
    refs = []
    for blk in blocks:
        st2, o2 = cv.step(st2, co2, blk.to(dev))
        refs.append(o2)
    for local in ("complex", "hc"):
        eng = ShardedEngine(spec, c, m, local_impl=local)
        st, co = eng.init_state(), eng.prepare_coeffs(h)
        err = 0.0
        for blk, ref in zip(blocks, refs):
            st, o = eng.step(st, co, blk)
            err = max(err, float((o.to(dev) - ref).abs().max()))
        check(err, 1e-5, local)

    n, p_shards = spec.block_length, m.shape["p"]
    nuspec = NU.NuSpec(block_length=n, ratio=2, p_head=4 * p_shards,
                       p_tail=p_shards, dtype="float32")
    r1 = r2 = 2
    inner3 = NU.NuSpec(block_length=r1 * n, ratio=r2,
                       p_head=int(np.lcm(2 * r2, p_shards)), p_tail=p_shards,
                       dtype="float32")
    spec3 = NU.Nu3Spec(block_length=n, ratio1=r1,
                       p_head=int(np.lcm(2 * r1, p_shards)), inner=inner3)
    for local, geo, init, mk, step in (
            ("nonuniform", nuspec, NU.init_nu_state, NU.nu_coeffs,
             NU.step_nu),
            ("nonuniform3", spec3, NU.init_nu3_state, NU.nu3_coeffs,
             NU.step_nu3)):
        taps = geo.max_taps
        spec_nu = FilterSpec(block_length=n, n_partitions=taps // n,
                             dtype="float32")
        h_nu = (rng.standard_normal((c, taps)) * 0.05).astype(np.float32)
        eng = ShardedEngine(spec_nu, c, m, local_impl=local, nuspec=geo)
        st, co = eng.init_state(), eng.prepare_coeffs(h_nu)
        st_ref = init(eng.nuspec, c, device=dev)
        co_ref = mk(h_nu, eng.nuspec, c, device=dev)
        nblocks = 2 * (nuspec.ratio if local == "nonuniform" else r1 * r2) + 1
        x_nu = rng.standard_normal((nblocks, c, n)).astype(np.float32)
        err = 0.0
        for blk in torch.from_numpy(x_nu):
            st, o = eng.step(st, co, blk)
            st_ref, o_ref = step(st_ref, co_ref, blk.to(dev))
            err = max(err, float((o.to(dev) - o_ref).abs().max()))
        check(err, 1e-4, local)
