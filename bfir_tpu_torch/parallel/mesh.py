"""Device mesh, shard layouts and the two collectives of the sharded engine.

Counterpart of ``bfir_tpu/parallel/mesh.py``. The reference is
single-controller: one process drives every device of a ``("c", "p")``
mesh, channels sharded over ``"c"`` and filter partitions over ``"p"``
(the reduce axis: each device MACs its partitions, the partials meet in a
sum over ``"p"``). This port keeps that model on one process:

- ``Mesh`` holds a 2-D numpy array of ``torch.device`` with the axis names
  ``("c", "p")``. A device may repeat: ``[cuda:0] * 4`` is a real (1, 4)
  mesh on one card, and ``["cpu"] * 8`` is the tests' mesh.
- Each shard is its own tensor on its mesh device. A sharded tensor is a
  *grid*: a numpy object array of shape (c, p) whose entry ``[ci, pi]`` is
  shard (ci, pi)'s local tensor. ``Sharding`` (jax's ``NamedSharding``)
  splits a global tensor into its grid and joins the grid back; an axis
  sharded over no mesh axis is replicated, one copy per shard.
- ``shard_map`` runs a per-shard body on every shard in lockstep. The body
  is a generator: ``recv = yield PPERMUTE, x`` and ``s = yield PSUM, x``
  are its collectives, served by ``ppermute_p`` and ``psum_p`` for all
  shards at once. Nothing else crosses devices inside a body.
- ``ppermute_p`` and ``psum_p`` add the payload bytes they move per device
  to a counter (``comm_counts`` / ``reset_comm_counts``), also where a
  repeated device makes the copy a no-op.

Multi-process meshes (``init_distributed`` with more than one process) are
not ported yet: ROADMAP #9b puts a ``torch.distributed`` process group
behind the same two collectives.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("c", "p")
PPERMUTE, PSUM = "ppermute", "psum"


class Mesh:
    """A ``("c", "p")`` grid of torch devices (``jax.sharding.Mesh``)."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"mesh devices must be a non-empty 2-D array, "
                             f"got shape {devices.shape}")
        self.devices = devices
        self.axis_names = AXES
        self.shape = {"c": devices.shape[0], "p": devices.shape[1]}

    @property
    def device_type(self) -> str:
        """"cuda" or "cpu": the one kind of device the mesh holds."""
        return self.devices.flat[0].type

    def grid(self, fn) -> np.ndarray:
        """(c, p) object array of ``fn(ci, pi)``."""
        out = np.empty(self.devices.shape, dtype=object)
        for ci, pi in np.ndindex(out.shape):
            out[ci, pi] = fn(ci, pi)
        return out

    def __repr__(self) -> str:
        return (f"Mesh(c={self.shape['c']}, p={self.shape['p']}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-process bring-up: a no-op for one process, as the reference."""
    if num_processes and num_processes > 1:
        raise NotImplementedError(
            "multi-process meshes are not ported to bfir_tpu_torch yet: "
            "ROADMAP Queue 1 #9b (a torch.distributed process group behind "
            "ppermute_p and psum_p)")


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh devices must be cuda or cpu, got {d!r}")
    return dev


def make_mesh(channel_shards: Optional[int] = None,
              partition_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("c", "p") mesh over ``devices`` (default: every visible
    CUDA device; raises without CUDA, nothing falls back to the CPU).
    Defaults: all devices on the partition axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() builds over the CUDA devices, but "
                               "CUDA is not available; pass devices "
                               "(e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"mesh devices must be of one type, got "
                         f"{sorted({d.type for d in devs})}")
    n = len(devs)
    if channel_shards is None and partition_shards is None:
        channel_shards, partition_shards = 1, n
    elif channel_shards is None:
        channel_shards = n // partition_shards
    elif partition_shards is None:
        partition_shards = n // channel_shards
    if channel_shards * partition_shards != n:
        raise ValueError(
            f"mesh {channel_shards}x{partition_shards} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(channel_shards, partition_shards))


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


class Sharding:
    """How a global tensor lies on the mesh (``NamedSharding(mesh,
    PartitionSpec(*spec))``): ``spec[k]`` is "c", "p" or None for axis k.
    A sharded axis is cut into equal contiguous pieces; shard (ci, pi)
    holds piece ci of the "c" axis and piece pi of the "p" axis."""

    def __init__(self, mesh: Mesh, spec: Tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def _slices(self, shape, ci: int, pi: int):
        idx = []
        for k, ax in enumerate(self.spec):
            if ax is None:
                idx.append(slice(None))
                continue
            parts = self.mesh.shape[ax]
            if shape[k] % parts:
                raise ValueError(f"axis {k} of size {shape[k]} does not "
                                 f"divide over mesh {ax}={parts}")
            size = shape[k] // parts
            i = ci if ax == "c" else pi
            idx.append(slice(i * size, (i + 1) * size))
        return tuple(idx)

    def local_shape(self, shape) -> Tuple[int, ...]:
        return tuple(s // self.mesh.shape[ax] if ax else s
                     for s, ax in zip(shape, self.spec))

    def split(self, t: torch.Tensor, copy: bool = True) -> np.ndarray:
        """The grid of ``t``'s shards, each on its mesh device; ``copy``
        gives every shard a contiguous tensor of its own (else a shard may
        be a view of ``t`` where ``t`` already lies on its device)."""
        if t.dim() != len(self.spec):
            raise ValueError(f"tensor of {t.dim()} dims for spec {self.spec}")

        def piece(ci, pi):
            dev = self.mesh.devices[ci, pi]
            x = t[self._slices(t.shape, ci, pi)]
            if copy:
                return x.to(dev, copy=True,
                            memory_format=torch.contiguous_format)
            return x.to(dev)

        return self.mesh.grid(piece)

    def zeros(self, shape, dtype) -> np.ndarray:
        """The grid of a global zero tensor of ``shape``, made per shard."""
        local = self.local_shape(shape)
        self._slices(shape, 0, 0)  # validates divisibility
        return self.mesh.grid(lambda ci, pi: torch.zeros(
            local, dtype=dtype, device=self.mesh.devices[ci, pi]))

    def join(self, g: np.ndarray, device=None) -> torch.Tensor:
        """The global tensor of grid ``g`` on ``device`` (default the mesh's
        first device); replicated axes take shard index 0."""
        dev = self.mesh.devices[0, 0] if device is None else device
        c_ax = self.spec.index("c") if "c" in self.spec else None
        p_ax = self.spec.index("p") if "p" in self.spec else None
        rows = []
        for ci in range(self.mesh.shape["c"] if c_ax is not None else 1):
            cols = [g[ci, pi].to(dev) for pi in
                    range(self.mesh.shape["p"] if p_ax is not None else 1)]
            rows.append(cols[0] if len(cols) == 1
                        else torch.cat(cols, dim=p_ax))
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=c_ax)


def state_shardings(mesh: Mesh) -> dict:
    """The complex engine's rolled state: ring [P, C, F] over ("p", "c"),
    prev_block [C, N] over "c" (replicated over "p"), blockcounter a host
    int."""
    return dict(spectra_ring=Sharding(mesh, ("p", "c", None)),
                prev_block=Sharding(mesh, ("c", None)),
                blockcounter=None)


def coeff_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ("p", "c", None))


def block_sharding(mesh: Mesh) -> Sharding:
    """Input and output blocks [C, N]: over channels, replicated over p."""
    return Sharding(mesh, ("c", None))


def split_tree(shardings, tree):
    """A NamedTuple of global tensors -> the same of grids, field by field
    with the matching NamedTuple of ``Sharding`` (None: a host value)."""
    if isinstance(shardings, Sharding):
        return shardings.split(tree)
    if shardings is None:
        return tree
    return type(tree)(*(split_tree(s, v) for s, v in zip(shardings, tree)))


def join_tree(shardings, tree, device=None):
    """Inverse of ``split_tree``."""
    if isinstance(shardings, Sharding):
        return shardings.join(tree, device)
    if shardings is None:
        return tree
    return type(tree)(*(join_tree(s, v, device)
                        for s, v in zip(shardings, tree)))


def zeros_tree(shardings, shapes):
    """Per-shard zeros for a NamedTuple of (shape, dtype) leaves; host
    values (None shardings) pass through."""
    if isinstance(shardings, Sharding):
        return shardings.zeros(*shapes)
    if shardings is None:
        return shapes
    return type(shapes)(*(zeros_tree(s, v) for s, v in zip(shardings, shapes)))


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

_COMM_LOCK = threading.Lock()
_COMM = {PPERMUTE: [0, 0], PSUM: [0, 0]}  # kind -> [calls, bytes per device]


def _count(kind: str, t: torch.Tensor) -> None:
    with _COMM_LOCK:
        _COMM[kind][0] += 1
        _COMM[kind][1] += t.numel() * t.element_size()


def comm_counts() -> dict:
    """{"ppermute": {"calls", "bytes"}, "psum": {...}}: collectives run
    since the last reset, and the payload bytes each moved per device."""
    with _COMM_LOCK:
        return {k: {"calls": v[0], "bytes": v[1]} for k, v in _COMM.items()}


def reset_comm_counts() -> None:
    with _COMM_LOCK:
        for v in _COMM.values():
            v[0] = v[1] = 0


def ppermute_p(mesh: Mesh, sent: np.ndarray) -> np.ndarray:
    """The ring rotation over "p": shard (c, i) receives shard (c, i-1)'s
    tensor (cyclically), copied to its device (a peer copy where the
    devices differ; the sender's own tensor where they are the same)."""
    p = mesh.shape["p"]
    _count(PPERMUTE, sent[0, 0])
    return mesh.grid(lambda ci, pi: sent[ci, (pi - 1) % p].to(
        mesh.devices[ci, pi], non_blocking=True))


def psum_p(mesh: Mesh, parts: np.ndarray) -> np.ndarray:
    """The sum over "p": each row's partials added in the fixed order
    i = 0..p-1 on the row's first device, the sum sent back to every shard
    of the row (the same bits on each)."""
    _count(PSUM, parts[0, 0])
    sums = []
    for ci in range(mesh.shape["c"]):
        root = mesh.devices[ci, 0]
        acc = parts[ci, 0].to(root)
        for pi in range(1, mesh.shape["p"]):
            acc = acc + parts[ci, pi].to(root, non_blocking=True)
        sums.append(acc)
    return mesh.grid(lambda ci, pi: sums[ci].to(mesh.devices[ci, pi],
                                                non_blocking=True))


_COLLECTIVES = {PPERMUTE: ppermute_p, PSUM: psum_p}


class _Done(NamedTuple):
    value: tuple


def _advance(gen, msg):
    try:
        return gen.send(msg)
    except StopIteration as stop:
        return _Done(stop.value)


def shard_map(mesh: Mesh, body, *grids) -> Tuple[np.ndarray, ...]:
    """Run ``body(pi, *locals)`` on every shard in lockstep
    (``jax.shard_map``); ``pi`` is the shard's index on "p" (the
    reference's ``axis_index("p")``) and ``locals`` its entries of
    ``grids``. ``body`` is a generator whose ``yield (PPERMUTE | PSUM,
    tensor)`` runs that collective over all shards at once and returns the
    shard's result; it returns a tuple, and ``shard_map`` returns one grid
    per element. Every shard must request the same collectives in the same
    order (the control flow may depend on host values only)."""
    gens = mesh.grid(lambda ci, pi: body(pi, *(g[ci, pi] for g in grids)))
    msgs = mesh.grid(lambda ci, pi: _advance(gens[ci, pi], None))
    while True:
        kinds = {m[0] if not isinstance(m, _Done) else None
                 for m in msgs.flat}
        if kinds == {None}:
            break
        if len(kinds) != 1:
            raise RuntimeError(f"shards diverged: they requested {kinds}")
        kind = kinds.pop()
        payload = mesh.grid(lambda ci, pi: msgs[ci, pi][1])
        got = _COLLECTIVES[kind](mesh, payload)
        msgs = mesh.grid(lambda ci, pi: _advance(gens[ci, pi], got[ci, pi]))
    n_out = len(msgs[0, 0].value)
    return tuple(mesh.grid(lambda ci, pi, k=k: msgs[ci, pi].value[k])
                 for k in range(n_out))
