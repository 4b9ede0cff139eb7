"""Device mesh, shard layouts and the two collectives of the sharded engine.

Counterpart of ``bfir_tpu/parallel/mesh.py``. The reference drives a
``("c", "p")`` mesh from one controller per process: channels sharded over
"c" and filter partitions over "p" (the reduce axis: each device MACs its
partitions, the partials meet in a sum over "p"). This port keeps that
model:

- ``Mesh`` holds a 2-D numpy array of ``torch.device`` with the axis names
  ``("c", "p")``, and beside it the rank of the process that owns each
  entry. A device may repeat: ``[cuda:0] * 4`` is a real (1, 4) mesh on one
  card, and ``["cpu"] * 8`` is the tests' mesh.
- Each shard is its own tensor on its mesh device. A sharded tensor is a
  *grid*: a numpy object array of shape (c, p) whose entry ``[ci, pi]`` is
  shard (ci, pi)'s local tensor, or None where another process owns the
  shard. ``Sharding`` (jax's ``NamedSharding``) splits a global tensor into
  this process's shards and joins a grid back into the global tensor on
  every process; an axis sharded over no mesh axis is replicated, one copy
  per shard.
- ``shard_map`` runs a per-shard body on this process's shards in
  lockstep. The body is a generator: ``recv = yield PPERMUTE, x`` and
  ``s = yield PSUM, x`` are its collectives, served by ``ppermute_p`` and
  ``psum_p`` for all shards at once. Nothing else crosses devices inside a
  body.
- ``ppermute_p`` and ``psum_p`` add the payload bytes they move per device
  to a counter (``comm_counts`` / ``reset_comm_counts``), also where a
  repeated device makes the copy a no-op.

Several processes (``init_distributed``, the reference's
``jax.distributed.initialize``) form one ``torch.distributed`` group, and
``make_mesh`` then spans every rank's devices in rank order. What crosses
a process boundary moves by point-to-point messages of the group, posted
together (``torch.distributed.batch_isend_irecv``): the ring shift between
shards of different ranks, the partials to the rank that owns a row's
first shard and its sum back, and the pieces a join needs. The sum keeps
its fixed order, so a mesh that spans processes gives the same bits as the
same mesh on one process. Under gloo, CUDA payloads are staged through
host memory (gloo's send and receive do not check the device). The bytes
that cross are counted apart (``cross_process_bytes``).
"""

from __future__ import annotations

import datetime
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("c", "p")
PPERMUTE, PSUM, JOIN = "ppermute", "psum", "join"


class _Group(NamedTuple):
    """The process group ``init_distributed`` brought up."""
    rank: int
    world: int
    backend: str
    devices: Tuple[Tuple[torch.device, ...], ...]  # each rank's devices


# one group a process, as torch.distributed's default group it records
_GROUP: Optional[_Group] = None


def process_index() -> int:
    """This process's rank (``jax.process_index``): 0 without a group."""
    return _GROUP.rank if _GROUP else 0


def process_count() -> int:
    """The processes of the group (``jax.process_count``): 1 without one."""
    return _GROUP.world if _GROUP else 1


class Mesh:
    """A ``("c", "p")`` grid of torch devices (``jax.sharding.Mesh``) and
    the rank that owns each entry (default: this process, every entry)."""

    def __init__(self, devices: np.ndarray, ranks=None):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"mesh devices must be a non-empty 2-D array, "
                             f"got shape {devices.shape}")
        self.devices = devices
        self.ranks = (np.full(devices.shape, process_index()) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(
                          devices.shape))
        self.axis_names = AXES
        self.shape = {"c": devices.shape[0], "p": devices.shape[1]}
        me = process_index()
        self.local = [ij for ij in np.ndindex(devices.shape)
                      if self.ranks[ij] == me]
        if not self.local:
            raise ValueError(f"process {me} owns no shard of the mesh "
                             f"(ranks {sorted(set(self.ranks.flat))})")
        self.process_ranks = sorted({int(r) for r in self.ranks.flat})

    @property
    def device_type(self) -> str:
        """"cuda" or "cpu": the one kind of device the mesh holds."""
        return self.devices.flat[0].type

    @property
    def spans_processes(self) -> bool:
        return len(self.process_ranks) > 1

    @property
    def local_device(self) -> torch.device:
        """This process's first mesh device (the mesh's first device on one
        process)."""
        return self.devices[self.local[0]]

    def is_local(self, ci: int, pi: int) -> bool:
        return self.ranks[ci, pi] == process_index()

    def grid(self, fn) -> np.ndarray:
        """(c, p) object array of ``fn(ci, pi)`` on this process's shards,
        None on the others'."""
        out = np.empty(self.devices.shape, dtype=object)
        for ci, pi in self.local:
            out[ci, pi] = fn(ci, pi)
        return out

    def first_local(self, g: np.ndarray):
        """Grid ``g``'s entry at this process's first shard."""
        return g[self.local[0]]

    def __repr__(self) -> str:
        ranks = (f", ranks={self.ranks.flatten().tolist()}"
                 if self.spans_processes else "")
        return (f"Mesh(c={self.shape['c']}, p={self.shape['p']}, "
                f"devices={[str(d) for d in self.devices.flat]}{ranks})")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     local_device_ids: Optional[Sequence] = None,
                     timeout: float = 60.0) -> None:
    """Multi-process bring-up (``jax.distributed.initialize``; a no-op for
    one process): joins the ``torch.distributed`` group at ``coordinator``
    ("host:port", rank 0's address) as rank ``process_id`` of
    ``num_processes``, and learns every rank's devices.

    ``local_device_ids``: the devices this process owns (ints are CUDA
    ordinals; a device may repeat); default ``cuda:{process_id %
    device_count}`` where CUDA is available, else one CPU device.
    ``backend``: "nccl" (default for CUDA devices) or "gloo" (default for
    CPU devices; with CUDA devices only when asked for, its payloads staged
    through host memory). ``timeout``: seconds a rank waits in the group's
    set-up or in a message before it raises, so processes that diverge
    fail instead of hanging. Nothing falls back: a refused backend or a
    failed connection raises."""
    global _GROUP
    if not num_processes or num_processes <= 1:
        return
    import torch.distributed as dist

    if _GROUP is not None or (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("init_distributed: a process group is already up")
    if not coordinator:
        raise ValueError("init_distributed: more than one process needs the "
                         "coordinator's address, host:port")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"init_distributed: process_id {process_id!r} is "
                         f"not a rank of {num_processes} processes")
    if local_device_ids is None:
        local_device_ids = ([process_id % torch.cuda.device_count()]
                            if torch.cuda.is_available() else ["cpu"])
    devs = [_device(torch.device("cuda", d) if isinstance(d, int) else d)
            for d in local_device_ids]
    kinds = {d.type for d in devs}
    if len(kinds) != 1:
        raise ValueError(f"init_distributed: local devices must be of one "
                         f"type, got {local_device_ids!r}")
    if backend is None:
        backend = "nccl" if "cuda" in kinds else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_distributed: backend must be 'nccl' or "
                         f"'gloo', got {backend!r}")
    if not dist.is_available():
        raise RuntimeError("init_distributed: this torch has no "
                           "torch.distributed")
    if backend == "nccl":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError("init_distributed: backend 'nccl' needs CUDA "
                               "and a torch built with NCCL")
        if "cuda" not in kinds:
            raise ValueError("init_distributed: backend 'nccl' moves CUDA "
                             f"tensors, the local devices are {kinds}")
        torch.cuda.set_device(devs[0])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    every = [None] * num_processes
    dist.all_gather_object(every, [str(d) for d in devs])
    _GROUP = _Group(process_id, num_processes, backend,
                    tuple(tuple(torch.device(d) for d in r) for r in every))


def shutdown_distributed() -> None:
    """Leave the group ``init_distributed`` joined
    (``jax.distributed.shutdown``); a no-op without one."""
    global _GROUP
    if _GROUP is not None:
        import torch.distributed as dist

        _GROUP = None
        dist.destroy_process_group()


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh devices must be cuda or cpu, got {d!r}")
    return dev


def _entry(d) -> Tuple[Optional[int], torch.device]:
    """A ``make_mesh`` device: ``(rank, device)`` or a device alone."""
    if isinstance(d, tuple):
        rank, dev = d
        return int(rank), _device(dev)
    return None, _device(d)


def make_mesh(channel_shards: Optional[int] = None,
              partition_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("c", "p") mesh over ``devices``. Default: after
    ``init_distributed``, every rank's devices in rank order (as
    ``jax.devices()`` spans processes); else every visible CUDA device
    (raises without CUDA, nothing falls back to the CPU). In a process
    group each entry of ``devices`` is ``(rank, device)``, the device one
    of that rank's, and the ranks must cover the group. Defaults: all
    devices on the partition axis."""
    g = _GROUP
    if devices is None:
        if g is not None:
            entries = [(r, d) for r, devs in enumerate(g.devices)
                       for d in devs]
        elif not torch.cuda.is_available():
            raise RuntimeError("make_mesh() builds over the CUDA devices, but "
                               "CUDA is not available; pass devices "
                               "(e.g. ['cpu'] * 8)")
        else:
            entries = [(None, torch.device("cuda", i))
                       for i in range(torch.cuda.device_count())]
    else:
        entries = [_entry(d) for d in devices]
    for rank, dev in entries:
        if g is None and rank not in (None, 0):
            raise ValueError(f"mesh entry of rank {rank}, but there is no "
                             "process group: call init_distributed first")
        if g is not None and rank is None:
            raise ValueError("in a process group every mesh device names its "
                             "owner rank: (rank, device)")
        if g is not None and not (0 <= rank < g.world
                                  and dev in g.devices[rank]):
            raise ValueError(f"mesh entry {(rank, str(dev))}: rank {rank} "
                             f"does not own {dev}")
    devs = [d for _, d in entries]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"mesh devices must be of one type, got "
                         f"{sorted({d.type for d in devs})}")
    ranks = [r or 0 for r, _ in entries]
    if g is not None and set(ranks) != set(range(g.world)):
        raise ValueError(f"mesh ranks {sorted(set(ranks))} do not cover the "
                         f"group of {g.world} processes")
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
    shape = (channel_shards, partition_shards)
    return Mesh(arr.reshape(shape), np.array(ranks).reshape(shape))


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
        """The global tensor of grid ``g`` on ``device`` (default this
        process's first mesh device), on every process of the mesh;
        replicated axes take shard index 0. Each piece another process owns
        arrives from it once."""
        mesh = self.mesh
        dev = mesh.local_device if device is None else device
        c_ax = self.spec.index("c") if "c" in self.spec else None
        p_ax = self.spec.index("p") if "p" in self.spec else None
        n_c = mesh.shape["c"] if c_ax is not None else 1
        n_p = mesh.shape["p"] if p_ax is not None else 1
        msgs = [(mesh.ranks[ij], r, ij) for ij in np.ndindex(n_c, n_p)
                for r in mesh.process_ranks if r != mesh.ranks[ij]]
        got = _exchange(JOIN, msgs, g.__getitem__,
                        lambda ij: (mesh.first_local(g), dev))
        rows = []
        for ci in range(n_c):
            cols = [got[ci, pi].to(dev) if (ci, pi) in got else
                    g[ci, pi].to(dev) for pi in range(n_p)]
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
_CROSS = {PPERMUTE: [0, 0], PSUM: [0, 0], JOIN: [0, 0]}  # [sent, received]


def _count(kind: str, t: torch.Tensor) -> None:
    with _COMM_LOCK:
        _COMM[kind][0] += 1
        _COMM[kind][1] += t.numel() * t.element_size()


def comm_counts() -> dict:
    """{"ppermute": {"calls", "bytes"}, "psum": {...}}: collectives run
    since the last reset by this process, and the payload bytes each moved
    per device."""
    with _COMM_LOCK:
        return {k: {"calls": v[0], "bytes": v[1]} for k, v in _COMM.items()}


def cross_process_bytes() -> dict:
    """{"ppermute" | "psum" | "join": {"sent", "received"}}: the bytes this
    process sent to and received from other processes since the last
    reset."""
    with _COMM_LOCK:
        return {k: {"sent": v[0], "received": v[1]}
                for k, v in _CROSS.items()}


def reset_comm_counts() -> None:
    with _COMM_LOCK:
        for v in (*_COMM.values(), *_CROSS.values()):
            v[0] = v[1] = 0


class PeerError(RuntimeError):
    """A message between processes failed: a peer diverged, timed out or
    is gone."""


def _exchange(kind: str, msgs, payload, like) -> dict:
    """The messages ``msgs`` [(src rank, dst rank, key)], listed in the
    same order on every process, as one batch of point-to-point sends and
    receives: this process sends ``payload(key)`` where it is the source
    and receives a tensor shaped as ``like(key)[0]`` onto device
    ``like(key)[1]`` where it is the destination. Returns {key: received
    tensor}; nothing is posted where no message touches this process.
    Under gloo, CUDA payloads go through host memory."""
    me = process_index()
    mine = [(tag, m) for tag, m in enumerate(msgs) if me in m[:2]]
    if not mine:
        return {}
    import torch.distributed as dist

    host = _GROUP.backend == "gloo"
    ops, got, sent, received = [], {}, 0, 0
    for tag, (src, dst, key) in mine:
        if src == me:
            t = payload(key).contiguous()
            t = t.cpu() if host else t
            ops.append(dist.P2POp(dist.isend, t, int(dst), tag=tag))
            sent += t.numel() * t.element_size()
        else:
            tmpl, dev = like(key)
            buf = torch.empty(tmpl.shape, dtype=tmpl.dtype,
                              device="cpu" if host else dev)
            ops.append(dist.P2POp(dist.irecv, buf, int(src), tag=tag))
            got[key] = buf
            received += buf.numel() * buf.element_size()
    peers = sorted({int(m[0] if m[1] == me else m[1]) for _, m in mine})
    try:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    except RuntimeError as err:
        raise PeerError(f"{kind} between processes failed while rank {me} "
                        f"waited on rank(s) {peers}: {err}") from err
    with _COMM_LOCK:
        _CROSS[kind][0] += sent
        _CROSS[kind][1] += received
    return got


def ppermute_p(mesh: Mesh, sent: np.ndarray) -> np.ndarray:
    """The ring rotation over "p": shard (c, i) receives shard (c, i-1)'s
    tensor (cyclically), copied to its device (a peer copy where the
    devices differ; the sender's own tensor where they are the same; a
    message where another process owns the sender)."""
    p = mesh.shape["p"]
    _count(PPERMUTE, mesh.first_local(sent))
    src = lambda ci, pi: (ci, (pi - 1) % p)
    msgs = [(mesh.ranks[src(*ij)], mesh.ranks[ij], ij)
            for ij in np.ndindex(mesh.devices.shape)
            if mesh.ranks[src(*ij)] != mesh.ranks[ij]]
    got = _exchange(PPERMUTE, msgs, lambda ij: sent[src(*ij)],
                    lambda ij: (mesh.first_local(sent), mesh.devices[ij]))
    return mesh.grid(lambda ci, pi: got[ci, pi].to(mesh.devices[ci, pi])
                     if (ci, pi) in got else sent[src(ci, pi)].to(
                         mesh.devices[ci, pi], non_blocking=True))


def psum_p(mesh: Mesh, parts: np.ndarray) -> np.ndarray:
    """The sum over "p": each row's partials added in the fixed order
    i = 0..p-1 on the row's first device, the sum sent back to every shard
    of the row (the same bits on each). Partials of other processes go to
    the process that owns the row's first shard, and its sum goes once to
    each other process that owns a shard of the row."""
    _count(PSUM, mesh.first_local(parts))
    c, p = mesh.shape["c"], mesh.shape["p"]
    ranks, devices = mesh.ranks, mesh.devices
    tmpl = mesh.first_local(parts)
    msgs = [(ranks[ci, pi], ranks[ci, 0], (ci, pi))
            for ci in range(c) for pi in range(1, p)
            if ranks[ci, pi] != ranks[ci, 0]]
    got = _exchange(PSUM, msgs, parts.__getitem__,
                    lambda ij: (tmpl, devices[ij[0], 0]))
    sums = {}
    for ci in range(c):
        if not mesh.is_local(ci, 0):
            continue
        root = devices[ci, 0]
        acc = parts[ci, 0].to(root)
        for pi in range(1, p):
            part = got.get((ci, pi), parts[ci, pi])
            acc = acc + part.to(root, non_blocking=True)
        sums[ci] = acc
    owners = lambda ci: sorted({int(r) for r in ranks[ci]} - {ranks[ci, 0]})
    first = lambda ci, r: devices[ci, list(ranks[ci]).index(r)]
    back = [(ranks[ci, 0], r, (ci, r)) for ci in range(c) for r in owners(ci)]
    for (ci, _), s in _exchange(PSUM, back, lambda k: sums[k[0]],
                                lambda k: (tmpl, first(*k))).items():
        sums[ci] = s
    return mesh.grid(lambda ci, pi: sums[ci].to(devices[ci, pi],
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
    """Run ``body(pi, *locals)`` on this process's shards in lockstep
    (``jax.shard_map``); ``pi`` is the shard's index on "p" (the
    reference's ``axis_index("p")``) and ``locals`` its entries of
    ``grids``. ``body`` is a generator whose ``yield (PPERMUTE | PSUM,
    tensor)`` runs that collective over all shards at once and returns the
    shard's result; it returns a tuple, and ``shard_map`` returns one grid
    per element (None at other processes' shards). Every shard must
    request the same collectives in the same order (the control flow may
    depend on host values only): shards of this process that diverge
    raise at once, processes that diverge raise ``PeerError`` within the
    group's timeout."""
    gens = mesh.grid(lambda ci, pi: body(pi, *(g[ci, pi] for g in grids)))
    msgs = mesh.grid(lambda ci, pi: _advance(gens[ci, pi], None))
    while True:
        kinds = {msgs[ij][0] if not isinstance(msgs[ij], _Done) else None
                 for ij in mesh.local}
        if kinds == {None}:
            break
        if len(kinds) != 1:
            raise RuntimeError(f"shards diverged: they requested {kinds}")
        kind = kinds.pop()
        payload = mesh.grid(lambda ci, pi: msgs[ci, pi][1])
        try:
            got = _COLLECTIVES[kind](mesh, payload)
        except PeerError as err:
            raise PeerError(f"shard_map: the {kind} collective failed: "
                            f"{err}") from err
        msgs = mesh.grid(lambda ci, pi: _advance(gens[ci, pi], got[ci, pi]))
    n_out = len(mesh.first_local(msgs).value)
    return tuple(mesh.grid(lambda ci, pi, k=k: msgs[ci, pi].value[k])
                 for k in range(n_out))
