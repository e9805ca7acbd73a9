"""The logical device mesh: an ``r x c`` (or ``pod x r x c``) grid of
blocks on one device.

Counterpart of what the reference takes from ``jax.sharding.Mesh`` and
``repro.compat.make_mesh``.  There, each block of an array sharded
``P(row, col)`` lives on its own device and a closure round runs under
``shard_map`` with collectives.  Here every block is a view of one padded
tensor on ``mesh.device``: the block partition, its padding and the two
schedules of a round (``core/distributed.py``) are kept, and each
collective becomes a read of the neighbouring blocks of that tensor.

A ``LogicalMesh`` answers what the reference reads off its mesh:

* ``axis_names`` — the axis names, in order;
* ``shape`` — a read-only mapping from axis name to its size, so
  ``mesh.shape["data"]`` works;
* ``devices`` — an object ndarray of the grid's shape whose entries are
  all ``mesh.device``, so ``mesh.devices.size`` is the block count
  ``r * c``.  The reference keys several decisions to
  ``mesh.devices.size > 1`` (the planner, the construction mode,
  ``build_sharded``'s worker and shard defaults, the mesh overlap
  route); with the same count a port build on a logical 2 x 2 grid
  writes the same ``stats`` as the reference on four host devices.

Two meshes are equal (and hash equal) when their axis names, shape and
device are.

A ``ProcessMesh`` is the same named grid with each block on its own rank
of a ``torch.distributed`` process group: rank ``k`` holds the block at
the row-major coordinates ``coords`` of ``k`` (the order of the
reference's ``mesh.devices``), one subgroup runs along each line of each
axis, and ``core/collectives.py`` moves panels between the ranks of an
axis.  It answers what a ``LogicalMesh`` answers, its ``devices`` holding
each rank's device, and never equals one; its ``tally`` counts the axis
collectives this rank runs on it.  Every rank calls each route
on it with the same arguments (SPMD) and gets the same answers.
"""
from __future__ import annotations

import math
import os
import types
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .collectives import Tally

__all__ = ["LogicalMesh", "make_mesh", "default_line_graph_mesh",
           "ProcessMesh", "make_process_mesh"]


def _grid(shape: Sequence[int], axis_names: Sequence[str]
          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``shape`` and ``axis_names`` as tuples, checked."""
    dims = tuple(int(s) for s in shape)
    names = tuple(str(a) for a in axis_names)
    if len(dims) != len(names):
        raise ValueError(f"mesh shape {dims} and axis names {names} "
                         f"differ in length")
    if any(d < 1 for d in dims):
        raise ValueError(f"mesh axes need sizes >= 1; got {dims}")
    if len(set(names)) != len(names):
        raise ValueError(f"mesh axis names repeat: {names}")
    return dims, names


class LogicalMesh:
    """A named grid of blocks on one torch device (see module docstring)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device):
        dims, names = _grid(shape, axis_names)
        self.axis_names: Tuple[str, ...] = names
        self.dims: Tuple[int, ...] = dims
        self.shape = types.MappingProxyType(dict(zip(names, dims)))
        self.device = torch.device(device)
        self.devices = np.full(dims, self.device, dtype=object)

    def _key(self):
        return (self.axis_names, self.dims, str(self.device))

    def __eq__(self, other) -> bool:
        return isinstance(other, LogicalMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={d}" for a, d in zip(self.axis_names,
                                                    self.dims))
        return f"LogicalMesh({axes}, device={self.device})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: DeviceLike = None) -> LogicalMesh:
    """A logical mesh of ``shape`` blocks named ``axes`` on ``device``
    (``None`` means ``"cuda"`` and raises without a CUDA device)."""
    return LogicalMesh(shape, axes, resolve_device(device))


def default_line_graph_mesh(axes: Tuple[str, str] = ("data", "model"), *,
                            device: DeviceLike = None) -> LogicalMesh:
    """2-D mesh over every visible device of ``device``'s kind, rows x cols
    as near-square as the count factors (4 -> 2x2, 2 -> 1x2, 1 -> 1x1,
    6 -> 2x3), as the reference's.  On one card, and for ``device="cpu"``,
    that is 1 x 1; a larger logical grid is asked for with ``make_mesh``.

    Near-square minimizes the allgather panel bytes per block per round
    (row panel m·m/c + column panel m·m/r is minimized at r ≈ c ≈ √P).
    """
    dev = resolve_device(device)
    nd = torch.cuda.device_count() if dev.type == "cuda" else 1
    r = max(1, int(np.floor(np.sqrt(nd))))
    while nd % r:
        r -= 1
    return LogicalMesh((r, nd // r), axes, dev)


def _default_group_world() -> int:
    """World size of the initialised default process group; raises if
    there is none (a mesh never starts one)."""
    import torch.distributed as tdist
    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError(
            "a ProcessMesh needs an initialised default process group "
            "(torch.distributed.init_process_group); it never starts one")
    return tdist.get_world_size()


class ProcessMesh:
    """A named grid of blocks, one block a rank of the default
    ``torch.distributed`` process group (see module docstring).

    ``rank`` / ``coords`` place this process on the grid; ``devices``
    holds every rank's device (gathered once at construction), so
    ``devices.size`` is the world size and every decision keyed to it is
    the reference's for that many devices; ``backend`` is the group's
    (``"gloo"`` or ``"nccl"``).  ``axis_group(axis)`` / ``axis_ranks``
    name the subgroup of this rank's line along ``axis`` (``None`` / one
    rank for an axis of size 1).  Equal (and hash equal) meshes have the
    same axes, shape, device, world, backend and rank."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device):
        import torch.distributed as tdist
        dims, names = _grid(shape, axis_names)
        world = _default_group_world()
        if math.prod(dims) != world:
            raise ValueError(
                f"mesh shape {dims} has {math.prod(dims)} blocks; the "
                f"process group has {world} ranks")
        self.axis_names: Tuple[str, ...] = names
        self.dims: Tuple[int, ...] = dims
        self.shape = types.MappingProxyType(dict(zip(names, dims)))
        self.device = torch.device(device)
        self.backend = str(tdist.get_backend())
        self.world_size = world
        self.rank = tdist.get_rank()
        self.coords: Tuple[int, ...] = tuple(
            int(c) for c in np.unravel_index(self.rank, dims))
        if self.backend == "nccl" and self.device.type == "cuda":
            # NCCL's object collectives and communicators use the
            # current device
            torch.cuda.set_device(self.device)
        per_rank = [None] * world
        tdist.all_gather_object(per_rank, str(self.device))
        self.devices = np.empty(dims, dtype=object)
        for k, dev in enumerate(per_rank):
            self.devices[np.unravel_index(k, dims)] = torch.device(dev)
        # one subgroup per line of every axis longer than 1, created in
        # the same order on every rank (new_group is collective)
        self._lines: Dict[str, Tuple[object, Tuple[int, ...]]] = {}
        grid = np.arange(world).reshape(dims)
        for k, axis in enumerate(names):
            if dims[k] == 1:
                continue
            for line in np.moveaxis(grid, k, -1).reshape(-1, dims[k]):
                ranks = tuple(int(r) for r in line)
                group = tdist.new_group(list(ranks))
                if self.rank in ranks:
                    self._lines[axis] = (group, ranks)
        # pinned host buffers of the gloo route, reused across rounds
        self._staging: Dict[tuple, torch.Tensor] = {}
        # the axis collectives run on this mesh (core/collectives.py)
        self.tally = Tally()

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def axis_group(self, axis: str):
        """The subgroup of this rank's line along ``axis`` (``None`` for
        an axis of size 1)."""
        self.shape[axis]                       # KeyError for an unknown axis
        line = self._lines.get(axis)
        return None if line is None else line[0]

    def axis_ranks(self, axis: str) -> Tuple[int, ...]:
        """Global ranks of this rank's line along ``axis``, by coordinate."""
        line = self._lines.get(axis)
        return (self.rank,) if line is None else line[1]

    def staging(self, key: str, shape: Sequence[int],
                dtype: torch.dtype, grow: bool = False) -> torch.Tensor:
        """A host buffer named ``key`` of ``shape`` / ``dtype``, pinned
        when a card is present, kept for the next call of the same
        key and geometry.  With ``grow`` (a flat ``shape``, whose size
        changes from call to call) the kept buffer is replaced only by a
        larger one, and a view of its first entries is returned."""
        shape = tuple(int(s) for s in shape)
        buf = self._staging.get(key)
        if grow:
            if buf is None or buf.numel() < shape[0] or buf.dtype != dtype:
                buf = torch.empty(shape, dtype=dtype,
                                  pin_memory=torch.cuda.is_available())
                self._staging[key] = buf
            return buf[:shape[0]]
        if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype,
                              pin_memory=torch.cuda.is_available())
            self._staging[key] = buf
        return buf

    def _key(self):
        return (self.axis_names, self.dims, str(self.device),
                self.world_size, self.backend, self.rank)

    def __eq__(self, other) -> bool:
        return isinstance(other, ProcessMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(("process",) + self._key())

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={d}" for a, d in zip(self.axis_names,
                                                    self.dims))
        return (f"ProcessMesh({axes}, rank={self.rank}, coords={self.coords}"
                f", backend={self.backend}, device={self.device})")


def make_process_mesh(shape: Sequence[int], axes: Sequence[str], *,
                      device: DeviceLike = None) -> ProcessMesh:
    """A process mesh of ``shape`` blocks named ``axes`` over the
    initialised default process group, whose world size must be the block
    count.  ``device=None`` means ``cuda:<LOCAL_RANK>`` under NCCL (one
    card a rank) and ``cuda:0`` under gloo (ranks may share a card), and
    raises without a CUDA device; ``device="cpu"`` keeps blocks on the
    host."""
    if device is None:
        import torch.distributed as tdist
        _default_group_world()
        device = (f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
                  if tdist.get_backend() == "nccl" else "cuda:0")
    return ProcessMesh(shape, axes, resolve_device(device))
