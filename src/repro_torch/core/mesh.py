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
"""
from __future__ import annotations

import types
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["LogicalMesh", "make_mesh", "default_line_graph_mesh"]


class LogicalMesh:
    """A named grid of blocks on one torch device (see module docstring)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device):
        dims = tuple(int(s) for s in shape)
        names = tuple(str(a) for a in axis_names)
        if len(dims) != len(names):
            raise ValueError(f"mesh shape {dims} and axis names {names} "
                             f"differ in length")
        if any(d < 1 for d in dims):
            raise ValueError(f"mesh axes need sizes >= 1; got {dims}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
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
