"""Production mesh construction.

Counterpart of ``repro/launch/mesh.py``.  There a mesh is
``jax.sharding.Mesh`` over forced host devices or TPU chips; here it is
a ``core/mesh.py::LogicalMesh``, the same named grid of blocks on one
torch device, whose ``devices.size`` is the block count the reference
keys its decisions to.  Kept as functions (never module-level
constants), as in the reference, so importing this module touches no
device.
"""
from __future__ import annotations

from typing import Sequence

from ..core.mesh import LogicalMesh, make_mesh
from ..device import DeviceLike

__all__ = ["make_production_mesh", "make_test_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> LogicalMesh:
    """Single pod: 16 x 16 = 256 blocks, axes (data, model).
    Multi-pod: 2 x 16 x 16 = 512 blocks, axes (pod, data, model); the
    ``pod`` axis carries the threshold batch of the reachability closure.
    ``device=None`` means ``"cuda"`` and raises without a CUDA device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_test_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model"), *,
                   device: DeviceLike = None) -> LogicalMesh:
    """Small mesh for tests (``device="cpu"`` on a host without a card)."""
    return make_mesh(shape, axes, device=device)
