"""Collectives along one axis of a ``ProcessMesh`` (``core/mesh.py``).

The port's counterparts of what the reference's shard_map bodies call on
a mesh axis, written over ``torch.distributed``:

* ``all_gather_panel(block, mesh, axis, dim)`` — ``jax.lax.all_gather(
  block, axis, axis=dim, tiled=True)``: the blocks of this rank's line
  along ``axis`` concatenated along ``dim`` in coordinate order;
* ``ring_shift(block, mesh, axis)`` — ``jax.lax.ppermute(block, axis,
  perm=[(i, (i + 1) % n)])``: each rank sends its block to the next
  coordinate and receives the previous one's, as one
  ``batch_isend_irecv``;
* ``all_reduce_max(t, mesh, axis)`` — the elementwise max over the line.

Each returns a new tensor on the block's device and never writes its
input; on an axis of size 1 each is the identity (the input itself, no
call).  Under NCCL the tensors go to the collective as they are.  Under
gloo a CUDA tensor is staged through host buffers the mesh keeps (pinned,
reused across rounds) and copied back: gloo's own CUDA support is not
relied on.  A collective that fails raises; nothing falls back to a
logical route.

``gather_over`` / ``shift_over`` / ``max_over`` are the same transfers on
an explicit process group, what the mesh helpers call once they have
resolved the axis's subgroup and staging.

Only calls present in torch 2.11 and 2.13 are used
(``all_gather_into_tensor``, ``batch_isend_irecv``, ``all_reduce``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as tdist

__all__ = ["all_gather_panel", "ring_shift", "all_reduce_max",
           "gather_over", "shift_over", "max_over"]

# (key, shape, dtype) -> a host buffer kept for the next call
Stage = Callable[[str, Sequence[int], torch.dtype], torch.Tensor]


def _stage_for(t: torch.Tensor, mesh) -> Optional[Stage]:
    """The mesh's host buffers when ``t`` must cross through the host
    (gloo and a tensor off the CPU), else ``None``."""
    if mesh.backend == "nccl" or t.device.type == "cpu":
        return None
    return mesh.staging


def gather_over(t: torch.Tensor, group, n: int, dim: int = 0,
                stage: Optional[Stage] = None,
                key: str = "gather") -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group``, concatenated along ``dim`` in
    group-rank order (one ``all_gather_into_tensor``)."""
    src = t.contiguous()
    shape = tuple(src.shape)
    out_shape = (n * shape[0],) + shape[1:] if shape else (n,)
    if stage is None:
        send = src
        recv = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    else:
        send = stage(f"{key}:send", shape, src.dtype)
        send.copy_(src)
        recv = stage(f"{key}:recv", out_shape, src.dtype)
    tdist.all_gather_into_tensor(recv, send, group=group)
    out = recv if stage is None else recv.to(src.device, copy=True)
    if dim == 0 or not shape:
        return out
    stacked = out.view((n,) + shape).movedim(0, dim)
    return stacked.reshape(shape[:dim] + (n * shape[dim],) + shape[dim + 1:])


def shift_over(t: torch.Tensor, group, dst: int, src: int,
               stage: Optional[Stage] = None,
               key: str = "shift") -> torch.Tensor:
    """Send ``t`` to global rank ``dst`` and receive the same geometry
    from global rank ``src`` (one ``batch_isend_irecv``)."""
    block = t.contiguous()
    if stage is None:
        send = block
        recv = torch.empty_like(block)
    else:
        send = stage(f"{key}:send", block.shape, block.dtype)
        send.copy_(block)
        recv = stage(f"{key}:recv", block.shape, block.dtype)
    ops = [tdist.P2POp(tdist.isend, send, dst, group),
           tdist.P2POp(tdist.irecv, recv, src, group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return recv if stage is None else recv.to(block.device, copy=True)


def max_over(t: torch.Tensor, group, stage: Optional[Stage] = None,
             key: str = "max") -> torch.Tensor:
    """The elementwise max of ``t`` over ``group`` (one ``all_reduce``)."""
    if stage is None:
        out = t.contiguous().clone()
    else:
        out = stage(key, t.shape, t.dtype)
        out.copy_(t)
    tdist.all_reduce(out, op=tdist.ReduceOp.MAX, group=group)
    return out if stage is None else out.to(t.device, copy=True)


def all_gather_panel(block: torch.Tensor, mesh, axis: str,
                     dim: int) -> torch.Tensor:
    """The tiled all-gather of ``block`` along ``axis`` into ``dim``."""
    n = mesh.shape[axis]
    if n == 1:
        return block
    return gather_over(block, mesh.axis_group(axis), n, dim,
                       _stage_for(block, mesh), key=f"gather:{axis}:{dim}")


def ring_shift(block: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """One step of the ring along ``axis``: coordinate i's block goes to
    i + 1 (mod n); the block of i - 1 comes back."""
    n = mesh.shape[axis]
    if n == 1:
        return block
    ranks, i = mesh.axis_ranks(axis), mesh.axis_index(axis)
    return shift_over(block, mesh.axis_group(axis), ranks[(i + 1) % n],
                      ranks[(i - 1) % n], _stage_for(block, mesh),
                      key=f"ring:{axis}")


def all_reduce_max(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise max of ``t`` over this rank's line along ``axis``."""
    if mesh.shape[axis] == 1:
        return t
    return max_over(t, mesh.axis_group(axis), _stage_for(t, mesh),
                    key=f"max:{axis}")
