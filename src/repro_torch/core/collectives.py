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
* ``all_reduce_max(t, mesh, axis)`` / ``all_reduce_min`` — the
  elementwise max / min over the line;
* ``all_gather_ragged(t, mesh)`` — over the whole world group rather than
  one axis: each rank passes a flat int64 tensor of its own length and
  every rank gets the list of all of them in rank order (the sizes first,
  then one padded ``all_gather``).  What the reference moves between host
  and devices as Python objects (a shard's labels, a rank's neighbor
  rows) crosses as tensors here, so the bytes moved are the data's own.
  ``gather_ragged_or_raise`` is the same exchange where a rank may bring
  an error in place of its tensor: it still joins, and then every rank
  raises, so no rank waits on one that failed; ``agree_or_raise`` is the
  status word alone (one max-reduce of a flag; the errors' texts cross
  only when a rank failed);
* ``broadcast_from(t, mesh, src)`` — over the world group: every rank
  passes a flat int64 tensor of one length and gets ``src``'s contents
  (one ``broadcast``), what a leader rank uses to hand its decisions to
  the others;
* ``exchange_pieces(sends, shapes, like, mesh)`` — point to point over
  the world group, what a resharding ``jax.device_put`` moves: each rank
  sends each peer the piece of its block that the peer's new block
  holds, and receives its own pieces, all posted as one
  ``batch_isend_irecv``.

Each returns a new tensor on the block's device and never writes its
input; on an axis of size 1 each is the identity (the input itself, no
call).  Under NCCL the tensors go to the collective as they are.  Under
gloo a CUDA tensor is staged through host buffers the mesh keeps (pinned,
reused across rounds) and copied back: gloo's own CUDA support is not
relied on.  A collective that fails raises; nothing falls back to a
logical route.

``gather_over`` / ``shift_over`` / ``max_over`` / ``min_over`` are the
same transfers on an explicit process group, what the mesh helpers call
once they have resolved the axis's subgroup and staging.

Only calls present in torch 2.11 and 2.13 are used
(``all_gather_into_tensor``, ``batch_isend_irecv``, ``all_reduce``,
``broadcast``).
"""
from __future__ import annotations

import hashlib
import json
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

__all__ = ["all_gather_panel", "ring_shift", "all_reduce_max",
           "all_reduce_min", "all_gather_ragged", "gather_ragged_or_raise",
           "agree_or_raise", "broadcast_from", "broadcast_json",
           "encode_json", "decode_json", "exchange_pieces",
           "exchange_device",
           "same_on_every_rank", "gather_over", "shift_over", "max_over",
           "min_over"]

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
    # reshape is a view where a moved axis has size 1: copy to row-major
    return stacked.reshape(
        shape[:dim] + (n * shape[dim],) + shape[dim + 1:]).contiguous()


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


def _reduce_over(t: torch.Tensor, op, group, stage: Optional[Stage],
                 key: str) -> torch.Tensor:
    if stage is None:
        out = t.contiguous().clone()
    else:
        out = stage(key, t.shape, t.dtype)
        out.copy_(t)
    tdist.all_reduce(out, op=op, group=group)
    return out if stage is None else out.to(t.device, copy=True)


def max_over(t: torch.Tensor, group, stage: Optional[Stage] = None,
             key: str = "max") -> torch.Tensor:
    """The elementwise max of ``t`` over ``group`` (one ``all_reduce``)."""
    return _reduce_over(t, tdist.ReduceOp.MAX, group, stage, key)


def min_over(t: torch.Tensor, group, stage: Optional[Stage] = None,
             key: str = "min") -> torch.Tensor:
    """The elementwise min of ``t`` over ``group`` (one ``all_reduce``)."""
    return _reduce_over(t, tdist.ReduceOp.MIN, group, stage, key)


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


def all_reduce_min(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise min of ``t`` over this rank's line along ``axis``."""
    if mesh.shape[axis] == 1:
        return t
    return min_over(t, mesh.axis_group(axis), _stage_for(t, mesh),
                    key=f"min:{axis}")


def exchange_device(mesh) -> torch.device:
    """Where host data crosses between ranks: the host under gloo (no
    round trip through the card), the mesh's device under NCCL."""
    return torch.device("cpu") if mesh.backend == "gloo" else mesh.device


def all_gather_ragged(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every rank's flat int64 ``t`` (its own length), in rank order, on
    every rank of ``mesh``'s world: one gather of the lengths, then one
    ``all_gather_into_tensor`` of the tensors padded to the longest.  In
    a world of one rank the list holds ``t`` itself."""
    if t.dtype != torch.int64 or t.dim() != 1:
        raise ValueError(f"all_gather_ragged takes a flat int64 tensor, "
                         f"got {t.dtype} of shape {tuple(t.shape)}")
    world = mesh.world_size
    if world == 1:
        return [t]
    stage = _stage_for(t, mesh)
    size = torch.tensor([t.numel()], dtype=torch.int64, device=t.device)
    sizes = gather_over(size, None, world, stage=stage,
                        key="ragged:sizes").tolist()
    longest = max(sizes)
    if longest == 0:
        return [t.new_empty(0) for _ in sizes]
    padded = t
    if t.numel() < longest:
        padded = torch.zeros(longest, dtype=torch.int64, device=t.device)
        padded[:t.numel()] = t
    flat = gather_over(padded, None, world, stage=stage, key="ragged")
    return [flat[k * longest:k * longest + n].clone()
            for k, n in enumerate(sizes)]


def gather_ragged_or_raise(t: Optional[torch.Tensor], mesh, what: str,
                           error: Optional[BaseException] = None
                           ) -> List[torch.Tensor]:
    """``all_gather_ragged`` of ``t``, where a rank whose share of the
    work failed passes its ``error`` instead (``t`` is then unused).  Each
    part crosses behind a flag word; a failed rank's part is its error's
    text.  If any rank failed, every rank raises ``RuntimeError`` naming
    the ranks and their errors (chained to its own error where it is one
    of them), so none is left waiting in a later collective."""
    if error is None:
        head, body = 0, t
    else:
        text = f"{type(error).__name__}: {error}".encode()
        head = 1
        body = torch.frombuffer(bytearray(text), dtype=torch.uint8).to(
            device=exchange_device(mesh), dtype=torch.int64)
    flag = torch.tensor([head], dtype=torch.int64, device=body.device)
    parts = all_gather_ragged(torch.cat([flag, body]), mesh)
    failed = [(k, bytes(p[1:].cpu().to(torch.uint8).tolist()).decode(
        errors="replace")) for k, p in enumerate(parts) if int(p[0])]
    if failed:
        raise RuntimeError(f"{what} on ranks: " + "; ".join(
            f"rank {k} failed ({msg})" for k, msg in failed)) from error
    return [p[1:] for p in parts]


def agree_or_raise(mesh, what: str,
                   error: Optional[BaseException] = None) -> None:
    """One status word a rank: a max-reduce of a flag over ``mesh``'s
    world (0 = this rank's share succeeded, 1 = it failed with
    ``error``).  If any rank failed, the texts cross through
    ``gather_ragged_or_raise`` and every rank raises its
    ``RuntimeError``; else every rank returns, having waited for all."""
    dev = exchange_device(mesh)
    flag = torch.tensor([0 if error is None else 1], dtype=torch.int64,
                        device=dev)
    if mesh.world_size > 1:
        tdist.all_reduce(flag, op=tdist.ReduceOp.MAX)
    if int(flag.item()):
        gather_ragged_or_raise(torch.empty(0, dtype=torch.int64, device=dev),
                               mesh, what, error)


def broadcast_from(t: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Global rank ``src``'s flat int64 ``t`` on every rank of ``mesh``'s
    world (one ``broadcast``); every rank passes a tensor of the same
    length, whose contents only ``src``'s matter.  Returns a new tensor
    on ``t``'s device; in a world of one rank, ``t`` itself."""
    if t.dtype != torch.int64 or t.dim() != 1:
        raise ValueError(f"broadcast_from takes a flat int64 tensor, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    if mesh.world_size == 1:
        return t
    stage = _stage_for(t, mesh)
    if stage is None:
        buf = t.contiguous().clone()
    else:
        buf = stage("broadcast", t.shape, t.dtype)
        buf.copy_(t)
    tdist.broadcast(buf, src=src)
    return buf if stage is None else buf.to(t.device, copy=True)


def encode_json(obj) -> np.ndarray:
    """A JSON-able object as flat int64, one word per byte of its JSON:
    the form ``broadcast_json`` and the serving stream carry it in."""
    return np.frombuffer(json.dumps(obj).encode(), np.uint8).astype(np.int64)


def decode_json(words):
    """``encode_json``'s object back from its words."""
    return json.loads(np.asarray(words, np.int64).astype(np.uint8).tobytes())


def broadcast_json(obj, mesh, src: int = 0):
    """Global rank ``src``'s JSON-able ``obj`` on every rank of ``mesh``'s
    world (the other ranks' ``obj`` is ignored): its length in one
    ``broadcast_from``, then its ``encode_json`` words in another.  Every
    rank, ``src`` too, returns the decoded copy."""
    dev = exchange_device(mesh)
    words = (encode_json(obj) if mesh.rank == src
             else np.zeros(0, np.int64))
    size = int(broadcast_from(torch.tensor([words.size], dtype=torch.int64,
                                           device=dev), mesh, src).item())
    if mesh.rank != src:
        words = np.zeros(size, np.int64)
    return decode_json(broadcast_from(torch.from_numpy(words).to(dev), mesh,
                                      src).cpu().numpy())


def exchange_pieces(sends: Dict[int, torch.Tensor],
                    shapes: Dict[int, Sequence[int]], like: torch.Tensor,
                    mesh) -> Dict[int, torch.Tensor]:
    """``sends[k]`` goes to global rank ``k``, and from each rank ``k`` of
    ``shapes`` a tensor of ``shapes[k]`` comes back (``like``'s dtype and
    device), all posted as one ``batch_isend_irecv`` over the world
    group.  Both sides of each pair must agree on its shape, as a
    resharding does from its geometry alone.  A rank with nothing to send
    or receive makes no call."""
    stage = _stage_for(like, mesh)
    ops, recvs = [], {}
    for k, piece in sorted(sends.items()):
        src = piece.contiguous()
        if stage is not None:
            buf = stage(f"pieces:send:{k}", src.shape, src.dtype)
            src = buf.copy_(src)
        ops.append(tdist.P2POp(tdist.isend, src, k))
    for k, shape in sorted(shapes.items()):
        recvs[k] = (torch.empty(tuple(shape), dtype=like.dtype,
                                device=like.device) if stage is None
                    else stage(f"pieces:recv:{k}", shape, like.dtype))
        ops.append(tdist.P2POp(tdist.irecv, recvs[k], k))
    if ops:
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
    if stage is None:
        return recvs
    return {k: t.to(like.device, copy=True) for k, t in recvs.items()}


def same_on_every_rank(mesh, key: bytes) -> bool:
    """Whether every rank of ``mesh``'s world passed the same ``key``: one
    ``all_gather_ragged`` of its SHA-256 digest (four int64 words)."""
    digest = np.frombuffer(hashlib.sha256(key).digest(), np.int64).copy()
    mine = torch.from_numpy(digest).to(exchange_device(mesh))
    return all(torch.equal(d.cpu(), mine.cpu())
               for d in all_gather_ragged(mine, mesh))
