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
* ``all_reduce_max(t, mesh, axis)`` / ``all_reduce_min`` /
  ``all_reduce_sum`` — the elementwise max / min / sum over the line
  (``jax.lax.pmax`` / ``pmin`` / ``psum``), the sum in ``t``'s own dtype
  (gloo reduces bfloat16 as it is, in torch 2.11 and 2.13);
  ``all_reduce_sum`` with ``axis=None`` sums over every rank of the
  mesh (``psum`` over all its axes);
* ``reduce_scatter_sum(t, mesh, axis, dim)`` — ``jax.lax.psum_scatter(
  t, axis, scatter_dimension=dim, tiled=True)``: the sum of ``t`` over
  the line, in float32, of which coordinate ``i`` keeps block ``i`` of
  ``dim`` (one ``reduce_scatter_tensor``; what ZeRO-1 reduces a
  gradient to: the shard of its moments);
* ``all_to_all_over(t, mesh, axis, send_counts, recv_counts)`` — rows to
  each rank of the line, uneven: ``t``'s first ``send_counts[0]`` rows go
  to coordinate 0, the next ``send_counts[1]`` to coordinate 1, ...,
  and ``recv_counts[j]`` rows come back from coordinate j, concatenated
  in coordinate order (what an expert-parallel MoE moves each way; zero
  rows to or from a rank is a normal case).  Every rank's counts cross
  first, with a status word, in one fixed-size all-gather over the
  world: if any rank failed (its ``error``, or counts that do not fit its
  ``t``) or the two ends of a pair disagree, every rank raises together,
  before any row moves.  Then one ``all_to_all_single`` over the line;
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
call).  The axis transfers (``all_gather_panel``, ``ring_shift``,
``all_reduce_*``, ``reduce_scatter_sum``, ``all_to_all_over``) are
counted into the mesh's ``tally`` (a ``Tally``: this rank's), by the LM
dry-run's kinds and units (``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``; bytes = the
op's result bytes, as
``launch/dryrun.collective_closed_form`` counts them), with the host
seconds spent in them (a CUDA tensor staged through the host has its
card synchronised first, which its staging copy would wait for anyway,
so the transfer's time is its own; under NCCL the seconds are the
enqueue's) and, when asked, a digest of each
all-reduced result and of each routing a MoE layer computed
(``Tally.route``), by which ranks show they hold the same bytes.
Under NCCL the tensors go to the collective as they are.  Under gloo a
CUDA tensor is staged through host buffers the mesh keeps (pinned,
reused across rounds) and copied back: gloo's own CUDA support is not
relied on.  A collective that fails raises; nothing falls back to a
logical route.

``gather_over`` / ``shift_over`` / ``max_over`` / ``min_over`` /
``sum_over`` / ``scatter_sum_over`` / ``rows_over`` are the
same transfers on an explicit process group, what the mesh helpers call
once they have resolved the axis's subgroup and staging.

Only calls present in torch 2.11 and 2.13 are used
(``all_gather_into_tensor``, ``batch_isend_irecv``, ``all_reduce``,
``reduce_scatter_tensor``, ``broadcast``, ``all_to_all_single``).
"""
from __future__ import annotations

import hashlib
import json
import math
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

__all__ = ["all_gather_panel", "ring_shift", "all_reduce_max",
           "all_reduce_min", "all_reduce_sum", "all_reduce_sum_checked",
           "reduce_scatter_sum", "all_to_all_over", "Tally",
           "KINDS", "all_gather_ragged", "gather_ragged_or_raise",
           "agree_or_raise", "broadcast_from", "broadcast_json",
           "encode_json", "decode_json", "exchange_pieces",
           "exchange_device",
           "same_on_every_rank", "gather_over", "shift_over", "max_over",
           "min_over", "sum_over", "scatter_sum_over", "rows_over",
           "digest", "no_backward"]

# (key, shape, dtype[, grow]) -> a host buffer kept for the next call
Stage = Callable[[str, Sequence[int], torch.dtype], torch.Tensor]
# the LM dry-run's collective kinds (``launch/dryrun.COLLECTIVE_KINDS``)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


# bytes ``digest`` widens to int64 at a time: a parameter block of
# hundreds of MB would otherwise take 24 bytes of temporaries a byte
_DIGEST_CHUNK = 1 << 24


def digest(t: torch.Tensor) -> Tuple[int, int]:
    """Two int64 sums over ``t``'s bytes (plain and position-weighted):
    equal tensors give equal digests, and differing bytes almost surely
    differ."""
    b = t.detach().contiguous().view(-1).view(torch.uint8)
    plain = weighted = 0
    for lo in range(0, b.numel(), _DIGEST_CHUNK):
        part = b[lo:lo + _DIGEST_CHUNK].to(torch.int64)
        weights = torch.arange(lo, lo + part.numel(),
                               device=b.device) % 65_521 + 1
        plain += int(part.sum())
        weighted += int((part * weights).sum())
    return plain, weighted


class Tally:
    """The axis collectives this process ran since ``reset``: calls and
    result bytes by kind, host seconds, and (``reset(digests=True)``)
    the ``digest`` of every all-reduced result in call order, with the
    axis it was reduced over in ``digest_axes`` (``None``: every rank),
    and in ``routes`` those of every routing ``route`` was given."""

    def __init__(self):
        self.reset()

    def reset(self, digests: bool = False) -> None:
        self.bytes = dict.fromkeys(KINDS, 0)
        self.counts = dict.fromkeys(KINDS, 0)
        self.seconds = 0.0
        self.digests: Optional[List[Tuple[int, int]]] = \
            [] if digests else None
        self.digest_axes: Optional[List[Optional[str]]] = \
            [] if digests else None
        self.routes: Optional[List[Tuple[int, int]]] = \
            [] if digests else None

    def add(self, kind: str, result: torch.Tensor, seconds: float,
            axis: Optional[str] = None) -> None:
        self.bytes[kind] += result.numel() * result.element_size()
        self.counts[kind] += 1
        self.seconds += seconds
        if self.digests is not None and kind == "all-reduce":
            self.digests.append(digest(result))
            self.digest_axes.append(axis)

    def route(self, *parts: torch.Tensor) -> None:
        """Keeps the ``digest`` of each of ``parts`` (a MoE layer's
        chosen experts and gates) when digests are on."""
        if self.routes is not None:
            self.routes.extend(digest(p) for p in parts)

    def record(self) -> Dict:
        """``{"bytes", "counts", "total_bytes"}`` as the closed form's
        records, plus ``"seconds"``."""
        return {"bytes": dict(self.bytes), "counts": dict(self.counts),
                "total_bytes": int(sum(self.bytes.values())),
                "seconds": self.seconds}


def _counted(mesh, kind: str, t: torch.Tensor,
             transfer: Callable[[], torch.Tensor],
             axis: Optional[str] = None) -> torch.Tensor:
    """``transfer()`` (one collective of ``t`` over ``axis``), counted
    into ``mesh.tally``."""
    if t.is_cuda and _stage_for(t, mesh) is not None:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = transfer()
    mesh.tally.add(kind, out, time.perf_counter() - t0, axis)
    return out


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


def sum_over(t: torch.Tensor, group, stage: Optional[Stage] = None,
             key: str = "sum") -> torch.Tensor:
    """The elementwise sum of ``t`` over ``group`` (one ``all_reduce``)."""
    return _reduce_over(t, tdist.ReduceOp.SUM, group, stage, key)


def scatter_sum_over(t: torch.Tensor, group, n: int,
                     stage: Optional[Stage] = None,
                     key: str = "scatter") -> torch.Tensor:
    """The sum of ``t`` over the ``n`` ranks of ``group``, of which group
    rank ``i`` keeps rows ``[i * r, (i + 1) * r)``, ``r = t.shape[0] /
    n`` (one ``reduce_scatter_tensor``)."""
    src = t.contiguous()
    out_shape = (src.shape[0] // n,) + tuple(src.shape[1:])
    if stage is None:
        send = src
        recv = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    else:
        send = stage(f"{key}:send", src.shape, src.dtype)
        send.copy_(src)
        recv = stage(f"{key}:recv", out_shape, src.dtype)
    with warnings.catch_warnings():
        # torch 2.13 names it reduce_scatter_single; 2.11 has only this
        warnings.simplefilter("ignore", FutureWarning)
        tdist.reduce_scatter_tensor(recv, send, op=tdist.ReduceOp.SUM,
                                    group=group)
    return recv if stage is None else recv.to(src.device, copy=True)


def rows_over(t: torch.Tensor, group, send_counts: Sequence[int],
              recv_counts: Sequence[int], stage: Optional[Stage] = None,
              key: str = "rows") -> torch.Tensor:
    """``t``'s rows split by ``send_counts`` to the ranks of ``group`` in
    group-rank order, and ``sum(recv_counts)`` rows back, in group-rank
    order (one ``all_to_all_single``); the caller makes both ends of
    each pair agree.  Staged rows go through one flat host buffer a
    direction, kept at the largest size seen."""
    src = t.contiguous()
    tail = tuple(src.shape[1:])
    width = math.prod(tail)
    out_shape = (int(sum(recv_counts)),) + tail
    send_sizes = [int(c) for c in send_counts]
    recv_sizes = [int(c) for c in recv_counts]
    if stage is None:
        send = src
        recv = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    else:
        send = stage(f"{key}:send", (src.numel(),), src.dtype, grow=True)
        send = send.view(src.shape)
        send.copy_(src)
        recv = stage(f"{key}:recv", (math.prod(out_shape),), src.dtype,
                     grow=True).view(out_shape)
    if width:
        tdist.all_to_all_single(recv, send, output_split_sizes=recv_sizes,
                                input_split_sizes=send_sizes, group=group)
    return recv if stage is None else recv.to(src.device, copy=True)


def no_backward(t: Optional[torch.Tensor], what: str) -> None:
    """Raises ``NotImplementedError`` where autograd records ``t``: the
    transfer ``what`` returns a tensor with no gradient, which would cut
    a backward silently."""
    if t is not None and torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(
            f"{what} has no backward on ranks (ROADMAP.md, A10d-5b-3b); "
            f"call it outside autograd")


def all_gather_panel(block: torch.Tensor, mesh, axis: str,
                     dim: int) -> torch.Tensor:
    """The tiled all-gather of ``block`` along ``axis`` into ``dim``.
    Under autograd it refuses (``no_backward``)."""
    n = mesh.shape[axis]
    if n == 1:
        return block
    no_backward(block, "all_gather_panel")
    return _counted(mesh, "all-gather", block, lambda: gather_over(
        block, mesh.axis_group(axis), n, dim, _stage_for(block, mesh),
        key=f"gather:{axis}:{dim}"))


def ring_shift(block: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """One step of the ring along ``axis``: coordinate i's block goes to
    i + 1 (mod n); the block of i - 1 comes back."""
    n = mesh.shape[axis]
    if n == 1:
        return block
    ranks, i = mesh.axis_ranks(axis), mesh.axis_index(axis)
    return _counted(mesh, "collective-permute", block, lambda: shift_over(
        block, mesh.axis_group(axis), ranks[(i + 1) % n], ranks[(i - 1) % n],
        _stage_for(block, mesh), key=f"ring:{axis}"))


def all_reduce_max(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise max of ``t`` over this rank's line along ``axis``."""
    if mesh.shape[axis] == 1:
        return t
    return _counted(mesh, "all-reduce", t, lambda: max_over(
        t, mesh.axis_group(axis), _stage_for(t, mesh), key=f"max:{axis}"),
        axis)


def all_reduce_min(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise min of ``t`` over this rank's line along ``axis``."""
    if mesh.shape[axis] == 1:
        return t
    return _counted(mesh, "all-reduce", t, lambda: min_over(
        t, mesh.axis_group(axis), _stage_for(t, mesh), key=f"min:{axis}"),
        axis)


def all_reduce_sum(t: torch.Tensor, mesh,
                   axis: Optional[str]) -> torch.Tensor:
    """The elementwise sum of ``t`` over this rank's line along ``axis``
    (``None``: over every rank of ``mesh``), in ``t``'s dtype (a
    tensor-parallel layer's partial products)."""
    if (mesh.world_size if axis is None else mesh.shape[axis]) == 1:
        return t
    group = None if axis is None else mesh.axis_group(axis)
    return _counted(mesh, "all-reduce", t, lambda: sum_over(
        t, group, _stage_for(t, mesh), key=f"sum:{axis or '*'}"), axis)


def reduce_scatter_sum(t: torch.Tensor, mesh, axis: str,
                       dim: int) -> torch.Tensor:
    """The sum of ``t`` over this rank's line along ``axis``, taken in
    float32, cut along ``dim`` into the line's ``n`` equal blocks of
    which this rank keeps the one at its coordinate (the tiled
    ``psum_scatter``): ``t.shape[dim]`` must divide by ``n``.  Counted as
    one ``reduce-scatter`` of the float32 result's bytes.  On an axis of
    size 1, ``t`` in float32 (itself if it is float32)."""
    n = mesh.shape[axis]
    t = t.float()
    if n == 1:
        return t
    dim = dim % t.dim()
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter_sum: dimension {dim} of "
                         f"{tuple(t.shape)} does not split into {n} blocks")
    lead = t.movedim(dim, 0)

    def transfer():
        out = scatter_sum_over(lead, mesh.axis_group(axis), n,
                               _stage_for(t, mesh),
                               key=f"scatter:{axis}:{dim}")
        return out.movedim(0, dim).contiguous() if dim else out
    return _counted(mesh, "reduce-scatter", t, transfer)


def all_reduce_sum_checked(t: Optional[torch.Tensor], shape: Sequence[int],
                           mesh, axis: str, what: str,
                           error: Optional[BaseException] = None
                           ) -> torch.Tensor:
    """``all_reduce_sum`` of the float32 ``t`` (of ``shape``) with one
    float32 status word beside it in the same all-reduce: a rank whose
    share failed passes its ``error`` (``t`` unused: zeros cross) and
    still joins, and if any rank failed every rank of the line raises
    ``RuntimeError`` naming the ranks and their errors
    (``gather_ragged_or_raise`` over the ``axis`` line: every rank of it
    is in this call; the other lines of a wider world learn of it from
    whatever agreement their caller makes next).  Counted as one
    all-reduce of ``prod(shape) + 1`` float32 values."""
    if error is not None or t is None:
        t = torch.zeros(tuple(shape), dtype=torch.float32,
                        device=mesh.device)
    flag = torch.full((1,), 0.0 if error is None else 1.0,
                      dtype=torch.float32, device=t.device)
    total = all_reduce_sum(torch.cat([t.reshape(-1), flag]), mesh, axis)
    if bool(total[-1] > 0):
        gather_ragged_or_raise(
            torch.empty(0, dtype=torch.int64, device=exchange_device(mesh)),
            mesh, what, error, axis=axis)
    return total[:-1].view(tuple(shape))


def _line_counts(words: torch.Tensor, mesh, axis: str) -> Optional[str]:
    """Why the gathered count words ``[world, 1 + 2 n]`` (each rank's
    status, send counts, receive counts) do not pair up along ``axis``,
    or ``None``: in every line, what coordinate i sends j is what j
    receives from i."""
    n = mesh.shape[axis]
    k = mesh.axis_names.index(axis)
    grid = np.moveaxis(np.arange(mesh.world_size).reshape(mesh.dims), k, -1)
    w = words.cpu().numpy()
    for line in grid.reshape(-1, n):
        sends = w[line, 1:1 + n]
        recvs = w[line, 1 + n:]
        if not np.array_equal(sends, recvs.T):
            i, j = np.argwhere(sends != recvs.T)[0]
            return (f"ranks {int(line[i])} and {int(line[j])}: "
                    f"{int(sends[i, j])} rows sent, {int(recvs[j, i])} "
                    f"expected")
    return None


def all_to_all_over(t: Optional[torch.Tensor], mesh, axis: str,
                    send_counts: Sequence[int], recv_counts: Sequence[int],
                    error: Optional[BaseException] = None,
                    what: str = "all_to_all_over") -> torch.Tensor:
    """The rows exchange along ``axis`` (module docstring): ``t``'s rows,
    grouped by destination coordinate in ``send_counts``, go out, and
    ``recv_counts[j]`` rows come back from each coordinate ``j``, in
    coordinate order.  Every rank of the world calls it together (SPMD).
    A rank whose share failed passes its ``error`` (``t`` is then
    unused): it still joins the count exchange, and every rank raises
    ``RuntimeError`` naming it.  Counted as ``all-to-all`` with its
    result bytes.  On an axis of size 1 it is the identity (``error``
    is raised).  Under autograd it refuses (``no_backward``)."""
    n = mesh.shape[axis]
    if n == 1:
        if error is not None:
            raise error
        return t
    no_backward(t, "all_to_all_over")
    send = [int(c) for c in send_counts]
    recv = [int(c) for c in recv_counts]
    if error is None:
        try:
            if t is None or t.dim() < 1:
                raise ValueError("all_to_all_over moves the rows of a "
                                 "tensor of one dimension or more")
            if len(send) != n or len(recv) != n or min(send + recv) < 0:
                raise ValueError(f"counts {send}, {recv} are not {n} "
                                 f"non-negative entries")
            if sum(send) != t.shape[0]:
                raise ValueError(f"send counts {send} do not sum to the "
                                 f"{t.shape[0]} rows")
        except ValueError as exc:
            error = exc
    dev = exchange_device(mesh)
    words = torch.tensor([0 if error is None else 1]
                         + (send + recv if error is None else [0] * 2 * n),
                         dtype=torch.int64, device=dev)

    def transfer():
        table = gather_over(words, None, mesh.world_size,
                            stage=_stage_for(words, mesh),
                            key="rows:counts").view(mesh.world_size, -1)
        if bool(table[:, 0].any()):
            gather_ragged_or_raise(torch.empty(0, dtype=torch.int64,
                                               device=dev), mesh, what,
                                   error)
        why = _line_counts(table, mesh, axis)
        if why is not None:
            raise RuntimeError(f"{what} along {axis!r}: the counts do not "
                               f"pair up ({why})")
        return rows_over(t, mesh.axis_group(axis), send, recv,
                         _stage_for(t, mesh), key=f"rows:{axis}")
    return _counted(mesh, "all-to-all", t if t is not None else words,
                    transfer)


def exchange_device(mesh) -> torch.device:
    """Where host data crosses between ranks: the host under gloo (no
    round trip through the card), the mesh's device under NCCL."""
    return torch.device("cpu") if mesh.backend == "gloo" else mesh.device


def all_gather_ragged(t: torch.Tensor, mesh,
                      axis: Optional[str] = None) -> List[torch.Tensor]:
    """Every rank's flat int64 ``t`` (its own length), in rank order, on
    every rank of ``mesh``'s world (with ``axis``, of this rank's line
    along it, by coordinate): one gather of the lengths, then one
    ``all_gather_into_tensor`` of the tensors padded to the longest.  In
    a world (a line) of one rank the list holds ``t`` itself."""
    if t.dtype != torch.int64 or t.dim() != 1:
        raise ValueError(f"all_gather_ragged takes a flat int64 tensor, "
                         f"got {t.dtype} of shape {tuple(t.shape)}")
    world = mesh.world_size if axis is None else mesh.shape[axis]
    if world == 1:
        return [t]
    group = None if axis is None else mesh.axis_group(axis)
    stage = _stage_for(t, mesh)
    size = torch.tensor([t.numel()], dtype=torch.int64, device=t.device)
    sizes = gather_over(size, group, world, stage=stage,
                        key="ragged:sizes").tolist()
    longest = max(sizes)
    if longest == 0:
        return [t.new_empty(0) for _ in sizes]
    padded = t
    if t.numel() < longest:
        padded = torch.zeros(longest, dtype=torch.int64, device=t.device)
        padded[:t.numel()] = t
    flat = gather_over(padded, group, world, stage=stage, key="ragged")
    return [flat[k * longest:k * longest + n].clone()
            for k, n in enumerate(sizes)]


def gather_ragged_or_raise(t: Optional[torch.Tensor], mesh, what: str,
                           error: Optional[BaseException] = None,
                           axis: Optional[str] = None
                           ) -> List[torch.Tensor]:
    """``all_gather_ragged`` of ``t`` (over the world, or ``axis``'s
    line), where a rank whose share of the work failed passes its
    ``error`` instead (``t`` is then unused).  Each part crosses behind a
    flag word; a failed rank's part is its error's text.  If any rank
    failed, every rank raises ``RuntimeError`` naming the ranks (global
    ranks) and their errors (chained to its own error where it is one of
    them), so none is left waiting in a later collective."""
    if error is None:
        head, body = 0, t
    else:
        text = f"{type(error).__name__}: {error}".encode()
        head = 1
        body = torch.frombuffer(bytearray(text), dtype=torch.uint8).to(
            device=exchange_device(mesh), dtype=torch.int64)
    flag = torch.tensor([head], dtype=torch.int64, device=body.device)
    parts = all_gather_ragged(torch.cat([flag, body]), mesh, axis)
    names = (range(len(parts)) if axis is None
             else mesh.axis_ranks(axis))
    failed = [(k, bytes(p[1:].cpu().to(torch.uint8).tolist()).decode(
        errors="replace")) for k, p in zip(names, parts) if int(p[0])]
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
