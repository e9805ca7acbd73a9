"""Block-partitioned semiring closures on a logical mesh, and the
``sharded`` engine backend that serves queries off them.

For hypergraphs whose line graph does not fit one device's closure
budget, the closure operand R [m, m] is partitioned into an ``r x c``
grid of blocks over the mesh axes ``(data, model)`` (``core/mesh.py``)
and each squaring round contracts every block from its row and column
panels:

* ``allgather`` schedule — block (i, j) contracts its row panel
  R[i, :] ([mp/r, mp]) with its column panel R[:, j] ([mp, mp/c]):
  ``r·c`` contractions a round.
* ``ring`` schedule — block (i, j) walks the row axis in ``r`` steps,
  contracting the [mp/r, mp/r] segment R[i, k] with the [mp/r, mp/c]
  panel R[k, j] for k = i, i-1, ... and folding each into
  ``max(blk, ·)``: ``r·c·r`` contractions a round.

Each contraction is one launch of the ``maxmin_matmul`` kernel in
float32 on the card (its plain version on the CPU) with
``use_kernels=True``, and the plain ``_local_maxmin`` otherwise.  Every
round reads the old R and writes a second buffer, as the reference's
functional rounds do, so a capped ``rounds=`` gives the same W*.

The threshold-batched boolean closure splits its threshold batch over
the ``pod`` axis; its round ``R @ R > 0`` over a pod's 0/1 slab is the
``threshold_step`` kernel's function, one launch per pod slice per
round.

``ShardedEngine`` (registered as backend ``"sharded"``) wraps these
closures in the ``ReachabilityEngine`` protocol: the closure is computed
once at build time and kept resident in its padded layout, and every
query is served off a ``DeviceSnapshot`` landed on the mesh
(``to_mesh``).  Updates are scoped in both regimes: an edge edit
re-closes only the touched line-graph component block and patches the
resident W* / snapshot (closure regime), or routes the touched
components through ``build_sharded`` and splices (label regime).

Counterpart of ``repro/core/distributed.py``, same names in the same
order.  On a ``LogicalMesh`` the blocks of the reference's
``NamedSharding(mesh, P(row, col))`` are views of one padded tensor on
``mesh.device`` and its collectives are reads of those views.

On a ``ProcessMesh`` (``core/mesh.py``) every block lives on its own rank
and the reference's shard_map bodies run as written, with the
collectives of ``core/collectives.py``: a closure round gathers the row
panel over the column axis and (``allgather``) the column panel over the
row axis, or (``ring``) passes the column panel around the row axis; the
threshold closure gathers 0/1 panels and max-reduces over ``pod``.  Each
rank passes the full host ``w``, lands only its own block, and gets its
own block of the padded result back (``gather_blocks`` assembles the
whole on every rank, for checks).  The ``sharded`` engine builds, serves
and updates on ranks in both regimes: the closure regime keeps a W*
block a rank and derives the replicated snapshot with one max-reduce and
one all-gather; the label regime builds through ``build_sharded`` on the
ranks and serves off ``to_mesh``'s blocks.  Serving, replicas and the
store run there too (``serve/reach_service.py``, ``store/format.py``):
a saved W* crosses to rank 0 a block at a time and loads a block a
rank.

The reference's ``collective_bytes_of`` parses the XLA HLO text of a
lowered program; the port lowers nothing to HLO, so that helper has no
input here and is not ported.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.maxmin_matmul import maxmin_matmul_ref
from ..kernels.ops import default_rounds
from ..kernels.threshold_closure import (largest_threshold,
                                         threshold_adjacency, threshold_step)
from . import collectives as coll
from .engine import WORKLOAD_OPS, _EngineBase, register_backend
from .hlindex import (HLIndex, auto_device_overlaps, build_sharded,
                      pad_label_rows)
from .hypergraph import (NeighborCSR, apply_edge_edits,
                         induced_subhypergraph, neighbor_csr)
from .maintenance import apply_updates, component_of
from .mesh import LogicalMesh, ProcessMesh, default_line_graph_mesh
from .minimal import minimize
from .query import DeviceSnapshot, mr_query, s_reach_query

__all__ = [
    "pad_for_mesh", "sharded_maxmin_round", "sharded_maxmin_closure",
    "sharded_threshold_closure_mr", "block_of", "gather_blocks",
    "regrid_block",
    "default_line_graph_mesh", "ShardedEngine",
]


def pad_for_mesh(w, mesh: LogicalMesh,
                 axes: Tuple[str, str] = ("data", "model")):
    """Pad [m, m] (or [S, m, m]) so both block dims divide the mesh axes.
    Zero is the (max,min) annihilator and boolean-adjacency identity, so
    padding is exact for both closure flavors.  ``w`` is a host array or
    a tensor; the result is of the same kind (``w`` itself if no pad)."""
    r, c = mesh.shape[axes[0]], mesh.shape[axes[1]]
    lcm = int(np.lcm(r, c))
    m = w.shape[-1]
    pad = (-m) % lcm
    if pad == 0:
        return w
    if isinstance(w, torch.Tensor):
        return torch.nn.functional.pad(w, (0, pad, 0, pad))
    widths = [(0, 0)] * (w.ndim - 2) + [(0, pad), (0, pad)]
    return np.pad(w, widths)


def _local_maxmin(a: torch.Tensor, b: torch.Tensor,
                  chunk: int = 128) -> torch.Tensor:
    """The plain blocked (max,min) contraction (``chunk`` columns of the
    contraction at a time keep the broadcast bounded)."""
    return maxmin_matmul_ref(a, b, block=chunk)


def _local_contraction(use_kernels: bool) -> Callable:
    """The per-block (max,min) contraction inside a closure round: the
    plain ``_local_maxmin`` (default), or the ``maxmin_matmul`` kernel
    when the engine was built with ``use_kernels=True`` — launched on
    CUDA operands, its plain version on CPU ones, nothing else."""
    if not use_kernels:
        return _local_maxmin
    from ..kernels.maxmin_matmul import maxmin_matmul
    return maxmin_matmul


def sharded_maxmin_round(mesh: LogicalMesh, *, schedule: str = "allgather",
                         axes: Tuple[str, str] = ("data", "model"),
                         use_kernels: bool = False,
                         on_read: Optional[Callable] = None,
                         contract: Optional[Callable] = None):
    """Returns ``round_fn(R, out=None) -> max(R, R∘R)`` for a padded
    [mp, mp] R partitioned over ``axes``.  Every block of the result is
    written into ``out`` (a second buffer, allocated when ``None``) and
    read only from ``R``, so a round sees the old R throughout.  Panels
    and segments the kernel reads are made contiguous first (a column
    panel of a row-major tensor is strided).

    ``on_read(kind, panel)``, where given, is called for every panel a
    block reads in the round, named by the collective that delivers it
    on the reference's mesh: ``"all-gather"`` for a block's row panel
    (and, under ``allgather``, its column panel), ``"collective-permute"``
    for each ring step's panel R[k, j].  A panel counts whole, the
    block's own part included, as the reference's collectives do.
    ``contract(a, b)`` replaces the per-block contraction where given (a
    walk of the schedule on ``meta`` tensors counts the reads of a round
    at any size without computing it).

    On a ``ProcessMesh`` ``round_fn(blk, out=None)`` takes and returns
    this rank's [mp/r, mp/c] block, and ``on_read`` sees the panels this
    rank gathers or receives."""
    if contract is None:
        contract = _local_contraction(use_kernels)
    read = on_read if on_read is not None else (lambda kind, panel: None)
    if schedule not in ("allgather", "ring"):
        raise ValueError(schedule)
    if isinstance(mesh, ProcessMesh):
        return _rank_round(mesh, schedule, axes, contract, read)
    n_row, n_col = mesh.shape[axes[0]], mesh.shape[axes[1]]

    def round_fn(r_in: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        br, bc = r_in.shape[0] // n_row, r_in.shape[0] // n_col
        if out is None:
            out = torch.empty_like(r_in)
        for j in range(n_col):
            cols = slice(j * bc, (j + 1) * bc)
            col_panel = (r_in[:, cols].contiguous() if schedule == "allgather"
                         else None)
            for i in range(n_row):
                rows = slice(i * br, (i + 1) * br)
                blk = r_in[rows, cols]
                row_panel = r_in[rows]            # contiguous row slice
                read("all-gather", row_panel)
                if schedule == "allgather":
                    read("all-gather", col_panel)
                    out[rows, cols] = torch.maximum(
                        blk, contract(row_panel, col_panel))
                    continue
                # ring: the column panel R[k, j] visits every k in the
                # order the reference's ppermute delivers it
                acc = blk.clone()
                for t in range(n_row):
                    src = (i - t) % n_row
                    ks = slice(src * br, (src + 1) * br)
                    seg = row_panel[:, ks].contiguous()
                    panel = r_in[ks, cols].contiguous()
                    read("collective-permute", panel)
                    torch.maximum(acc, contract(seg, panel), out=acc)
                out[rows, cols] = acc
        return out

    return round_fn


def _rank_round(mesh: ProcessMesh, schedule: str, axes: Tuple[str, str],
                contract: Callable, read: Callable):
    """The reference's shard_map round bodies on ranks (see
    ``sharded_maxmin_round``)."""
    row_ax, col_ax = axes
    n_row = mesh.shape[row_ax]

    def round_fn(blk: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        row_panel = coll.all_gather_panel(blk, mesh, col_ax, dim=1)
        read("all-gather", row_panel)
        if schedule == "allgather":
            col_panel = coll.all_gather_panel(blk, mesh, row_ax, dim=0)
            read("all-gather", col_panel)
            return torch.maximum(blk, contract(row_panel, col_panel),
                                 out=out)
        # ring: the column panel R[k, j] arrives from the previous row
        # coordinate each step; the last step's shift would go unused
        br = blk.shape[0]
        my_row = mesh.axis_index(row_ax)
        acc = blk.clone() if out is None else out.copy_(blk)
        panel = blk
        for t in range(n_row):
            src = (my_row - t) % n_row
            seg = row_panel[:, src * br:(src + 1) * br].contiguous()
            read("collective-permute", panel)
            torch.maximum(acc, contract(seg, panel), out=acc)
            if t + 1 < n_row:
                panel = coll.ring_shift(panel, mesh, row_ax)
        return acc

    return round_fn


def block_of(w, mesh: ProcessMesh,
             axes: Tuple[str, str] = ("data", "model")) -> torch.Tensor:
    """This rank's block of ``pad_for_mesh(w)`` ([..., mp/r, mp/c]) as a
    new tensor on ``mesh.device``.  ``w`` is a host array or a tensor;
    only the block is copied and landed, then zero-padded where it runs
    past ``m``, so neither the padded whole nor ``w`` itself is landed."""
    r, c = mesh.shape[axes[0]], mesh.shape[axes[1]]
    m = int(w.shape[-1])
    mp = _round_up(m, int(np.lcm(r, c)))
    br, bc = mp // r, mp // c
    i, j = mesh.axis_index(axes[0]), mesh.axis_index(axes[1])
    rows = slice(min(i * br, m), min((i + 1) * br, m))
    cols = slice(min(j * bc, m), min((j + 1) * bc, m))
    blk = _landed(w[..., rows, cols], mesh.device)
    pr, pc = br - blk.shape[-2], bc - blk.shape[-1]
    if pr or pc:
        blk = torch.nn.functional.pad(blk, (0, pc, 0, pr))
    return blk


def gather_blocks(block: torch.Tensor, mesh: ProcessMesh,
                  axes: Tuple[str, str] = ("data", "model")) -> torch.Tensor:
    """The padded [mp, mp] whole of every rank's ``block``, on every rank:
    an all-gather over the column axis, then over the row axis.  It
    lands the whole on each rank: for checks, and for an update's
    scope-sized sub-closure, never for the resident W*."""
    row = coll.all_gather_panel(block, mesh, axes[1], dim=block.dim() - 1)
    return coll.all_gather_panel(row, mesh, axes[0], dim=block.dim() - 2)


def _landed(w, device: torch.device) -> torch.Tensor:
    """``w`` (host array or tensor) as a new tensor on ``device``: a
    closure's rounds write their buffers, never the caller's."""
    if isinstance(w, torch.Tensor):
        return w.to(device=device, copy=True)
    a = np.ascontiguousarray(w)
    if not a.flags.writeable:           # a read-only view (a loaded file)
        a = a.copy()
    return torch.from_numpy(a).to(device=device, copy=True)


def sharded_maxmin_closure(w, mesh: LogicalMesh, *,
                           rounds: Optional[int] = None,
                           schedule: str = "allgather",
                           axes: Tuple[str, str] = ("data", "model"),
                           trim: bool = True,
                           use_kernels: bool = False) -> torch.Tensor:
    """Bottleneck closure of a block-partitioned line graph.

    ``w`` is the [m, m] line graph (host array or tensor, int32 or
    float32); the result is W* on ``mesh.device`` in ``w``'s dtype.
    ``rounds`` caps the squaring ladder (None = ⌈log2 mp⌉ over the padded
    size, as the reference).  With ``trim=True`` (default) the mesh
    padding is cut off and the result matches ``semiring.maxmin_closure``
    exactly; ``trim=False`` keeps the padded [mp, mp] tensor — the form
    ``ShardedEngine`` keeps resident (padding entries are zero, the
    (max, min) annihilator, so they never contribute to an answer).

    On a ``ProcessMesh`` every rank passes the whole ``w`` and gets its
    own [mp/r, mp/c] block of the padded W* on ``mesh.device``; a block
    has no trimmed form, so ``trim=False`` is required there
    (``gather_blocks(block, mesh, axes)[:m, :m]`` is the trimmed whole).
    """
    if isinstance(mesh, ProcessMesh):
        if trim:
            raise ValueError(
                "on a ProcessMesh the closure returns this rank's block of "
                "the padded W*: pass trim=False (gather_blocks assembles "
                "the whole)")
        cur = block_of(w, mesh, axes)
        m_padded = cur.shape[0] * mesh.shape[axes[0]]
    else:
        cur = pad_for_mesh(_landed(w, mesh.device), mesh, axes)
        m_padded = cur.shape[0]
    m_true = int(w.shape[0])
    n_rounds = rounds if rounds is not None else default_rounds(m_padded)
    round_fn = sharded_maxmin_round(mesh, schedule=schedule, axes=axes,
                                    use_kernels=use_kernels)
    nxt = torch.empty_like(cur)
    for _ in range(n_rounds):
        round_fn(cur, out=nxt)
        cur, nxt = nxt, cur
    del nxt
    if trim and m_padded != m_true:
        return cur[:m_true, :m_true].contiguous()
    return cur


def sharded_threshold_closure_mr(w, thresholds, mesh: LogicalMesh, *,
                                 rounds: Optional[int] = None,
                                 axes: Tuple[str, str, str] = (
                                     "pod", "data", "model"),
                                 ) -> torch.Tensor:
    """MR via threshold-batched boolean closure, float32 on
    ``mesh.device``.  The threshold batch splits over the ``pod`` axis
    (padded with copies of the smallest threshold, which are harmless);
    each [m, m] slab is padded for the ``(data, model)`` grid and every
    round is one ``threshold_step`` launch per pod slice (0/1 slabs with
    self-loops in bf16, exact; its plain version on the CPU).  The only
    cross-pod step is the final max over the threshold dim.

    On a ``ProcessMesh`` each rank holds the [S/pod, mp/r, mp/c] 0/1 block
    of its pod's thresholds and runs the reference's round: the row panel
    gathered over the column axis, the column panel over the row axis
    (both as uint8), one ``torch.bmm`` of their bf16 casts (0/1 products
    summed: exact once compared with 0) and ``> 0``; the read-out is
    max-reduced over ``pod``.  The result is this rank's [mp/r, mp/c]
    block of the padded MR matrix (``gather_blocks`` assembles it)."""
    if isinstance(mesh, ProcessMesh):
        return _rank_threshold_closure_mr(w, thresholds, mesh, rounds, axes)
    pod_ax, row_ax, col_ax = axes
    dev = mesh.device
    wt = _landed(w, dev).to(torch.float32)
    m_true = int(wt.shape[0])
    wp = pad_for_mesh(wt, mesh, (row_ax, col_ax))
    t = np.asarray(thresholds)
    if t.size == 0:
        return torch.zeros((m_true, m_true), dtype=torch.float32,
                           device=dev)
    pod = mesh.shape[pod_ax]
    tpad = (-t.size) % pod
    if tpad:
        # repeat the smallest threshold — duplicate slices are harmless
        t = np.concatenate([t, np.full(tpad, t.min(), t.dtype)])
    m = int(wp.shape[0])
    n_rounds = rounds if rounds is not None else default_rounds(m)
    tj = torch.as_tensor(t).to(device=dev, dtype=torch.float32)
    reach = threshold_adjacency(wp, tj, dtype=torch.bfloat16)
    per_pod = t.size // pod
    nxt = torch.empty_like(reach)
    for _ in range(n_rounds):
        for p in range(pod):
            sl = slice(p * per_pod, (p + 1) * per_pod)
            nxt[sl] = threshold_step(reach[sl])
        reach, nxt = nxt, reach
    del nxt
    mr = largest_threshold(reach, tj)          # cross-pod max-reduce
    mr.diagonal().copy_(wp.diagonal())
    if m != m_true:
        return mr[:m_true, :m_true].contiguous()
    return mr


def _rank_threshold_closure_mr(w, thresholds, mesh: ProcessMesh,
                               rounds: Optional[int],
                               axes: Tuple[str, str, str]) -> torch.Tensor:
    """The reference's threshold round body on ranks (see
    ``sharded_threshold_closure_mr``)."""
    pod_ax, row_ax, col_ax = axes
    dev = mesh.device
    wb = block_of(w, mesh, (row_ax, col_ax)).to(torch.float32)
    br, bc = wb.shape
    t = np.asarray(thresholds)
    if t.size == 0:
        return torch.zeros((br, bc), dtype=torch.float32, device=dev)
    pod = mesh.shape[pod_ax]
    tpad = (-t.size) % pod
    if tpad:
        # repeat the smallest threshold — duplicate slices are harmless
        t = np.concatenate([t, np.full(tpad, t.min(), t.dtype)])
    per_pod = t.size // pod
    p = mesh.axis_index(pod_ax)
    tj = torch.as_tensor(t[p * per_pod:(p + 1) * per_pod]).to(
        device=dev, dtype=torch.float32)
    mp = br * mesh.shape[row_ax]
    n_rounds = rounds if rounds is not None else default_rounds(mp)
    # entries of the global diagonal that fall in this block
    i, j = mesh.axis_index(row_ax), mesh.axis_index(col_ax)
    diag = (torch.arange(i * br, (i + 1) * br, device=dev)[:, None]
            == torch.arange(j * bc, (j + 1) * bc, device=dev)[None, :])
    reach = ((wb[None] >= tj[:, None, None]) | diag).to(torch.uint8)
    for _ in range(n_rounds):
        row_panel = coll.all_gather_panel(reach, mesh, col_ax, dim=2)
        col_panel = coll.all_gather_panel(reach, mesh, row_ax, dim=1)
        prod = torch.bmm(row_panel.to(torch.bfloat16),
                         col_panel.to(torch.bfloat16))
        del row_panel, col_panel
        reach = (prod > 0).to(torch.uint8)
        del prod
    mr = coll.all_reduce_max(largest_threshold(reach, tj), mesh, pod_ax)
    mr[diag] = wb[diag]
    return mr


# ---------------------------------------------------------------------------
# The "sharded" engine backend
# ---------------------------------------------------------------------------

def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def _closure_patcher(w: torch.Tensor, r0: int, c0: int,
                     freed: torch.Tensor, slots: torch.Tensor,
                     sub: torch.Tensor) -> torch.Tensor:
    """Patch the resident W* in place: zero the freed slots' rows and
    columns, then scatter the re-closed scope block at its slots.  ``w``
    is the block of W* whose first row and column are slots ``r0`` and
    ``c0`` (the whole W*, at 0 and 0, off ranks); only the slots that
    fall in its rows and columns are written.  W* is the engine's own
    tensor (no snapshot shares it), so no second copy is made — the
    reference donates its buffer for the same reason."""
    br, bc = w.shape
    if freed.numel():
        w.index_fill_(0, freed[(freed >= r0) & (freed < r0 + br)] - r0, 0)
        w.index_fill_(1, freed[(freed >= c0) & (freed < c0 + bc)] - c0, 0)
    if slots.numel():
        rm = (slots >= r0) & (slots < r0 + br)
        cm = (slots >= c0) & (slots < c0 + bc)
        w[(slots[rm] - r0)[:, None], (slots[cm] - c0)[None, :]] = \
            sub[rm][:, cm].to(w.dtype)
    return w


def regrid_block(block: torch.Tensor, mesh: ProcessMesh, mp_new: int,
                 axes: Tuple[str, str] = ("data", "model")
                 ) -> Tuple[torch.Tensor, int]:
    """This rank's block of the padded W* grown from ``mp`` to ``mp_new``
    slots (zero beyond ``mp``), from ``block``, its block under ``mp``.
    Each rank sends every other rank the part of its block that falls in
    that rank's new block and receives the parts of its own the same way
    (one ``coll.exchange_pieces``), so no rank holds more than its old
    block, its new one and the parts in flight.  Returns the new block
    and the bytes this rank received."""
    r, c = mesh.shape[axes[0]], mesh.shape[axes[1]]
    br, bc = block.shape
    nbr, nbc = mp_new // r, mp_new // c
    i, j = mesh.axis_index(axes[0]), mesh.axis_index(axes[1])
    ki, kj = mesh.axis_names.index(axes[0]), mesh.axis_names.index(axes[1])

    def span(lo_a, n_a, lo_b, n_b):
        lo, hi = max(lo_a, lo_b), min(lo_a + n_a, lo_b + n_b)
        return (lo, hi) if lo < hi else None

    out = block.new_zeros((nbr, nbc))
    sends, wanted = {}, {}
    coords = list(mesh.coords)
    for pi in range(r):
        for pj in range(c):
            coords[ki], coords[kj] = pi, pj
            peer = int(np.ravel_multi_index(coords, mesh.dims))
            # this rank's old block in the peer's new block
            rs = span(i * br, br, pi * nbr, nbr)
            cs = span(j * bc, bc, pj * nbc, nbc)
            if rs and cs:
                piece = block[rs[0] - i * br:rs[1] - i * br,
                              cs[0] - j * bc:cs[1] - j * bc]
                if peer == mesh.rank:
                    out[rs[0] - i * nbr:rs[1] - i * nbr,
                        cs[0] - j * nbc:cs[1] - j * nbc] = piece
                else:
                    sends[peer] = piece
            # the peer's old block in this rank's new block
            rs = span(pi * br, br, i * nbr, nbr)
            cs = span(pj * bc, bc, j * nbc, nbc)
            if rs and cs and peer != mesh.rank:
                wanted[peer] = (rs, cs)
    got = coll.exchange_pieces(
        sends, {p: (rs[1] - rs[0], cs[1] - cs[0])
                for p, (rs, cs) in wanted.items()}, block, mesh)
    for p, (rs, cs) in wanted.items():
        out[rs[0] - i * nbr:rs[1] - i * nbr,
            cs[0] - j * nbc:cs[1] - j * nbc] = got[p]
    return out, sum(t.numel() * t.element_size() for t in got.values())


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


@register_backend("sharded")
class ShardedEngine(_EngineBase):
    """The mesh backend: W* partitioned over a logical block grid, queries
    served off a ``DeviceSnapshot`` landed on the mesh.

    Build runs ``sharded_maxmin_closure`` exactly once (allgather or ring
    schedule) and keeps the padded float32 closure resident on the mesh's
    device.  The snapshot derives the per-vertex label rows
    ``svals[u] = max_{e ∋ u} W*[e, :]`` on the device (a loop over the
    degree dimension with one [n_pad, mp] panel) and casts them to int32,
    so the snapshot survives across query batches.  Same exactness
    argument as the single-device ``closure`` backend: every hyperedge is
    a hub, and the bottleneck triangle inequality makes the shared join
    exact on these rows.

    Mesh handling: ``mesh=None`` builds ``default_line_graph_mesh`` on
    ``device``; a logical grid of any shape runs on one device.  On a
    ``ProcessMesh`` every rank builds, queries and updates with the same
    arguments (SPMD; ``rank_mesh`` is the mesh).  In the closure regime a
    rank keeps only its W* block ([mp/r, mp/c], ``rank_nbytes``); the
    snapshot is derived by a max over the rows each rank holds, a
    max-reduce over the row axis and an all-gather over the column axis,
    so every rank holds the same replicated snapshot and answers every
    query.  In the label regime every rank holds the whole ``HLIndex``
    (``build_sharded`` across the ranks) and only its block of the
    snapshot (``to_mesh``); a batch gathers its query rows across the
    ranks.

    ``build_labels=True`` switches the backend from the closure regime to
    the **label regime**: build runs sharded HL-index construction
    (``hlindex.build_sharded`` over this mesh — byte-identical to
    ``build_fast``) and serves queries off the label snapshot landed on
    the mesh [n·Lmax ≪ m²].  Scalar queries answer through the paper's
    host merge-join.

    **Scoped updates (capability "scoped"), both regimes.**  Labels and
    closure entries never cross line-graph components, so an edit only
    invalidates the component(s) containing its 1-hop touched set:

    * closure regime — hyperedges map to physical W* slots through
      ``_slot_of`` (deletes free slots, inserts take the lowest free
      ones, so W* is never permuted); the (max,min) fixpoint reruns over
      the touched components' sub-line-graph alone and the closed block
      is scattered into the resident W* at its slots (freed slots' rows /
      columns zeroed).  The cached snapshot is patched row-wise from the
      same sub-closure (``DeviceSnapshot.patch_rows``), so updates stay
      scoped even after ``snapshot()`` dropped W*.
    * label regime — ``apply_updates`` with the engine's persistent
      ``NeighborCSR`` (1-hop patched per edit) and ``build_sharded`` as
      the scope builder.  Its ``functools.partial`` binds no mesh, as the
      reference's does, so on ranks every rank rebuilds the scope itself,
      alike; each then patches the dirty rows of its snapshot block.

    On ranks the closure regime closes the scope's sub-line-graph with
    ``sharded_maxmin_closure`` on the same ranks and gathers it
    (``gather_blocks``: scope-sized, and the snapshot row patch needs its
    rows anyway); each rank scatters into its W* block only the entries
    whose slots fall in its rows and columns.  Growing the slot padding
    moves the block grid: each rank receives from the others only the
    parts of their old blocks that fall in its new one (``regrid_block``;
    ``last_regrid_bytes``: the bytes this rank received for it in the
    last update, 0 where the padding did not grow).

    Both paths report true ``refreshed_vertices`` through the dirty-rows
    contract, so ``ReplicaGroup`` fan-out patches rows instead of
    re-landing snapshots whole.
    """

    name = "sharded"
    update_capability = "scoped"
    # closure/label rows serve the label-row reductions; the host graph
    # is maintained under updates, so the traversal ops run too
    workload_capability = frozenset(WORKLOAD_OPS)
    _gate_hop_bounded = True

    def __init__(self, h, mesh: LogicalMesh, axes: Tuple[str, str],
                 schedule: str, w_star_padded: Optional[torch.Tensor],
                 m_true: int, rounds: Optional[int] = None,
                 idx: Optional[HLIndex] = None,
                 minimizer=None, workers: Optional[int] = None,
                 num_shards: Optional[int] = None,
                 neighbors: Optional[NeighborCSR] = None):
        super().__init__(h)
        self.mesh = mesh
        if isinstance(mesh, ProcessMesh):
            self.rank_mesh = mesh
        self.last_regrid_bytes = 0
        self.device = mesh.device
        self.axes = axes
        self.schedule = schedule
        self.rounds = rounds
        # [mp, mp] float32 on the mesh (this rank's [mp/r, mp/c] block
        # on a ProcessMesh)
        self._w_star = w_star_padded
        self._m_padded = (int(w_star_padded.shape[0])
                          * (mesh.shape[axes[0]]
                             if isinstance(mesh, ProcessMesh) else 1)
                          if w_star_padded is not None else 0)
        self._m_true = m_true
        self._idx = idx                    # label regime (build_labels=True)
        self._minimizer = minimizer
        self._workers = workers
        self._num_shards = num_shards
        self._nbr = neighbors              # persistent line-graph CSR
        # hyperedge id -> physical W*/snapshot column; identity until a
        # scoped update frees/reuses slots
        self._slot_of = np.arange(m_true, dtype=np.int64)
        # (dirty_vertices, sval rows [d, mp], mp) staged by a scoped
        # closure update for the next snapshot() patch
        self._pending_rows: Optional[Tuple[np.ndarray, np.ndarray, int]] \
            = None
        self._snap: Optional[DeviceSnapshot] = None

    @property
    def build_labels(self) -> bool:
        """True when this engine serves labels instead of the closure."""
        return self._idx is not None

    @staticmethod
    def _closure_of(h, mesh, axes, schedule, rounds, use_kernels=False):
        """(padded float32 W* on the mesh, m_true) for ``h`` — build and
        update share this so an updated engine is bit-identical to a
        rebuilt one."""
        if h.m == 0:
            return torch.zeros((0, 0), dtype=torch.float32,
                               device=mesh.device), 0
        w = h.line_graph(np.int32).astype(np.float32)
        w_star = sharded_maxmin_closure(w, mesh, rounds=rounds,
                                        schedule=schedule, axes=axes,
                                        trim=False, use_kernels=use_kernels)
        return w_star, h.m

    @classmethod
    def build(cls, h, *, mesh: Optional[LogicalMesh] = None,
              schedule: str = "allgather",
              axes: Optional[Tuple[str, str]] = None,
              rounds: Optional[int] = None,
              build_labels: bool = False,
              minimize_labels: bool = True,
              workers: Optional[int] = None,
              num_shards: Optional[int] = None,
              use_kernels: bool = False,
              device: DeviceLike = None) -> "ShardedEngine":
        """``schedule`` ∈ {"allgather", "ring"} picks the round's plan
        (see module docstring); ``rounds`` caps the squaring ladder
        (None = ⌈log2 mp⌉, exact).  ``axes`` names the (row, column) mesh
        axes; None uses the mesh's own last two axis names, or
        ``("data", "model")`` when the mesh is built here.
        ``build_labels=True`` builds the HL-index with sharded
        construction on this mesh instead of the resident closure
        (``minimize_labels`` / ``workers`` / ``num_shards`` configure
        it); ``schedule`` / ``rounds`` are then unused.
        ``use_kernels=True`` runs each block contraction through the
        ``maxmin_matmul`` kernel (float32) and batch queries through the
        ``label_join_gather`` kernel — answers byte-identical either way.

        ``device`` is where everything lands: ``None`` means the mesh's
        device, or ``"cuda"`` when no mesh is given; a ``device`` that
        differs from the mesh's raises."""
        if axes is None:
            axes = (("data", "model") if mesh is None
                    else tuple(mesh.axis_names[-2:]))
        if mesh is None:
            mesh = default_line_graph_mesh(axes, device=device)
        elif device is not None and not _same_device(
                resolve_device(device), mesh.device):
            raise ValueError(f"device {device} differs from the mesh's "
                             f"device {mesh.device}")
        if len(axes) < 2:
            raise ValueError(
                f"the sharded backend needs a mesh with >= 2 axes to 2-D "
                f"block-shard over; got axis names {mesh.axis_names}")
        axes = tuple(axes)
        if build_labels:
            minimizer = minimize if minimize_labels else None
            # the neighbor index is computed here (same host/mesh route
            # build_sharded would pick) and kept on the engine: scoped
            # updates 1-hop patch it instead of re-running the pair pass
            nbr = neighbor_csr(h, mesh=mesh if (auto_device_overlaps(h)
                               and int(mesh.devices.size) > 1) else None)
            idx = build_sharded(h, mesh=mesh, minimizer=minimizer,
                                workers=workers, num_shards=num_shards,
                                neighbors=nbr)
            eng = cls(h, mesh, axes, schedule, None, h.m, rounds,
                      idx=idx, minimizer=minimizer, workers=workers,
                      num_shards=num_shards, neighbors=nbr)
            eng.use_kernels = bool(use_kernels)
            return eng
        w_star, m_true = cls._closure_of(h, mesh, axes, schedule, rounds,
                                         use_kernels)
        eng = cls(h, mesh, axes, schedule, w_star, m_true, rounds)
        eng.use_kernels = bool(use_kernels)
        return eng

    def _apply_update(self, inserts=(), deletes=()) -> None:
        """Scoped maintenance on the same mesh (capability "scoped"):
        the label regime splices the touched components through the
        sharded builder, the closure regime re-closes only the touched
        block of W* and patches the resident structures in place."""
        if self._idx is not None:
            self._apply_label_update(inserts, deletes)
        else:
            self._apply_closure_update(inserts, deletes)

    def _apply_label_update(self, inserts, deletes) -> None:
        if self._nbr is None:
            # a restored engine lost the build-time neighbor index; pay
            # the pair pass once, then every update 1-hop patches it
            self._nbr = neighbor_csr(self.h)
        builder = functools.partial(build_sharded, workers=self._workers,
                                    num_shards=self._num_shards)
        new_h, self._idx, report = apply_updates(
            self.h, self._idx, inserts, deletes, builder=builder,
            minimizer=self._minimizer, neighbors=self._nbr)
        self._nbr = report.neighbors
        self._m_true = new_h.m
        self._graph_changed(new_h,
                            dirty_rows=(None if report.full_rebuild
                                        else report.refreshed_vertices))

    def _apply_closure_update(self, inserts, deletes) -> None:
        self.last_regrid_bytes = 0
        old_h = self.h
        new_h, old_to_new, touched = apply_edge_edits(old_h, inserts,
                                                      deletes)
        scope = (np.fromiter(sorted(component_of(new_h, touched)),
                             np.int64) if touched.size
                 else np.empty(0, np.int64))
        has_basis = self._w_star is not None or self._snap is not None
        if not has_basis or old_h.m == 0 or scope.size == new_h.m:
            # nothing resident to patch, or the edit reaches every
            # hyperedge: recompute whole (identical to a fresh build)
            self._w_star, self._m_true = self._closure_of(
                new_h, self.mesh, self.axes, self.schedule, self.rounds,
                self.use_kernels)
            self._m_padded = int(self._w_star.shape[0]) * (
                self.mesh.shape[self.axes[0]] if self.rank_mesh is not None
                else 1)
            self._slot_of = np.arange(new_h.m, dtype=np.int64)
            self._pending_rows = None
            self._graph_changed(new_h)
            return

        # -- slot bookkeeping: survivors keep their physical W* slots,
        # deletions free theirs, inserts take the lowest free slots (so
        # the resident [mp, mp] is never permuted, only patched)
        mp = self._m_padded
        del_ids = np.asarray(sorted({int(d) for d in deletes}), np.int64)
        freed = (self._slot_of[del_ids] if del_ids.size
                 else np.empty(0, np.int64))
        keep = np.nonzero(old_to_new >= 0)[0]
        slot_of = np.empty(new_h.m, np.int64)
        if keep.size:
            slot_of[old_to_new[keep]] = self._slot_of[keep]
        n_new_edges = new_h.m - keep.size
        if n_new_edges:
            used = self._slot_of[keep]
            free = np.setdiff1d(np.arange(mp, dtype=np.int64), used)
            if free.size < n_new_edges:
                lcm = int(np.lcm(self.mesh.shape[self.axes[0]],
                                 self.mesh.shape[self.axes[1]]))
                mp = _round_up(mp + n_new_edges - free.size, lcm)
                self._grow_w_padding(mp)
                free = np.setdiff1d(np.arange(mp, dtype=np.int64), used)
            slot_of[keep.size:] = free[:n_new_edges]
        self._slot_of = slot_of

        # -- re-close only the touched components' block.  Extracting
        # whole components preserves every overlap, and no (max,min)
        # walk crosses a component boundary, so the sub-closure equals
        # the full closure restricted to the scope.
        if scope.size:
            sub_h, sub_verts = induced_subhypergraph(new_h, scope)
            on_ranks = self.rank_mesh is not None
            closed = sharded_maxmin_closure(
                sub_h.line_graph(np.int32).astype(np.float32), self.mesh,
                rounds=self.rounds, schedule=self.schedule,
                axes=self.axes, trim=not on_ranks,
                use_kernels=self.use_kernels)
            if on_ranks:
                closed = gather_blocks(closed, self.mesh, self.axes)[
                    :scope.size, :scope.size]
        else:
            sub_h, sub_verts = None, np.empty(0, np.int64)
            closed = torch.zeros((0, 0), dtype=torch.float32,
                                 device=self.device)
        scope_slots = (slot_of[scope] if scope.size
                       else np.empty(0, np.int64))

        # -- patch the resident W* (if still held).  Old entries between
        # a scope slot and a surviving non-scope slot are already 0
        # (different components), so zero-freed + scatter-scope is the
        # complete delta.
        if self._w_star is not None and (freed.size or scope.size):
            dev = self.device
            freed_t = torch.from_numpy(freed).to(dev)
            slots_t = torch.from_numpy(scope_slots).to(dev)
            r0 = c0 = 0
            if self.rank_mesh is not None:
                br, bc = self._w_star.shape
                r0 = self.mesh.axis_index(self.axes[0]) * br
                c0 = self.mesh.axis_index(self.axes[1]) * bc
            self._w_star = _closure_patcher(self._w_star, r0, c0, freed_t,
                                            slots_t, closed)

        # -- stage the snapshot row patch: dirty vertices are exactly
        # the scope's vertices plus those of deleted hyperedges (which
        # may have lost their last hyperedge).  Their sval rows come
        # from the sub-closure alone.
        if self._snap is not None:
            dirty = sub_verts
            if del_ids.size:
                dv = np.unique(np.concatenate(
                    [old_h.edge(int(d)) for d in del_ids]))
                dirty = np.union1d(dirty, dv)
            rows = np.zeros((dirty.size, mp), np.int32)
            if scope.size and sub_verts.size:
                closed_host = closed.cpu().numpy()
                block = np.zeros((sub_verts.size, scope.size), np.float32)
                rr = np.repeat(np.arange(sub_h.n), np.diff(sub_h.v_ptr))
                np.maximum.at(block, rr, closed_host[sub_h.v_idx])
                pos = np.searchsorted(dirty, sub_verts)
                rows[pos[:, None], scope_slots[None, :]] = \
                    block.astype(np.int32)
            self._merge_pending(dirty.astype(np.int64), rows, mp)
            self._m_true = new_h.m
            self._graph_changed(new_h, dirty_rows=dirty)
        else:
            self._pending_rows = None
            self._m_true = new_h.m
            self._graph_changed(new_h, dirty_rows=None)
            # the fresh W* patch is the whole resident state; the next
            # snapshot() derives from it whole
            self._snap = None

    def _grow_w_padding(self, mp_new: int) -> None:
        """Grow the padded slot space to ``mp_new`` (zero padding is the
        (max,min) annihilator, so growth never changes an answer).  On
        ranks the block grid moves with it: this rank's new block is
        assembled from the parts of the old blocks
        that fall in it (``regrid_block``)."""
        if self._w_star is not None:
            pad = mp_new - self._m_padded
            if self.rank_mesh is None:
                self._w_star = torch.nn.functional.pad(self._w_star,
                                                       (0, pad, 0, pad))
            else:
                self._w_star, self.last_regrid_bytes = regrid_block(
                    self._w_star, self.mesh, mp_new, self.axes)
        self._m_padded = mp_new

    def _merge_pending(self, dirty: np.ndarray, rows: np.ndarray,
                       mp: int) -> None:
        """Accumulate staged snapshot rows across updates between two
        ``snapshot()`` calls.  A previously staged row not re-dirtied by
        this update is still valid (its component was not in this
        update's scope); only zero-padding to the grown width is
        needed."""
        prev = self._pending_rows
        if prev is not None:
            pd, prows, pmp = prev
            stale = ~np.isin(pd, dirty)
            if stale.any():
                old_rows = np.zeros((int(stale.sum()), mp), np.int32)
                old_rows[:, :pmp] = prows[stale]
                dirty = np.concatenate([dirty, pd[stale]])
                rows = np.concatenate([rows, old_rows])
                order = np.argsort(dirty)
                dirty, rows = dirty[order], rows[order]
        self._pending_rows = (dirty, rows, mp)

    # -- queries: everything routes through the resident snapshot (label
    # regime scalars short-circuit to the paper's host merge-join) -------

    def mr(self, u: int, v: int) -> int:
        if self._idx is not None:
            # the closure regime validates scalars through the batch
            # path; the label short-circuit rejects the same inputs
            self._check_vertex_ids(u, v)
            return mr_query(self._idx, int(u), int(v))
        return int(self.mr_batch(np.array([int(u)]), np.array([int(v)]))[0])

    def s_reach(self, u: int, v: int, s: int) -> bool:
        if self._idx is not None:
            self._check_vertex_ids(u, v)
            return s_reach_query(self._idx, int(u), int(v), int(s))
        return self.mr(u, v) >= int(s)

    def mr_batch(self, us, vs) -> np.ndarray:
        us, vs = self._device_pairs(us, vs)
        return (self._query_snapshot().mr(us, vs).cpu().numpy()
                .astype(np.int64))

    def s_reach_batch(self, us, vs, s: int) -> np.ndarray:
        us, vs = self._device_pairs(us, vs)
        return self._query_snapshot().s_reach(us, vs, int(s)).cpu().numpy()

    def snapshot(self) -> DeviceSnapshot:
        """Current padded device form.  After a scoped update the stale
        snapshot is **patched**: only the dirty rows are re-derived (from
        the spliced labels, or from the staged sub-closure rows) and
        copied over a clone of the old tensors.  Only a full re-derivation
        frees W*, and only while no WAL is attached — with an
        ``IndexStore`` in front, more updates are coming and the resident
        closure is what keeps them patchable in place, so it is
        retained."""
        if self._snapshot_current():
            return self._snap
        basis, dirty = self._snap, self._dirty_rows
        if self._idx is not None and basis is not None and dirty is not None:
            self._snap = self._patched_label_snapshot(basis, dirty)
            self.last_snapshot_refresh_rows = int(np.asarray(dirty).size)
        elif (basis is not None and dirty is not None
                and self._pending_rows is not None):
            self._snap = self._patched_closure_snapshot(basis)
            self.last_snapshot_refresh_rows = int(self._pending_rows[0].size)
        else:
            self._snap = self._build_snapshot()
            self.last_snapshot_refresh_rows = self.h.n
            if self._idx is None and self._wal is None:
                # static serving: every query path serves off the
                # snapshot from here on — free the closure so the
                # resident footprint is the snapshot alone (scoped
                # updates still work: they patch the snapshot directly)
                self._w_star = None
        self._pending_rows = None
        self._dirty_rows = np.empty(0, np.int64)
        return self._snap

    def _slot_ceiling(self) -> int:
        """Number of leading snapshot columns that can carry a live
        hyperedge (max occupied slot + 1) — the row ``lengths`` bound.
        Identity slots make this ``m_true``, matching a fresh build."""
        return int(self._slot_of.max()) + 1 if self._slot_of.size else 0

    def _patched_closure_snapshot(self, basis: DeviceSnapshot
                                  ) -> DeviceSnapshot:
        dirty, rows, mp = self._pending_rows
        cur_l = int(basis.ranks.shape[1])
        lmax = max(cur_l, mp)
        if rows.shape[1] < lmax:
            rows = np.pad(rows, ((0, 0), (0, lmax - rows.shape[1])))
        n_eff = max(int(basis.ranks.shape[0]),
                    _round_up(self.h.n, self.mesh.shape[self.axes[0]]))
        # rank space = slot id, dense ascending per row (same form the
        # full derivation materializes); untouched rows keep theirs
        row_ranks = np.broadcast_to(np.arange(lmax, dtype=np.int32),
                                    (dirty.size, lmax))
        row_lengths = np.full(dirty.size, self._slot_ceiling(), np.int32)
        return basis.patch_rows(dirty, row_ranks, rows, row_lengths,
                                n=n_eff, lmax=lmax, version=self.version,
                                backend=self.name)

    def _patched_label_snapshot(self, basis: DeviceSnapshot,
                                dirty) -> DeviceSnapshot:
        idx = self._idx
        dirty = np.asarray(dirty, np.int64)
        basis_max = (basis.lengths.max() if basis.lengths.numel()
                     else torch.zeros((), dtype=torch.int32,
                                      device=basis.device))
        if basis.block:      # lengths are split over the row axis
            basis_max = coll.all_reduce_max(basis_max.reshape(1),
                                            self.mesh, self.axes[0])
        dirty_len = [idx.labels_s[int(u)].size for u in dirty]
        lmax = int(max(int(basis_max.max()), max(dirty_len, default=0)))
        n_eff = max(basis.global_shape[0], self.h.n)
        if (basis.block and basis.padded_geometry(n_eff, lmax)
                != basis.padded_shape):
            # the block grid moves: rows this rank would own live on
            # others, so its block is re-landed from the whole labels
            return self._label_blocks(n_eff, lmax)
        row_ranks, row_svals, row_lengths = pad_label_rows(
            [idx.labels_rank[int(u)] for u in dirty],
            [idx.labels_s[int(u)] for u in dirty], pad_to=lmax)
        return basis.patch_rows(dirty, row_ranks, row_svals, row_lengths,
                                n=n_eff, lmax=lmax, version=self.version,
                                backend=self.name)

    def _label_blocks(self, n: Optional[int] = None,
                      lmax: Optional[int] = None) -> DeviceSnapshot:
        """The label snapshot on a ``ProcessMesh``: padded on the host
        (to ``n`` rows and ``lmax`` columns where given, the shape a
        patch would have reached) and only this rank's block landed (the
        whole never reaches the card)."""
        ranks, svals, lengths = self._idx.as_padded(pad_to=lmax)
        if n is not None and n > ranks.shape[0]:
            extra = n - ranks.shape[0]
            ranks = np.pad(ranks, ((0, extra), (0, 0)),
                           constant_values=np.iinfo(np.int32).max)
            svals = np.pad(svals, ((0, extra), (0, 0)))
            lengths = np.pad(lengths, (0, extra))
        snap = DeviceSnapshot.from_padded(ranks, svals, lengths, self.name,
                                          version=self.version, device="cpu")
        blocks = snap.to_mesh(self.mesh, self.axes)
        if n is not None:
            # a patch's whole keeps its own shape, as the reference's
            blocks.whole_shape = tuple(int(x) for x in ranks.shape)
        return blocks

    def _build_snapshot(self) -> DeviceSnapshot:
        h, mesh, dev = self.h, self.mesh, self.device
        row_ax, _ = self.axes
        if self._idx is not None:
            if self.rank_mesh is not None and h.n and self._idx.num_labels:
                return self._label_blocks()
            snap = DeviceSnapshot.from_hlindex(self._idx, self.name,
                                               version=self.version,
                                               device=dev)
            if h.n == 0 or snap.lmax == 0:
                return snap            # nothing to place on the mesh
            return snap.to_mesh(mesh, self.axes)
        if self._m_true == 0 or h.n == 0:
            z = np.zeros((h.n, 0), np.int32)
            return DeviceSnapshot.from_padded(z, z, np.zeros(h.n, np.int32),
                                              self.name, version=self.version,
                                              device=dev)
        mp = self._m_padded
        n_pad = _round_up(h.n, mesh.shape[row_ax])
        deg = np.diff(h.v_ptr)
        d_max = max(int(deg.max()), 1)
        # padded incidence: inc[u, k] = W* slot of the k-th hyperedge of
        # u, mp = no hyperedge (its row is masked to 0, the annihilator)
        inc = np.full((n_pad, d_max), mp, np.int64)
        rows = np.repeat(np.arange(h.n), deg)
        cols = np.arange(h.nnz) - np.repeat(h.v_ptr[:-1], deg)
        inc[rows, cols] = self._slot_of[h.v_idx]   # edge id -> W* slot
        inc_dev = torch.from_numpy(inc).to(dev)
        w_star = self._w_star
        on_ranks = isinstance(mesh, ProcessMesh)
        # the W* rows held here: all of them, or this rank's row block
        held = int(w_star.shape[0])
        first = mesh.axis_index(row_ax) * held if on_ranks else 0
        # svals[u] = max_{e in E(u)} W*[e, :], one degree column at a
        # time so the working set stays one [n_pad, mp] panel (on ranks:
        # over the held rows and columns, then max-reduced over the row
        # axis and gathered over the column axis)
        svals = torch.zeros((n_pad, int(w_star.shape[1])),
                            dtype=w_star.dtype, device=dev)
        for d in range(d_max):
            row = inc_dev[:, d] - first
            valid = (row >= 0) & (row < held)
            panel = w_star.index_select(0, row.clamp(0, held - 1))
            panel.mul_(valid[:, None].to(panel.dtype))
            torch.maximum(svals, panel, out=svals)
        if on_ranks:
            svals = coll.all_reduce_max(svals, mesh, row_ax)
            svals = coll.all_gather_panel(svals, mesh, self.axes[1], dim=1)
        # rank space = slot id (ascending per row by construction);
        # padded columns carry sval 0, which can never win the join max
        ranks = torch.arange(mp, dtype=torch.int32,
                             device=dev).expand(n_pad, mp).contiguous()
        lengths = torch.zeros((n_pad,), dtype=torch.int32, device=dev)
        # every occupied slot must fall inside the row length; identity
        # slots make this m_true, same as before scoped maintenance
        lengths[:h.n] = self._slot_ceiling()
        return DeviceSnapshot(ranks=ranks, svals=svals.to(torch.int32),
                              lengths=lengths, backend=self.name,
                              version=self.version, mesh=mesh,
                              axes=self.axes)

    def block_until_built(self) -> None:
        if self._w_star is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def nbytes(self) -> int:
        """Bytes of the resident structures, W* counted whole (on a
        ``ProcessMesh`` too, as the reference counts its sharded W*)."""
        total = 0
        if self._w_star is not None:
            total += self._m_padded * self._m_padded * 4
        if self._idx is not None:
            total += self._idx.nbytes()
        if self._nbr is not None:
            total += self._nbr.nbytes()
        if self._snap is not None:
            total += self._snap.nbytes()
        return total

    def rank_nbytes(self) -> int:
        """This process's share of ``nbytes()``: its W* block and the
        snapshot it holds, a label snapshot's block or the replicated
        closure snapshot (on a ``LogicalMesh``, all of ``nbytes()``)."""
        if not isinstance(self.mesh, ProcessMesh):
            return self.nbytes()
        total = self.nbytes()
        if self._w_star is not None:
            total += (self._w_star.numel() * self._w_star.element_size()
                      - self._m_padded * self._m_padded * 4)
        if self._snap is not None:
            total += self._snap.rank_nbytes() - self._snap.nbytes()
        return total
