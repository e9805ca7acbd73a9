"""Query processing (Section VI): Algorithm 5 + the batched device engine.

``mr_query`` is the faithful merge-join (labels sorted ascending by
importance rank; advance the pointer holding the more-important hub; skip
entries whose s cannot improve the running answer).

``batched_mr`` is the device serving path in plain tensor ops: labels
exported as padded dense tensors (``HLIndex.as_padded``), queries answered
by a vectorized ``searchsorted`` join — every query costs O(Lmax log Lmax)
of independent work with no host pointer chasing.  ``KernelSnapshot``
answers the same batches through the hand-written ``label_join`` CUDA
kernel instead.  This is the engine the paper's Exp-1 (1,000-query
workload) maps onto.

Counterpart of ``repro/core/query.py``, same names in the same order.
``DeviceSnapshot.to_mesh`` lands a snapshot on a logical block grid
(``core/mesh.py``): padded to the grid and recorded with its mesh, the
form the ``sharded`` backend and mesh-resident serving hold.  The
reference's jitted row scatter (``_mesh_row_scatter``) is an
``index_copy`` here.  On a ``ProcessMesh`` each rank keeps only its block
of the padded tensors (``whole_shape`` set); a batch on such a snapshot
gathers its query rows across the ranks, as the reference's
``KernelSnapshot.mr`` gathers them off a sharded snapshot, and joins the
``[Q, L]`` rows on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import collectives as coll
from .hlindex import HLIndex
from .mesh import ProcessMesh

__all__ = ["mr_query", "s_reach_query", "mr_query_dicts", "DeviceSnapshot",
           "KernelSnapshot", "PaddedIndex", "batched_mr", "searchsorted_join"]

_INT32_MAX = int(np.iinfo(np.int32).max)


def mr_query(idx: HLIndex, u: int, v: int) -> int:
    """Algorithm 5: MR(u, v) from two sorted label lists."""
    ru, su = idx.labels_rank[u], idx.labels_s[u]
    rv, sv = idx.labels_rank[v], idx.labels_s[v]
    i = j = 0
    k = 0
    while i < ru.size and j < rv.size:
        if su[i] <= k or ru[i] < rv[j]:      # line 5
            i += 1
        elif sv[j] <= k or ru[i] > rv[j]:    # line 6
            j += 1
        else:                                # line 7: common hub, both s > k
            k = int(min(su[i], sv[j]))
            i += 1
            j += 1
    return k


def s_reach_query(idx: HLIndex, u: int, v: int, s: int) -> bool:
    """Problem 1 via the Section-VI modification: seed k = s-1; true on the
    first common-hub hit (early exit)."""
    ru, su = idx.labels_rank[u], idx.labels_s[u]
    rv, sv = idx.labels_rank[v], idx.labels_s[v]
    i = j = 0
    k = s - 1
    while i < ru.size and j < rv.size:
        if su[i] <= k or ru[i] < rv[j]:
            i += 1
        elif sv[j] <= k or ru[i] > rv[j]:
            j += 1
        else:
            return True
    return False


def mr_query_dicts(lu: Dict[int, int], lv: Dict[int, int],
                   rank: np.ndarray) -> int:
    """MR from dict-form labels (used by the minimization passes)."""
    if len(lu) > len(lv):
        lu, lv = lv, lu
    best = 0
    for e, s in lu.items():
        s2 = lv.get(e)
        if s2 is not None:
            m = min(s, s2)
            if m > best:
                best = m
    return best


# ---------------------------------------------------------------------------
# batched device engine
# ---------------------------------------------------------------------------

def _as_index(ids, device: torch.device) -> torch.Tensor:
    """Vertex ids as a 1-D int64 tensor on ``device`` (torch indexing and
    ``searchsorted`` want int64): one host->device copy for host input."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.int64).reshape(-1)
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(ids, np.int64).ravel())).to(device)


def _land(a, device: torch.device) -> torch.Tensor:
    """``a`` as a contiguous int32 tensor on ``device``; host arrays are
    copied, so a snapshot never aliases its caller's buffers."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32).contiguous()
    return torch.tensor(np.asarray(a, np.int32)).to(device)


@dataclasses.dataclass(eq=False)    # identity equality/hash: fields are tensors
class DeviceSnapshot:
    """Padded per-vertex label tensors on device, served by ``batched_mr``.

    Tensor layout and sentinel conventions:

    * ``ranks`` [n, Lmax] int32 — per-row **ascending** hub keys; rows
      shorter than Lmax are padded with ``INT32_MAX`` (2^31 - 1).  The
      padding sentinel can never equal a real hub key, so a padding slot
      only ever "matches" another padding slot — and then contributes
      ``min(0, 0) = 0`` to the join max, i.e. nothing.
    * ``svals`` [n, Lmax] int32 — the s-value carried by each label;
      padding slots hold 0 (0 = "no s-walk", the identity of the max).
    * ``lengths`` [n] int32 — true label counts per row (metadata for
      size accounting; the join itself relies only on the sentinels).

    The row key space only needs to be consistent across rows (hub
    importance rank for the HL-index backends, raw hyperedge id for
    closure-derived rows) — this is the one device-resident serving
    form every label-shaped backend of ``repro_torch.core.engine`` exports.

    ``version`` records the engine version the snapshot was derived from
    (see ``ReachabilityEngine.update``): after an update, the engine's
    ``snapshot()`` re-derives a fresh snapshot with the bumped version,
    while previously handed-out snapshots keep their old version — a
    snapshot with ``snap.version != engine.version`` is stale.

    ``to_mesh`` re-lands the same tensors on a logical block grid
    (``core/mesh.py``): rows padded to a multiple of the row axis, label
    columns to a multiple of the column axis, with the same sentinels.
    The result records ``mesh`` / ``axes`` (both ``None`` for a snapshot
    that is on no mesh) and keeps ``version``, so resharded copies stay
    comparable.

    Snapshots are immutable; incremental refresh produces *new* snapshots:
    ``patch_rows`` replaces only the label rows a scoped update touched
    and never writes into this snapshot's tensors (torch's indexed
    assignment mutates, so the patch works on a clone), and
    ``to_mesh(base=..., dirty_rows=...)`` re-lands only those rows into a
    mesh-resident copy, in place only when the caller donates it.

    ``whole_shape`` marks a snapshot landed on a ``ProcessMesh`` by
    ``to_mesh`` (``block`` is then true): ``ranks`` / ``svals`` hold only
    this rank's ``[n_pad/r, l_pad/c]`` block of the whole padded up to the
    grid, ``lengths`` its ``[n_pad/r]`` rows, and ``whole_shape`` is the
    whole's own ``(rows, label columns)``, the shape the reference's
    sharded arrays report (``global_shape``, ``lmax``).  ``nbytes()``
    counts that whole, as the reference counts a sharded array, and
    ``rank_nbytes()`` the block.  Every rank calls ``mr`` / ``s_reach``
    on such a snapshot with the same ids (SPMD).
    """

    ranks: torch.Tensor
    svals: torch.Tensor
    lengths: torch.Tensor
    backend: str = "hl-index"
    version: int = 0
    mesh: Optional[object] = None
    axes: Optional[Tuple[str, str]] = None
    whole_shape: Optional[Tuple[int, int]] = None

    @classmethod
    def from_padded(cls, ranks, svals, lengths, backend: str,
                    version: int = 0, *,
                    device: DeviceLike = None) -> "DeviceSnapshot":
        """Land padded host arrays on ``device`` (``None`` = ``"cuda"``;
        raises without a CUDA device unless ``device="cpu"`` is passed)."""
        dev = resolve_device(device)
        return cls(ranks=_land(ranks, dev), svals=_land(svals, dev),
                   lengths=_land(lengths, dev), backend=backend,
                   version=version)

    @classmethod
    def from_hlindex(cls, idx: HLIndex, backend: str = "hl-index",
                     version: int = 0, *,
                     device: DeviceLike = None) -> "DeviceSnapshot":
        ranks, svals, lengths = idx.as_padded()
        return cls.from_padded(ranks, svals, lengths, backend, version,
                               device=device)

    @property
    def device(self) -> torch.device:
        return self.ranks.device

    def to_mesh(self, mesh, axes: Optional[Tuple[str, str]] = None, *,
                base: Optional["DeviceSnapshot"] = None,
                dirty_rows=None,
                donate_base: bool = False) -> "DeviceSnapshot":
        """This snapshot on the logical block grid ``mesh``: vertex rows
        split along ``axes[0]``, label columns along ``axes[1]``
        (``lengths`` along ``axes[0]`` only).  ``axes=None`` uses the
        mesh's last two axis names, so any axis naming works.

        Rows / columns are padded up to grid-divisible sizes with the
        usual sentinels (ranks ``INT32_MAX``, svals 0, lengths 0), which
        are inert under the join, so the result answers identically.  It
        lands on ``mesh.device`` in new tensors (never an alias of this
        snapshot's) and records ``mesh`` / ``axes``.

        ``base`` + ``dirty_rows`` is the incremental re-land after a
        scoped update: when ``base`` is an earlier ``to_mesh`` copy of
        the same padded geometry, only the ``dirty_rows`` rows are
        copied from this snapshot into it (every other row of ``base``
        is already equal, by the ``UpdateReport`` contract).  The rows
        go into ``base``'s own tensors only with ``donate_base=True`` —
        ``base`` must not be used afterwards — and otherwise into a clone
        of them, because snapshots are immutable.  On a geometry change
        it re-lands whole; answers are identical either way.

        On a ``ProcessMesh`` rank (i, j) keeps only its block: rows
        ``[i·n_pad/r, (i+1)·n_pad/r)`` and label columns ``[j·l_pad/c,
        (j+1)·l_pad/c)`` of the padded tensors, with the same sentinels,
        in new tensors on ``mesh.device`` (``whole_shape`` is ``(n_pad,
        l_pad)``, the reference's sharded shape).  With
        ``base`` (an earlier block of the same padded geometry on the
        same mesh) and ``dirty_rows``, only the dirty rows this rank owns
        are copied, into a clone of ``base``'s block or, with
        ``donate_base=True``, into ``base``'s own tensors.  A block lands
        only on its own mesh and axes, where each rank copies its own
        block (or its dirty rows of it): the reference re-shards an
        array onto the mesh it already lies on, and gets a copy.
        """
        if self.block and (mesh != self.mesh or (
                axes is not None and tuple(axes) != tuple(self.axes))):
            raise ValueError("to_mesh of a block lands only on its own "
                             "mesh and axes: land the whole instead")
        if axes is None:
            axes = tuple(mesh.axis_names[-2:])
        if len(axes) < 2:
            raise ValueError(
                f"to_mesh needs two mesh axes (rows, label columns); the "
                f"mesh has axis names {mesh.axis_names}")
        axes = tuple(axes)
        row_ax, col_ax = axes
        r, c = mesh.shape[row_ax], mesh.shape[col_ax]
        n, lmax = self.global_shape
        n_pad = -(-n // r) * r if n else 0
        l_pad = -(-lmax // c) * c if lmax else 0
        if isinstance(mesh, ProcessMesh):
            return self._to_ranks(mesh, axes, n_pad, l_pad, base,
                                  dirty_rows, donate_base)
        dev = mesh.device
        if (base is not None and dirty_rows is not None
                and tuple(base.ranks.shape) == (n_pad, l_pad)):
            rows = _as_index(dirty_rows, self.device)
            pr = torch.full((rows.numel(), l_pad), _INT32_MAX,
                            dtype=torch.int32, device=dev)
            ps = torch.zeros((rows.numel(), l_pad), dtype=torch.int32,
                             device=dev)
            pr[:, :lmax] = self.ranks.index_select(0, rows).to(dev)
            ps[:, :lmax] = self.svals.index_select(0, rows).to(dev)
            pl = self.lengths.index_select(0, rows).to(dev)
            rows = rows.to(dev)
            out = [base.ranks, base.svals, base.lengths]
            if not donate_base:
                out = [t.clone() for t in out]
            for dst, src in zip(out, (pr, ps, pl)):
                dst.index_copy_(0, rows, src)
            ranks, svals, lengths = out
        else:
            ranks = torch.full((n_pad, l_pad), _INT32_MAX, dtype=torch.int32,
                               device=dev)
            svals = torch.zeros((n_pad, l_pad), dtype=torch.int32,
                                device=dev)
            lengths = torch.zeros((n_pad,), dtype=torch.int32, device=dev)
            ranks[:n, :lmax] = self.ranks
            svals[:n, :lmax] = self.svals
            lengths[:n] = self.lengths
        return DeviceSnapshot(ranks=ranks, svals=svals, lengths=lengths,
                              backend=self.backend, version=self.version,
                              mesh=mesh, axes=axes)

    def _to_ranks(self, mesh: ProcessMesh, axes: Tuple[str, str],
                  n_pad: int, l_pad: int, base, dirty_rows,
                  donate_base: bool) -> "DeviceSnapshot":
        """``to_mesh`` on a ``ProcessMesh``: this rank's block."""
        r, c = mesh.shape[axes[0]], mesh.shape[axes[1]]
        br, bc = n_pad // r, l_pad // c
        row0 = mesh.axis_index(axes[0]) * br
        col0 = mesh.axis_index(axes[1]) * bc
        n, lmax = self.ranks.shape
        if self.block:
            # this rank's rows and columns are the tensors themselves
            row0, col0, n, lmax = 0, 0, br, bc
        cols = slice(min(col0, lmax), min(col0 + bc, lmax))
        width = cols.stop - cols.start
        dev = mesh.device
        if (base is not None and dirty_rows is not None and base.block
                and base.mesh == mesh and tuple(base.axes) == axes
                and base.padded_shape == (n_pad, l_pad)):
            rows = _as_index(dirty_rows, self.device)
            first = mesh.axis_index(axes[0]) * br     # first row owned here
            local = rows[(rows >= first) & (rows < first + br)] - first
            rows = local + row0
            pr = torch.full((rows.numel(), bc), _INT32_MAX,
                            dtype=torch.int32, device=dev)
            ps = torch.zeros((rows.numel(), bc), dtype=torch.int32,
                             device=dev)
            pr[:, :width] = self.ranks.index_select(0, rows)[:, cols].to(dev)
            ps[:, :width] = self.svals.index_select(0, rows)[:, cols].to(dev)
            pl = self.lengths.index_select(0, rows).to(dev)
            local = local.to(dev)
            out = [base.ranks, base.svals, base.lengths]
            if not donate_base:
                out = [t.clone() for t in out]
            for dst, src in zip(out, (pr, ps, pl)):
                dst.index_copy_(0, local, src)
            ranks, svals, lengths = out
        else:
            held = slice(min(row0, n), min(row0 + br, n))
            ranks = torch.full((br, bc), _INT32_MAX, dtype=torch.int32,
                               device=dev)
            svals = torch.zeros((br, bc), dtype=torch.int32, device=dev)
            lengths = torch.zeros((br,), dtype=torch.int32, device=dev)
            k = held.stop - held.start
            ranks[:k, :width] = self.ranks[held, cols]
            svals[:k, :width] = self.svals[held, cols]
            lengths[:k] = self.lengths[held]
        return DeviceSnapshot(ranks=ranks, svals=svals, lengths=lengths,
                              backend=self.backend, version=self.version,
                              mesh=mesh, axes=axes,
                              whole_shape=(n_pad, l_pad))

    @property
    def block(self) -> bool:
        """True when this snapshot holds one rank's block of a whole."""
        return self.whole_shape is not None

    @property
    def global_shape(self) -> Tuple[int, int]:
        """``(rows, label columns)`` of the whole snapshot: the tensors'
        own shape, or ``whole_shape`` on a block."""
        if self.block:
            return self.whole_shape
        return tuple(int(x) for x in self.ranks.shape)

    @property
    def padded_shape(self) -> Tuple[int, int]:
        """The whole padded up to the grid, which the blocks tile."""
        rows, cols = (int(x) for x in self.ranks.shape)
        if not self.block:
            return rows, cols
        return (rows * self.mesh.shape[self.axes[0]],
                cols * self.mesh.shape[self.axes[1]])

    def patch_rows(self, rows, row_ranks, row_svals, row_lengths, *,
                   n: Optional[int] = None, lmax: Optional[int] = None,
                   version: Optional[int] = None,
                   backend: Optional[str] = None) -> "DeviceSnapshot":
        """A new snapshot with only ``rows`` replaced — the label-row
        re-derivation primitive behind snapshot caching across updates.

        ``row_ranks`` / ``row_svals`` are [len(rows), lmax] padded rows
        (``pad_label_rows(..., pad_to=lmax)`` form), ``row_lengths`` the
        true counts.  ``n`` / ``lmax`` resize the tensors first (rows
        appended with empty sentinel rows, columns padded with sentinels
        or sliced off) — legal because a clean row's content never
        exceeds the new ``lmax`` by the dirty-rows contract, so resizing
        touches only inert padding.  The result is byte-identical to a
        from-scratch derivation in which only ``rows`` changed; every
        untouched row is copied from this snapshot's tensors on the
        device without re-transfer, and this snapshot stays as it was.
        A snapshot on a mesh stays on it (``mesh`` / ``axes`` carry over),
        as the reference's sharded arrays keep their sharding.

        On a block ``rows`` and ``n`` are global and the rows full width;
        each rank copies in the dirty rows it owns, cut to its columns,
        and ``whole_shape`` becomes ``(n, lmax)``.  ``n`` / ``lmax`` must
        pad up to the block's own geometry: a change raises
        ``ValueError`` (the rows a rank would own live on other ranks;
        re-land with ``to_mesh``).
        """
        if self.block:
            return self._patch_block(rows, row_ranks, row_svals, row_lengths,
                                     n, lmax, version, backend)
        ranks, svals, lengths = self.ranks, self.svals, self.lengths
        dev = ranks.device
        cur_n, cur_l = ranks.shape
        n = cur_n if n is None else int(n)
        lmax = cur_l if lmax is None else int(lmax)
        pad = torch.nn.functional.pad
        if lmax > cur_l:
            ranks = pad(ranks, (0, lmax - cur_l), value=_INT32_MAX)
            svals = pad(svals, (0, lmax - cur_l), value=0)
        elif lmax < cur_l:
            ranks = ranks[:, :lmax]
            svals = svals[:, :lmax]
        if n > cur_n:
            ranks = pad(ranks, (0, 0, 0, n - cur_n), value=_INT32_MAX)
            svals = pad(svals, (0, 0, 0, n - cur_n), value=0)
            lengths = pad(lengths, (0, n - cur_n), value=0)
        rows = _as_index(rows, dev)
        if rows.numel():
            # index_copy is out of place: the old tensors are never written
            ranks = ranks.index_copy(0, rows, _land(row_ranks, dev))
            svals = svals.index_copy(0, rows, _land(row_svals, dev))
            lengths = lengths.index_copy(0, rows, _land(row_lengths, dev))
        return DeviceSnapshot(
            ranks=ranks.contiguous(), svals=svals.contiguous(),
            lengths=lengths.contiguous(),
            backend=self.backend if backend is None else backend,
            version=self.version if version is None else int(version),
            mesh=self.mesh, axes=self.axes)

    def padded_geometry(self, n: int, lmax: int) -> Tuple[int, int]:
        """``(n, lmax)`` rounded up to this block's grid."""
        r = self.mesh.shape[self.axes[0]]
        c = self.mesh.shape[self.axes[1]]
        return (-(-n // r) * r, -(-lmax // c) * c)

    def _patch_block(self, rows, row_ranks, row_svals, row_lengths, n,
                     lmax, version, backend) -> "DeviceSnapshot":
        n_all, l_all = self.global_shape
        n = n_all if n is None else int(n)
        lmax = l_all if lmax is None else int(lmax)
        if self.padded_geometry(n, lmax) != self.padded_shape:
            raise ValueError(
                f"patch_rows on a block: ({n}, {lmax}) pads to "
                f"{self.padded_geometry(n, lmax)}, not the block's "
                f"{self.padded_shape}; re-land with to_mesh")
        br, bc = (int(x) for x in self.ranks.shape)
        row0 = self.mesh.axis_index(self.axes[0]) * br
        col0 = self.mesh.axis_index(self.axes[1]) * bc
        dev = self.device
        rows = np.asarray(rows, np.int64).ravel()
        own = np.nonzero((rows >= row0) & (rows < row0 + br))[0]
        ranks, svals, lengths = self.ranks, self.svals, self.lengths
        if own.size:
            width = max(0, min(lmax, col0 + bc) - col0)
            pr = np.full((own.size, bc), _INT32_MAX, np.int32)
            ps = np.zeros((own.size, bc), np.int32)
            pr[:, :width] = np.asarray(row_ranks)[own, col0:col0 + width]
            ps[:, :width] = np.asarray(row_svals)[own, col0:col0 + width]
            local = torch.from_numpy(rows[own] - row0).to(dev)
            # index_copy is out of place: the old tensors are never written
            ranks = ranks.index_copy(0, local, _land(pr, dev))
            svals = svals.index_copy(0, local, _land(ps, dev))
            lengths = lengths.index_copy(
                0, local, _land(np.asarray(row_lengths)[own], dev))
        return DeviceSnapshot(
            ranks=ranks, svals=svals, lengths=lengths,
            backend=self.backend if backend is None else backend,
            version=self.version if version is None else int(version),
            mesh=self.mesh, axes=self.axes, whole_shape=(n, lmax))

    @property
    def lmax(self) -> int:
        return self.global_shape[1]

    def nbytes(self) -> int:
        """Bytes of the whole snapshot (of every block, on a block)."""
        if not self.block:
            return self.rank_nbytes()
        n, lmax = self.global_shape
        return 8 * n * lmax + 4 * n

    def rank_nbytes(self) -> int:
        """Bytes this process holds: the tensors themselves."""
        return int(sum(t.numel() * t.element_size()
                       for t in (self.ranks, self.svals, self.lengths)))

    def gather_query_rows(self, us: torch.Tensor, vs: torch.Tensor):
        """``(ru, su, rv, sv)``, the ``[Q, l_pad]`` label rows of ``us`` and
        ``vs``, on every rank of a block snapshot: each rank writes the
        rows it owns into sentinel-filled ``[2, Q, l_pad/c]`` buffers, one
        min-reduce (ranks) and one max-reduce (svals) over the row axis
        complete the column block (every row has one owner), and one
        all-gather of each over the column axis completes the rows.  Ids
        are validated first, on every rank, before any collective."""
        n_all, _ = self.global_shape
        ids = torch.stack([us, vs])
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n_all):
            raise IndexError(f"vertex ids must lie in [0, {n_all}), got "
                             f"[{int(ids.min())}, {int(ids.max())}]")
        br = int(self.ranks.shape[0])
        row0 = self.mesh.axis_index(self.axes[0]) * br
        own = ((ids >= row0) & (ids < row0 + br))[..., None]
        local = (ids - row0).clamp_(0, max(br - 1, 0))
        ranks = torch.where(own, self.ranks[local], _INT32_MAX)
        svals = torch.where(own, self.svals[local], 0)
        row_ax, col_ax = self.axes
        ranks = coll.all_reduce_min(ranks, self.mesh, row_ax)
        svals = coll.all_reduce_max(svals, self.mesh, row_ax)
        ranks = coll.all_gather_panel(ranks, self.mesh, col_ax, dim=2)
        svals = coll.all_gather_panel(svals, self.mesh, col_ax, dim=2)
        return tuple(t.contiguous() for t in (ranks[0], svals[0], ranks[1],
                                              svals[1]))

    def mr(self, us, vs) -> torch.Tensor:
        """[Q] int32 MR answers on the snapshot's device."""
        us = _as_index(us, self.device)
        vs = _as_index(vs, self.device)
        if self.lmax == 0 or (self.block and us.numel() == 0):
            # no labels anywhere (or no query): nothing is reachable
            return torch.zeros(us.shape, dtype=torch.int32,
                               device=self.device)
        if self.block:
            return searchsorted_join(*self.gather_query_rows(us, vs))
        return batched_mr(self.ranks, self.svals, us, vs)

    def s_reach(self, us, vs, s: int) -> torch.Tensor:
        return self.mr(us, vs) >= s


def _gather_rows(ranks, svals, us, vs):
    return ranks[us], svals[us], ranks[vs], svals[vs]


class KernelSnapshot:
    """Kernel-path query view over a ``DeviceSnapshot``.

    Answers ``mr`` / ``s_reach`` batches through the hand-written
    ``label_join`` CUDA kernel instead of the host merge-join or the
    tensor-op ``batched_mr``.  The kernel's gather entry point
    (``label_join_gather``) takes the resident ``ranks`` / ``svals``
    tensors and the batch's vertex ids and reads each query's two label
    rows itself: no ``[Q, Lmax]`` rows are gathered into device memory,
    so a batch adds only its ids and its answers to the device's memory
    (``batched_mr`` still gathers through ``_gather_rows``).  The view
    holds no tensors of its own beyond the wrapped snapshot.

    The reference gathers the rows, pads each batch to a power-of-two
    bucket (one compiled program per bucket shape) and to its kernel's
    block size.  A CUDA launch takes any ``Q`` and masks its own ragged
    edge, so this view pads neither: it launches once on exactly ``Q``
    id pairs.

    On a block snapshot (``block`` true, a ``ProcessMesh``) the query
    rows are gathered across the ranks first (``gather_query_rows``) and
    joined by the kernel's rows entry (``label_join``), as the
    reference's view gathers rows and joins them on one device.

    The wrapped ``base`` snapshot keeps its identity — patch plumbing
    (``patch_rows``) operates on the underlying ``DeviceSnapshot`` and the
    view is rebuilt around the result, which is why this is composition
    rather than subclassing.

    On a CPU snapshot ``label_join_gather`` runs its plain version (what
    the CPU tests use); on a CUDA snapshot it launches the kernel or
    raises.  Construction validates the rank key space against the
    kernel's padding sentinels once (``validate_ranks``), so per-batch
    calls don't pay the check.
    """

    def __init__(self, base: DeviceSnapshot):
        from ..kernels.label_join import label_join_gather, validate_ranks
        validate_ranks(base.ranks)
        self.base = base
        self._join = label_join_gather

    # geometry / identity delegate to the wrapped snapshot
    @property
    def backend(self) -> str:
        return self.base.backend

    @property
    def version(self) -> int:
        return self.base.version

    @property
    def lmax(self) -> int:
        return self.base.lmax

    @property
    def device(self) -> torch.device:
        return self.base.device

    def nbytes(self) -> int:
        return self.base.nbytes()

    def mr(self, us, vs) -> torch.Tensor:
        base = self.base
        dev = base.device
        us = _as_index(us, dev).contiguous()
        vs = _as_index(vs, dev).contiguous()
        if base.block:
            # the reference's gather-then-join: [Q, L] rows assembled
            # across the ranks, then the rows entry of the kernel
            if base.lmax == 0 or us.numel() == 0:
                return torch.zeros(us.shape, dtype=torch.int32, device=dev)
            from ..kernels.label_join import label_join
            return label_join(*base.gather_query_rows(us, vs))
        return self._join(base.ranks, base.svals, us, vs)

    def s_reach(self, us, vs, s: int) -> torch.Tensor:
        return self.mr(us, vs) >= s


class PaddedIndex(DeviceSnapshot):
    """Back-compat constructor: the padded device form built straight from
    an ``HLIndex``.  New code should use ``DeviceSnapshot.from_hlindex``
    (or ``engine.snapshot()`` through ``repro_torch.api``)."""

    def __init__(self, idx: HLIndex, *, device: DeviceLike = None):
        snap = DeviceSnapshot.from_hlindex(idx, "hl-index", device=device)
        super().__init__(ranks=snap.ranks, svals=snap.svals,
                         lengths=snap.lengths, backend="hl-index")


def batched_mr(ranks: torch.Tensor, svals: torch.Tensor,
               us: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """MR(u, v) for a batch of query pairs.

    For each label (e, s_u) of u, locate e in v's sorted rank list via
    searchsorted; a hit contributes min(s_u, s_v).  Padding (INT32_MAX)
    never matches a real rank.  Equivalent to Algorithm 5's merge-join —
    the data-parallel formulation trades the O(L) sequential scan for
    O(L log L) independent work.  ``us`` / ``vs`` are int64 index tensors
    on the tensors' device; the answer is [Q] int32.
    """
    return searchsorted_join(*_gather_rows(ranks, svals, us, vs))


def searchsorted_join(ru: torch.Tensor, su: torch.Tensor,
                      rv: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """The join of ``batched_mr`` on rows already gathered: the same
    function of the same [Q, L] operands as ``label_join``, in stock
    tensor ops (``searchsorted``, ``gather``, ``where``, ``amax``)."""
    if ru.numel() == 0:       # Q == 0 or L == 0: amax has nothing to reduce
        return torch.zeros((ru.shape[0],), dtype=su.dtype, device=su.device)
    pos = torch.searchsorted(rv, ru)                  # [Q, L] int64, left
    pos = pos.clamp_(max=rv.shape[1] - 1)
    hit = torch.gather(rv, 1, pos) == ru              # [Q, L]
    sv_at = torch.gather(sv, 1, pos)
    cand = torch.where(hit, torch.minimum(su, sv_at), 0)
    return cand.amax(dim=1)
