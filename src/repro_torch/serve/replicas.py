"""Read-replica snapshot serving: ``ReplicaGroup``.

One writer, N readers — the serving regime reachability indexes live in:
queries vastly outnumber updates, so query capacity scales by holding
several device-resident copies of one snapshot and spreading batches
across them, while updates stay serialized on the single writer engine.

``ReplicaGroup`` is a ``ReachabilityService`` whose resident-snapshot slot
is replaced by a set of version-keyed, mesh-resident replicas:

* **Separate copies** — a replica is its own copy of the snapshot's
  ``ranks`` / ``svals`` / ``lengths`` landed on the group's mesh
  (``DeviceSnapshot.to_mesh``, which always writes new tensors): never an
  alias of the engine's snapshot or of another replica.  Only these
  private copies are ever written in place (``to_mesh(base=...,
  donate_base=True)``), so a snapshot the engine (or any caller) still
  holds never changes under it.
* **Single writer** — ``update()`` applies edits on the one underlying
  engine (the group owns it; nothing else should call
  ``engine.snapshot()`` behind its back, or the dirty-row delta
  degrades to a full re-land — the identity guard in ``snapshot_delta``
  makes that safe, just slower).
* **Dirty-row fan-out** — at the next micro-batch after an update, the
  group captures ``engine.snapshot_delta(basis)`` *once* and re-lands
  only those rows into every replica through the ``to_mesh(base=,
  dirty_rows=, donate_base=True)`` contract: N replicas cost N row
  scatters of the touched rows, not N full copies.  A full re-land
  happens at first landing, after a whole-index rebuild (no delta), or
  when the update changed the padded geometry (``n`` or ``lmax`` grew
  or shrank).  A zero-row delta (version bump with no content change)
  re-keys the copies without touching the device.  All replicas
  therefore hold byte-identical label tensors at every version.
* **Round-robin serving** — each micro-batch is answered off the next
  replica in rotation (per-replica batch counters make the spread
  observable).  All replicas are brought current *between* batches,
  never mid-batch.

Snapshot-less backends (``mst-oracle``) cannot replicate — a replica *is*
a snapshot copy — so the group raises ``SnapshotUnsupported`` at
construction instead of silently degrading to single-copy serving.

The group's mesh defaults to ``default_line_graph_mesh`` on the
engine's device (1 x 1 on one card), as the reference's does, and to
the engine's ``rank_mesh`` over an engine built on ranks (the
reference's default spans all its devices).

On a ``ProcessMesh`` the group is a service on ranks (rank 0 leads, the
others ``follow()``; ``reach_service``'s module docstring): each replica
is this rank's private block of the copy (``to_mesh(pm, base=,
dirty_rows=, donate_base=True)``; a snapshot that is already a block of
the mesh is copied block by block), the delta is captured once per
event on every rank, and the rotation moves in step on every rank, since
every rank sees the same events: ``replica_stats()`` is equal on every
rank.

Counterpart of ``repro/serve/replicas.py``: the same stats, counted at
the same points.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.engine import SnapshotUnsupported
from ..core.mesh import default_line_graph_mesh
from ..core.query import DeviceSnapshot, KernelSnapshot
from .reach_service import ReachabilityService, ServiceConfig, rank_mesh_of

__all__ = ["Replica", "ReplicaGroup"]


@dataclasses.dataclass
class Replica:
    """One device-resident snapshot copy plus its serving counters."""

    index: int
    snap: Optional[DeviceSnapshot] = None    # this replica's own tensors
    kernel_view: Optional[KernelSnapshot] = None
    batches: int = 0                     # micro-batches served off this copy
    rows_patched: int = 0                # rows re-landed via dirty-row fan-out
    full_relands: int = 0                # whole-label landings (incl. first)


class ReplicaGroup(ReachabilityService):
    """A ``ReachabilityService`` serving off N read replicas of one
    snapshot (see module docstring).  Built by ``repro_torch.api.serve``
    when ``ServiceConfig(replicas=N)`` with N > 1, or directly:

        group = ReplicaGroup(engine, 4, mesh=mesh, start=False)
        group.submit_many(reqs); group.drain()
        group.update(inserts=[[1, 2, 3]])   # writer; dirty rows fan out
    """

    _replica_aware = True

    def __init__(self, engine, n_replicas: Optional[int] = None, *,
                 config: Optional[ServiceConfig] = None, mesh=None,
                 start: bool = True, **overrides):
        cfg = config if config is not None else ServiceConfig()
        if n_replicas is not None:
            cfg = dataclasses.replace(cfg, replicas=int(n_replicas))
        try:
            engine.snapshot()
        except SnapshotUnsupported as exc:
            raise SnapshotUnsupported(
                f"replica serving holds device-resident snapshot copies, "
                f"which backend {getattr(engine, 'name', '?')!r} cannot "
                f"derive ({exc}); serve it through a plain "
                f"ReachabilityService instead") from None
        if mesh is None:
            # replicas are device-resident copies even when the caller
            # didn't think about placement; on ranks, blocks of the
            # engine's mesh
            mesh = rank_mesh_of(engine, None) or default_line_graph_mesh(
                device=getattr(engine, "device", None))
        super().__init__(engine, config=cfg, mesh=mesh, start=False,
                         **overrides)
        self.replicas: List[Replica] = [Replica(i)
                                        for i in range(cfg.replicas)]
        self._rr = 0                 # next replica in rotation
        if start:
            self.start()

    # -- replica snapshot lifecycle ----------------------------------------

    def _refresh_snapshot(self):
        """Bring every replica to the engine's version (dirty-row
        fan-out), then hand the next replica in rotation to the batch.
        Runs under ``_dispatch_lock`` like the base method."""
        eng = self.engine
        if self._host_snap is None or self._host_snap.version != eng.version:
            self._sync_replicas()
        replica = self.replicas[self._rr]
        self._rr = (self._rr + 1) % len(self.replicas)
        replica.batches += 1
        if not self.use_kernels:
            return replica.snap
        kv = replica.kernel_view
        if kv is None or kv.base is not replica.snap:
            kv = KernelSnapshot(replica.snap)
            replica.kernel_view = kv
        return kv

    def _sync_replicas(self) -> None:
        eng = self.engine
        # captured ONCE; the same delta then lands on every replica —
        # this is the point of the snapshot_delta hook
        host, dirty = eng.snapshot_delta(self._host_snap)
        if host is self._host_snap and all(r.snap is not None
                                           for r in self.replicas):
            return
        self._snapshot_ok = True
        self._stats.snapshot_refreshes += 1
        self._stats.rows_rederived += int(eng.last_snapshot_refresh_rows)
        self._stats.rows_full += int(eng.h.n)
        n_dirty = 0 if dirty is None else int(np.asarray(dirty).size)
        for replica in self.replicas:
            if (replica.snap is not None and dirty is not None
                    and n_dirty == 0
                    and tuple(replica.snap.ranks.shape)
                    == tuple(host.ranks.shape)):
                # zero-row delta (e.g. an empty update batch): the copy
                # is already byte-identical — re-key it to the new
                # version without touching the device at all
                replica.snap = dataclasses.replace(replica.snap,
                                                   version=host.version)
                replica.kernel_view = None
                continue
            base = replica.snap if (replica.snap is not None
                                    and dirty is not None) else None
            snap = host.to_mesh(self.mesh, self.axes, base=base,
                                dirty_rows=dirty if base is not None
                                else None, donate_base=True)
            if base is not None and snap.ranks.shape == base.ranks.shape:
                replica.rows_patched += n_dirty
                self._stats.mesh_rows_patched += n_dirty
            else:
                replica.full_relands += 1
            replica.snap = snap
            replica.kernel_view = None
        self._host_snap = host

    def replica_stats(self) -> List[Dict[str, int]]:
        """Per-replica serving counters (read under the dispatch lock)."""
        with self._dispatch_lock:
            return [{"replica": r.index, "batches": r.batches,
                     "rows_patched": r.rows_patched,
                     "full_relands": r.full_relands}
                    for r in self.replicas]
