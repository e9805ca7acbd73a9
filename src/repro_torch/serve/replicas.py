"""Read-replica snapshot serving: ``ReplicaGroup``.

One writer, N readers — the serving regime reachability indexes live in:
queries vastly outnumber updates, so query capacity scales by holding
several device-resident copies of one snapshot and spreading batches
across them, while updates stay serialized on the single writer engine.

``ReplicaGroup`` is a ``ReachabilityService`` whose resident-snapshot slot
is replaced by a set of version-keyed replicas:

* **Separate copies** — on one device a replica is its own clone of the
  snapshot's ``ranks`` / ``svals`` / ``lengths``, made when it is first
  landed: never an alias of the engine's snapshot or of another replica.
  Only these private clones are ever written in place, so a snapshot the
  engine (or any caller) still holds never changes under it.
* **Single writer** — ``update()`` applies edits on the one underlying
  engine (the group owns it; nothing else should call
  ``engine.snapshot()`` behind its back, or the dirty-row delta
  degrades to a full re-land — the identity guard in ``snapshot_delta``
  makes that safe, just slower).
* **Dirty-row fan-out** — at the next micro-batch after an update, the
  group captures ``engine.snapshot_delta(basis)`` *once* and writes only
  those rows of the engine's fresh snapshot into every replica's clone
  (one ``index_copy_`` per tensor and replica): N replicas cost N row
  scatters of the touched rows, not N full copies.  A full re-land
  happens at first landing, after a whole-index rebuild (no delta), or
  when the update changed the tensors' shape (``n`` or ``lmax`` grew or
  shrank) — where the reference counts ``full_relands`` too.  A
  zero-row delta (version bump with no content change) re-keys the
  copies without touching the device.  All replicas therefore hold
  byte-identical label tensors at every version.
* **Round-robin serving** — each micro-batch is answered off the next
  replica in rotation (per-replica batch counters make the spread
  observable).  All replicas are brought current *between* batches,
  never mid-batch.

Snapshot-less backends (``mst-oracle``) cannot replicate — a replica *is*
a snapshot copy — so the group raises ``SnapshotUnsupported`` at
construction instead of silently degrading to single-copy serving.

Counterpart of ``repro/serve/replicas.py``: the same stats, counted at
the same points (``mesh_rows_patched`` counts the rows written into the
copies).  Copies spread over a device mesh (``mesh=``) are roadmap item
A10 and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.engine import SnapshotUnsupported
from ..core.query import DeviceSnapshot, KernelSnapshot
from .reach_service import ReachabilityService, ServiceConfig, _refuse_mesh

__all__ = ["Replica", "ReplicaGroup"]


@dataclasses.dataclass
class Replica:
    """One device-resident snapshot copy plus its serving counters."""

    index: int
    snap: Optional[DeviceSnapshot] = None    # this replica's own tensors
    kernel_view: Optional[KernelSnapshot] = None
    batches: int = 0                     # micro-batches served off this copy
    rows_patched: int = 0                # rows written via dirty-row fan-out
    full_relands: int = 0                # whole-label copies (incl. first)


def _land_copy(snap: DeviceSnapshot) -> DeviceSnapshot:
    """A private clone of ``snap``'s tensors on its device."""
    return dataclasses.replace(snap, ranks=snap.ranks.clone(),
                               svals=snap.svals.clone(),
                               lengths=snap.lengths.clone())


def _patch_copy(copy: DeviceSnapshot, fresh: DeviceSnapshot,
                rows: torch.Tensor) -> DeviceSnapshot:
    """Write rows ``rows`` of ``fresh`` into the private ``copy`` in place
    (same shapes) and re-key it to ``fresh``'s version."""
    for dst, src in ((copy.ranks, fresh.ranks), (copy.svals, fresh.svals),
                     (copy.lengths, fresh.lengths)):
        dst.index_copy_(0, rows, src.index_select(0, rows))
    return dataclasses.replace(copy, version=fresh.version,
                               backend=fresh.backend)


class ReplicaGroup(ReachabilityService):
    """A ``ReachabilityService`` serving off N read replicas of one
    snapshot (see module docstring).  Built by ``repro_torch.api.serve``
    when ``ServiceConfig(replicas=N)`` with N > 1, or directly:

        group = ReplicaGroup(engine, 4, start=False)
        group.submit_many(reqs); group.drain()
        group.update(inserts=[[1, 2, 3]])   # writer; dirty rows fan out
    """

    _replica_aware = True

    def __init__(self, engine, n_replicas: Optional[int] = None, *,
                 config: Optional[ServiceConfig] = None, mesh=None,
                 start: bool = True, **overrides):
        _refuse_mesh(mesh)
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
        super().__init__(engine, config=cfg, start=False, **overrides)
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
        rows = None
        for replica in self.replicas:
            patchable = (replica.snap is not None and dirty is not None
                         and tuple(replica.snap.ranks.shape)
                         == tuple(host.ranks.shape))
            if patchable and n_dirty == 0:
                # zero-row delta (e.g. an empty update batch): the copy
                # is already byte-identical — re-key it to the new
                # version without touching the device at all
                replica.snap = dataclasses.replace(replica.snap,
                                                   version=host.version)
            elif patchable:
                if rows is None:     # one host->device copy for all
                    rows = torch.as_tensor(np.asarray(dirty, np.int64),
                                           device=host.device)
                replica.snap = _patch_copy(replica.snap, host, rows)
                replica.rows_patched += n_dirty
                self._stats.mesh_rows_patched += n_dirty
            else:
                replica.snap = _land_copy(host)
                replica.full_relands += 1
            replica.kernel_view = None
        self._host_snap = host

    def replica_stats(self) -> List[Dict[str, int]]:
        """Per-replica serving counters (read under the dispatch lock)."""
        with self._dispatch_lock:
            return [{"replica": r.index, "batches": r.batches,
                     "rows_patched": r.rows_patched,
                     "full_relands": r.full_relands}
                    for r in self.replicas]
