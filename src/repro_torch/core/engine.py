"""Unified reachability engine API: one query surface, pluggable backends.

The paper's two query problems — ``MR(u, v)`` (Problem 2, Algorithm 5) and
``u ~s~> v`` (Problem 1) — are answered behind one protocol:

    engine = build(h, backend="hl-index")     # or "auto"
    engine.mr(u, v)                           # scalar MR
    engine.s_reach(u, v, s)                   # scalar s-reachability
    engine.mr_batch(us, vs)                   # [Q] MR, vectorized
    engine.s_reach_batch(us, vs, s)           # [Q] bool
    engine.snapshot()                         # device-resident padded form
    engine.mr_witness(u, v)                   # workload ops, gated per
    engine.top_s(u, k)                        #   backend (and s_reach_k,
    engine.mr_set(U, V)                       #   mr_from_set, s_distance)

Backends register themselves under a string key (``register_backend``);
``build(h, backend="auto")`` consults a planner that picks a backend from
the graph size, the label mass, the expected query batch shape, and —
when a ``mesh`` is passed — the device topology.

``DeviceSnapshot`` generalizes ``HLIndex.as_padded``: any backend that can
express its structure as per-vertex sorted (hub, s) label rows exports the
same padded tensors, and every snapshot is served by the same batched join
(``batched_mr``, or the ``label_join`` CUDA kernel with ``use_kernels``).
Backends with no label form (the MST forest) raise ``SnapshotUnsupported``
— their batch paths run through their own engines.

Counterpart of ``repro/core/engine.py``, same names in the same order.
What this module holds today: the protocol, the shared base, the
registry, the planner, ``build``, and every backend of the reference: ``hl-index`` and ``hl-index-basic``; the index-free
``online`` (Algorithm 1 on the host) and ``frontier`` (sparse line-graph
sweeps on the device), which ``auto`` picks for graphs past the label
budget; the static baselines ``ete`` (its snapshot joined like the
HL-index's) and ``threshold``; ``mst-oracle``; and ``closure`` (the dense
(max, min) closure ``W*``, formed on the device by the ``overlap`` and
``maxmin_matmul`` / ``threshold_step`` kernels).  ``update()`` works on
every backend that declares it (``hl-index`` / ``hl-index-basic``:
scoped maintenance through ``core/maintenance.py``; ``online`` /
``frontier``: the neighbor cache or line graph patched on the 1-hop
touched set; ``closure``: a whole rebuild on the device), and ``ete``,
``threshold`` and ``mst-oracle`` raise ``UpdateUnsupported`` as in the
reference.  The workload ops (witness / s_reach_k / mr_set / top_s /
s_distance; ``repro_torch/workloads``) are served per backend as the
reference's ``workload_capability`` says: ``mr_set`` / ``mr_from_set`` /
``top_s`` are one ``mr_batch`` each (the ``label_join_gather`` kernel
with ``use_kernels``), ``frontier``'s bounded ``s_reach_k`` one sweep on
the device, and witness, the gated ``s_reach_k`` and ``s_distance`` host
BFS.  ``build(restore=...)`` restores an engine persisted by
``repro_torch.store`` (or by the reference's ``repro.store``: the file
format is shared), and ``construction="sharded"`` builds the HL-index by
line-graph component shards, optionally in a fork pool
(``hlindex.build_sharded``).  ``sharded`` (``core/distributed.py``, made
importable here as in the reference) is the mesh backend: W* partitioned
over a logical block grid (``core/mesh.py``) and closed by float32
``maxmin_matmul`` block contractions, or HL-index labels built by
``build_sharded`` over that grid, served off a snapshot landed on the
mesh.  A ``mesh`` passed to ``build`` reaches the planner and the
mesh-aware backends (``sharded``, and the HL-index backends, which
shard their construction over it).

Device rule: ``build`` and the device-landing backends take
``device=None``, which means ``"cuda"`` and raises on a host without a CUDA
device; pass ``device="cpu"`` to run on the host.  With a ``mesh`` and no
``device``, the mesh's device is taken.  ``mr_batch`` takes host
ids and returns host answers: one host->device copy of the id pairs, one
device->host copy of the ``[Q]`` answers, and no other synchronisation.
"""
from __future__ import annotations

import functools
import operator
import os
import time
from typing import (Callable, Dict, FrozenSet, List, Optional, Protocol,
                    Tuple, runtime_checkable)

import numpy as np
import torch

from ..device import DeviceLike, host_to_device, resolve_device
from .hypergraph import Hypergraph, apply_edge_edits
from .mesh import LogicalMesh, ProcessMesh
from .hlindex import (CONSTRUCTION_MODES, HLIndex, build_basic, build_fast,
                      build_sharded, pad_label_rows)
from .maintenance import apply_updates, normalize_update_batch
from .minimal import minimize
from .query import DeviceSnapshot, KernelSnapshot, mr_query, s_reach_query
from .baselines import (ETEIndex, MSTOracle, ThresholdComponentIndex,
                        build_ete)
from .frontier import (SparseLineGraph, frontier_batched_mr,
                       frontier_batched_s_reach)
from .online import NeighborCache, mr_online
from .semiring import (CLOSURE_METHODS, close_line_graph, device_line_graph,
                       vertex_mr_from_edge_mr)

__all__ = [
    "ReachabilityEngine", "DeviceSnapshot", "KernelSnapshot",
    "SnapshotUnsupported",
    "UpdateUnsupported", "WorkloadUnsupported",
    "WORKLOAD_OPS", "register_backend", "available_backends",
    "update_capabilities", "workload_capabilities",
    "plan_backend", "build", "validate_batch",
    "HLIndexEngine", "HLIndexBasicEngine", "OnlineEngine", "FrontierEngine",
    "ETEEngine", "ThresholdEngine", "MSTOracleEngine", "ClosureEngine",
    "SINGLE_DEVICE_CLOSURE_BUDGET", "CONSTRUCTION_MODES",
]


def validate_batch(us, vs, n: int):
    """Shared input validation for every backend's ``mr_batch`` /
    ``s_reach_batch``: ``us`` / ``vs`` must be equal-length 1-D integer
    sequences of in-range vertex ids.  Returns them as int64 numpy
    arrays, so every entry point raises the same clear error on
    malformed input.
    """
    us = np.asarray(us)
    vs = np.asarray(vs)
    if us.ndim != 1 or vs.ndim != 1:
        raise ValueError(
            f"query batch must be 1-D sequences of vertex ids; got shapes "
            f"us{us.shape} vs{vs.shape}")
    if us.shape[0] != vs.shape[0]:
        raise ValueError(
            f"query batch length mismatch: len(us)={us.shape[0]} != "
            f"len(vs)={vs.shape[0]}")
    for name, a in (("us", us), ("vs", vs)):
        if a.size and not np.issubdtype(a.dtype, np.integer):
            raise ValueError(
                f"query batch {name} must have an integer dtype; got "
                f"{a.dtype}")
    us = us.astype(np.int64)
    vs = vs.astype(np.int64)
    for name, a in (("us", us), ("vs", vs)):
        if a.size and (int(a.min()) < 0 or int(a.max()) >= n):
            bad = int(a.min()) if int(a.min()) < 0 else int(a.max())
            raise IndexError(
                f"query batch {name} contains vertex id {bad}, out of "
                f"range [0, {n})")
    return us, vs

# Per-device byte budget for the dense closure working set (operand plus
# the two gathered panels, f32).  When a multi-device mesh is passed and
# 12·m² exceeds this, the auto planner routes to the "sharded" backend.
SINGLE_DEVICE_CLOSURE_BUDGET = 256 * 2**20

class SnapshotUnsupported(NotImplementedError):
    """Raised by backends whose structure has no padded label form."""


class UpdateUnsupported(NotImplementedError):
    """Raised by backends whose structure cannot absorb hyperedge
    updates (``update_capability == "unsupported"``) — rebuild the
    engine via ``build`` instead."""


class WorkloadUnsupported(NotImplementedError):
    """Raised by backends that do not serve a workload op (witness /
    s_reach_k / mr_set / top_s / s_distance) — see
    ``workload_capabilities()``."""


# canonical workload-op order (the reference's tuple)
WORKLOAD_OPS: Tuple[str, ...] = ("witness", "s_reach_k", "mr_set",
                                 "top_s", "s_distance")

# capability rule (per backend below): the label-row reductions —
# witness (hub named by the label join), mr_set, top_s — need a
# snapshot-capable label/closure form; the traversal ops — s_reach_k,
# s_distance — need a graph the backend keeps live under updates.  The
# static Section IV/VII baselines (threshold, mst-oracle) serve the
# paper's two problems only.
_LABEL_OPS = frozenset({"witness", "mr_set", "top_s"})
_TRAVERSAL_OPS = frozenset({"s_reach_k", "s_distance"})


# ---------------------------------------------------------------------------
# Protocol + shared scaffolding
# ---------------------------------------------------------------------------

@runtime_checkable
class ReachabilityEngine(Protocol):
    """The one query surface every backend serves.

    Semantics (fixed across backends, cross-validated against the
    ``mst-oracle`` reference in tests):

    * ``mr(u, v)`` — Problem 2: the largest ``s`` such that an s-walk
      joins vertices ``u`` and ``v``.  0 means unreachable at every
      ``s >= 1``; for ``u == v`` it is the max incident hyperedge size
      (a vertex trivially reaches itself through any incident edge).
      Vertices with no incident hyperedge answer 0 everywhere.
    * ``s_reach(u, v, s)`` — Problem 1: is there an s-walk joining
      ``u`` and ``v``?  Always equals ``mr(u, v) >= s``.
    * ``mr_batch(us, vs) -> int array [Q]`` / ``s_reach_batch(us, vs, s)
      -> bool array [Q]`` — vectorized forms; ``us``/``vs`` are equal
      length sequences of vertex ids, answers are numpy arrays.
    * ``snapshot() -> DeviceSnapshot`` — the padded device-resident label
      form (see ``repro_torch.core.query``), or raises
      ``SnapshotUnsupported`` for structures with no label form.
    * ``update(inserts, deletes)`` — mutate the engine in place so it
      serves the edited hypergraph, or raise ``UpdateUnsupported``.
      ``update_capability`` ∈ {"scoped", "incremental", "rebuild",
      "unsupported"} declares how; ``version`` counts successful updates
      so snapshot staleness is detectable.
    * the workload ops ``mr_witness``, ``s_reach_k``, ``mr_set``,
      ``mr_from_set``, ``top_s``, ``s_distance`` — gated by
      ``workload_capability``; anything outside it raises
      ``WorkloadUnsupported``.
    """

    name: str
    update_capability: str
    workload_capability: FrozenSet[str]

    def mr(self, u: int, v: int) -> int: ...
    def s_reach(self, u: int, v: int, s: int) -> bool: ...
    def mr_batch(self, us, vs) -> np.ndarray: ...
    def s_reach_batch(self, us, vs, s: int) -> np.ndarray: ...
    def snapshot(self) -> DeviceSnapshot: ...
    def update(self, inserts=(), deletes=()) -> None: ...
    def mr_witness(self, u: int, v: int): ...
    def s_reach_k(self, u: int, v: int, s: int, k: int) -> bool: ...
    def mr_set(self, us, vs) -> int: ...
    def mr_from_set(self, us, targets) -> np.ndarray: ...
    def top_s(self, u: int, k: int) -> Tuple[np.ndarray, np.ndarray]: ...
    def s_distance(self, u: int, v: int, s: int) -> int: ...


def _agreed_edits(mesh: ProcessMesh, inserts, deletes):
    """``(inserts, deletes)`` read into lists, once every rank of ``mesh``
    is seen to have passed the same ones (one ragged all-gather of a
    digest); raises ``ValueError`` on every rank otherwise.  A batch that
    cannot be read still joins the check (as a digest of its error), so a
    rank never leaves the others waiting, and raises after it."""
    from .collectives import same_on_every_rank

    def atom(x):
        try:
            return int(operator.index(x))
        except TypeError:
            return repr(x)
    error = None
    try:
        inserts = [list(e) for e in inserts]
        deletes = list(deletes)
        key = repr(([[atom(x) for x in e] for e in inserts],
                    [atom(x) for x in deletes]))
    except Exception as exc:          # re-raised below, after the check
        error, key = exc, f"unreadable: {type(exc).__name__}"
    if not same_on_every_rank(mesh, key.encode()):
        raise ValueError("update on ranks: the ranks passed different "
                         "edits; no rank's state changed")
    if error is not None:
        raise error
    return inserts, deletes


class _EngineBase:
    """Default implementations: scalar fallbacks and mr-derived s-reach.

    Backends override whichever paths their structure accelerates; the
    semantics (``s_reach(u, v, s) == (mr(u, v) >= s)``) are fixed here so
    every backend answers identically.
    """

    name = "base"
    update_capability = "unsupported"
    # which workload ops this backend serves; empty = the paper's two
    # problems only
    workload_capability: FrozenSet[str] = frozenset()
    # index lookups cheap enough that s_reach_k pre-gates the bounded
    # BFS on an unbounded reachability answer (label join / closure
    # row); False where s_reach is itself a traversal
    _gate_hop_bounded = False
    # the ProcessMesh an engine was built on (every rank holds one such
    # engine and calls it with the same arguments); None elsewhere
    rank_mesh: Optional[ProcessMesh] = None

    def __init__(self, h: Hypergraph):
        self.h = h
        self.version = 0
        # label rows changed since the cached snapshot was derived:
        # empty = snapshot current / patchable as-is, None = all rows
        # (unknown or whole-structure rebuild)
        self._dirty_rows: Optional[np.ndarray] = np.empty(0, np.int64)
        self.last_snapshot_refresh_rows = 0
        # write-ahead sink: None = updates are not journaled
        self._wal = None
        # kernel-path batch queries (CUDA label join); flipped by the
        # snapshot-serving backends' ``build(use_kernels=True)``
        self.use_kernels = False
        self._kernel_view: Optional[KernelSnapshot] = None
        # per-(s, extra_landmarks) DistanceOracle cache; invalidated on
        # every graph change (_graph_changed)
        self._distance_oracles: Dict[Tuple[int, int], "DistanceOracle"] = {}

    @classmethod
    def build(cls, h: Hypergraph, **opts) -> "ReachabilityEngine":
        raise NotImplementedError

    def mr(self, u: int, v: int) -> int:
        raise NotImplementedError

    def _check_vertex_ids(self, *ids) -> None:
        """Scalar-path counterpart of ``validate_batch``: backends whose
        ``mr`` / ``s_reach`` index host structures directly call this
        first, so an out-of-range id raises the same ``IndexError`` as
        the batch paths instead of a Python negative index silently
        answering from the wrong row."""
        for x in ids:
            if not 0 <= int(x) < self.h.n:
                raise IndexError(
                    f"vertex id {int(x)} out of range [0, {self.h.n})")

    def update(self, inserts=(), deletes=()) -> None:
        """Template method every backend shares: gate on capability,
        validate + canonicalize the batch, journal it (when a write-ahead
        sink is attached — *before* the in-memory structure changes),
        then hand the canonical batch to the backend's ``_apply_update``.
        A batch that would be rejected is never journaled.

        On an engine built on ranks (``rank_mesh``, a ``ProcessMesh``)
        every rank calls ``update`` with the same edits.  Before anything
        changes, one ragged all-gather of a digest of the edits as passed
        checks that they agree; if any rank's differ, every rank raises
        ``ValueError`` and no rank's state changes.  With a sink attached
        on every rank (``attach_wal``), each rank appends through its own
        sink, then one status word crosses: if any rank's append failed,
        every rank raises before any state changes."""
        if self.update_capability == "unsupported":
            raise UpdateUnsupported(
                f"backend {self.name!r} does not maintain its structure "
                f"under hyperedge updates; build a fresh engine instead")
        if self.rank_mesh is not None:
            inserts, deletes = _agreed_edits(self.rank_mesh, inserts,
                                             deletes)
        ins, dels = normalize_update_batch(self.h, inserts, deletes)
        wal = self._wal
        if wal is not None and self.rank_mesh is None:
            wal.append(self.version + 1, ins, dels)
        elif wal is not None:
            from .collectives import agree_or_raise
            error = None
            try:
                wal.append(self.version + 1, ins, dels)
            except Exception as exc:        # every rank raises below
                error = exc
            agree_or_raise(self.rank_mesh, "journal append", error)
        self._apply_update(ins, dels)
        if wal is not None:
            wal.committed(self)

    def _apply_update(self, inserts, deletes) -> None:
        """Backend hook behind ``update``: mutate the structure in place
        for an already-validated, canonical batch and call
        ``_graph_changed``.  Only backends whose ``update_capability``
        is not ``"unsupported"`` are ever called here."""
        raise UpdateUnsupported(
            f"backend {self.name!r} declares update_capability="
            f"{self.update_capability!r} but implements no _apply_update")

    def attach_wal(self, sink) -> None:
        """Journal every subsequent ``update`` through ``sink`` — any
        object with ``append(version, inserts, deletes)`` (called before
        the apply) and ``committed(engine)`` (called after).  On an
        engine on ranks every rank attaches its own sink (an
        ``IndexStore`` writes from rank 0 alone) and ``update`` settles
        the appends' status across the ranks."""
        self._wal = sink

    def on_ranks(self, mesh: ProcessMesh) -> None:
        """Make this engine, of which every rank of ``mesh`` holds an
        equal copy, an engine on ranks for good: from here on every rank
        calls ``update`` with the same edits (which then agree across
        the ranks), and a store writes its files from global rank 0
        alone.  A service given ``mesh=`` does this to an engine not
        built on ranks; it stays so after the service closes.  An engine
        already on ``mesh`` is left as it is, one on another mesh
        refused."""
        if not isinstance(mesh, ProcessMesh):
            raise TypeError(f"on_ranks takes a ProcessMesh, got "
                            f"{type(mesh).__name__}")
        if self.rank_mesh is not None and self.rank_mesh != mesh:
            raise ValueError(f"the engine is on {self.rank_mesh}, not on "
                             f"{mesh}")
        self.rank_mesh = mesh

    def detach_wal(self):
        """Stop journaling; returns the detached sink."""
        sink, self._wal = self._wal, None
        return sink

    def _graph_changed(self, new_h: Hypergraph, dirty_rows=None) -> None:
        """Install the edited graph and bump ``version``.  ``dirty_rows``
        names the label rows the update changed (accumulated across
        updates): the cached snapshot becomes stale but is *kept* as the
        patch basis for the next ``snapshot()``.  ``None`` means all
        rows — the next derivation is full anyway, so the stale snapshot
        is dropped immediately rather than held through the rebuild."""
        self.h = new_h
        self.version += 1
        self._distance_oracles.clear()   # landmark BFS trees are per-graph
        if dirty_rows is None:
            self._dirty_rows = None
            if getattr(self, "_snap", None) is not None:
                self._snap = None
        elif self._dirty_rows is not None:
            self._dirty_rows = np.union1d(
                self._dirty_rows, np.asarray(dirty_rows, np.int64))

    def dirty_rows(self) -> Optional[np.ndarray]:
        """Vertex rows whose padded label content may differ between the
        cached (stale) snapshot — ``snapshot_cache()`` — and the one the
        next ``snapshot()`` call returns; ``None`` = all rows / unknown.
        Resets to empty once ``snapshot()`` re-derives.  The delta is
        only meaningful relative to ``snapshot_cache()``, so consumers
        holding an older copy must check identity against it first."""
        return self._dirty_rows

    def snapshot_cache(self) -> Optional[DeviceSnapshot]:
        """The currently cached snapshot object (possibly stale), or
        ``None``.  ``dirty_rows()`` is the row delta between exactly
        this object and the next ``snapshot()`` result."""
        return getattr(self, "_snap", None)

    def _snapshot_current(self) -> bool:
        snap = getattr(self, "_snap", None)
        return snap is not None and snap.version == self.version

    def snapshot_delta(self, basis: Optional[DeviceSnapshot] = None,
                       ) -> Tuple[DeviceSnapshot, Optional[np.ndarray]]:
        """The snapshot fan-out hook: one call returning ``(fresh
        snapshot, dirty-row delta relative to basis)`` — what a consumer
        holding device-resident copies landed from ``basis`` needs to
        bring *all* of them current with row-wise patches instead of
        full re-lands.

        ``basis`` is the snapshot the caller's copies derive from.
        The delta is ``None`` (re-land in full) when it is unknowable:
        no basis, the basis is not the engine's cached snapshot object
        (another consumer re-derived in between, resetting the delta),
        or the update was a whole-structure rebuild.  The dirty set must
        be captured *before* ``snapshot()`` re-derives and resets it,
        which is exactly the ordering this method encapsulates.  Raises
        ``SnapshotUnsupported`` for backends with no snapshot form."""
        dirty = (self.dirty_rows()
                 if basis is not None and self.snapshot_cache() is basis
                 else None)
        snap = self.snapshot()
        if snap is basis:
            dirty = np.empty(0, np.int64)      # already current: patch nothing
        return snap, dirty

    def _query_snapshot(self):
        """The snapshot view batch queries run through: the plain
        ``DeviceSnapshot`` (tensor-op ``batched_mr``), or — with
        ``use_kernels`` — a cached ``KernelSnapshot`` wrapper that
        answers through the CUDA label-join kernel.  The wrapper is
        rebuilt whenever ``snapshot()`` hands back a different object
        (update / patch / re-derivation), so it can never serve stale
        label rows."""
        snap = self.snapshot()
        if not self.use_kernels:
            return snap
        kv = self._kernel_view
        if kv is None or kv.base is not snap:
            kv = KernelSnapshot(snap)
            self._kernel_view = kv
        return kv

    def _device_pairs(self, us, vs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Validated id pairs on the engine's ``device``, int64, moved in
        one host->device copy (snapshot-serving backends)."""
        us, vs = validate_batch(us, vs, self.h.n)
        pairs = torch.from_numpy(np.stack([us, vs])).to(self.device)
        return pairs[0], pairs[1]

    def s_reach(self, u: int, v: int, s: int) -> bool:
        return self.mr(u, v) >= s

    def mr_batch(self, us, vs) -> np.ndarray:
        us, vs = validate_batch(us, vs, self.h.n)
        return np.array([self.mr(int(u), int(v)) for u, v in zip(us, vs)],
                        np.int64)

    def s_reach_batch(self, us, vs, s: int) -> np.ndarray:
        return self.mr_batch(us, vs) >= s

    def snapshot(self) -> DeviceSnapshot:
        raise SnapshotUnsupported(
            f"backend {self.name!r} has no padded device form; query it "
            f"through mr_batch / s_reach_batch instead")

    # -- workload ops (repro_torch/workloads/) -----------------------------

    def _require_workload(self, op: str) -> None:
        if op not in self.workload_capability:
            raise WorkloadUnsupported(
                f"backend {self.name!r} does not serve workload op "
                f"{op!r}; see workload_capabilities()")

    def _witness_hub(self, u: int, v: int, k: int) -> Optional[int]:
        """The hyperedge the label join met at, when the backend's
        structure names one (HL-index labels); None lets the extractor
        meet wherever the frontiers touch (closure backends, where
        every hyperedge is a hub)."""
        return None

    def mr_witness(self, u: int, v: int) -> "Witness":
        """MR(u, v) plus the hyperedge walk achieving it (hub-anchored
        meet-in-the-middle reconstruction; ``verify_witness`` checks
        the result from the hypergraph alone)."""
        self._require_workload("witness")
        from ..workloads.base import Witness
        from ..workloads.witness import extract_witness
        self._check_vertex_ids(u, v)
        u, v = int(u), int(v)
        k = int(self.mr(u, v))
        walk = (extract_witness(self.h, u, v, k,
                                hub=self._witness_hub(u, v, k))
                if k > 0 else ())
        return Witness(u=u, v=v, s=k, walk=tuple(int(e) for e in walk))

    def s_reach_k(self, u: int, v: int, s: int, k: int) -> bool:
        """Hop-bounded s-reach: an s-walk of at most ``k`` hyperedges.
        Index-backed engines pre-gate the bounded search: unbounded
        unreachable rejects immediately, and ``k >= m`` accepts
        immediately (shortest s-walks never repeat a hyperedge)."""
        self._require_workload("s_reach_k")
        self._check_vertex_ids(u, v)
        u, v, s, k = int(u), int(v), int(s), int(k)
        if s < 1:
            raise ValueError(f"s-reachability needs s >= 1; got {s}")
        if k < 1:
            raise ValueError(f"hop bound needs k >= 1; got {k}")
        if self._gate_hop_bounded:
            if not self.s_reach(u, v, s):
                return False             # early-reject: no walk at all
            if k >= self.h.m:
                return True              # early-accept: m edges suffice
        return self._bounded_s_reach(u, v, s, k)

    def _bounded_s_reach(self, u: int, v: int, s: int, k: int) -> bool:
        """Backend hook behind the gate: host bounded BFS by default;
        the frontier backend swaps in its sweep on the device."""
        from ..workloads.hop_bounded import hop_bounded_s_reach
        return bool(hop_bounded_s_reach(self.h, u, v, s, k))

    def mr_set(self, us, vs) -> int:
        """Set-to-set MR: ``max over U x V of MR(u, v)``, answered as
        one cross-product batch through ``mr_batch`` — the vectorized
        snapshot join, through the ``label_join_gather`` kernel with
        ``use_kernels``.  Both sets are held to ``[0, n)`` first, so an
        out-of-range id raises before anything is launched."""
        self._require_workload("mr_set")
        from ..workloads.setops import cross_pairs, normalize_vertex_set
        sources = normalize_vertex_set(us, self.h.n, "mr_set source set")
        targets = normalize_vertex_set(vs, self.h.n, "mr_set target set")
        qu, qv = cross_pairs(sources, targets)
        return int(np.asarray(self.mr_batch(qu, qv)).max())

    def mr_from_set(self, us, targets) -> np.ndarray:
        """Multi-source MR: per target, the best MR from any source
        (``targets`` keeps caller order and duplicates); int64."""
        self._require_workload("mr_set")
        from ..workloads.setops import cross_pairs, normalize_vertex_set
        sources = normalize_vertex_set(us, self.h.n, "mr_from_set sources")
        tgt, _ = validate_batch(targets, targets, self.h.n)
        qu, qv = cross_pairs(sources, tgt)
        flat = np.asarray(self.mr_batch(qu, qv), np.int64)
        return flat.reshape(len(sources), len(tgt)).max(axis=0)

    def top_s(self, u: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k strongest-s ranking: the (up to) k vertices with the
        largest MR(u, .), from one full label-row sweep (one ``mr_batch``
        of ``n`` pairs).  Returns int64 (vertices, mr values) ranked
        (MR desc, id asc); zeros and ``u`` itself never appear."""
        self._require_workload("top_s")
        from ..workloads.topk import select_top_s
        self._check_vertex_ids(u)
        if int(k) < 1:
            raise ValueError(f"top_s needs k >= 1; got {k}")
        n = self.h.n
        row = self.mr_batch(np.full(n, int(u), np.int64),
                            np.arange(n, dtype=np.int64))
        return select_top_s(np.asarray(row), int(u), int(k))

    def s_distance(self, u: int, v: int, s: int) -> int:
        """Certified upper bound on the s-distance in hyperedges
        (0 = provably no s-walk), served off the cached landmark
        oracle for this ``s``."""
        self._require_workload("s_distance")
        self._check_vertex_ids(u, v)
        return int(self.distance_oracle(int(s)).distance(int(u), int(v)))

    def distance_oracle(self, s: int, *, extra_landmarks: int = 4,
                        ) -> "DistanceOracle":
        """The per-``s`` landmark oracle (built on first use, cached
        until the graph changes)."""
        self._require_workload("s_distance")
        if int(s) < 1:
            raise ValueError(f"s-distance needs s >= 1; got {s}")
        key = (int(s), int(extra_landmarks))
        oracle = self._distance_oracles.get(key)
        if oracle is None:
            from ..workloads.oracle import DistanceOracle
            oracle = DistanceOracle(self.h, int(s),
                                    extra_landmarks=int(extra_landmarks))
            self._distance_oracles[key] = oracle
        return oracle

    def nbytes(self) -> Optional[int]:
        """Resident index size in bytes, if the backend tracks one."""
        return None


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable] = {}


def register_backend(name: str, builder: Optional[Callable] = None):
    """Register ``builder`` (a class with ``.build(h, **opts)``) under
    ``name``.  Usable as a decorator: ``@register_backend("hl-index")``."""
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    if builder is not None:
        return deco(builder)
    return deco


def available_backends() -> List[str]:
    """Sorted registry keys (excludes the virtual ``"auto"``)."""
    return sorted(_REGISTRY)


def update_capabilities() -> Dict[str, str]:
    """Registry key -> declared ``update(inserts, deletes)`` capability
    ("scoped" | "incremental" | "rebuild" | "unsupported")."""
    return {name: getattr(cls, "update_capability", "unsupported")
            for name, cls in sorted(_REGISTRY.items())}


def workload_capabilities() -> Dict[str, Dict[str, bool]]:
    """Registry key -> {workload op -> served?} in ``WORKLOAD_OPS``
    order: the reference's table."""
    caps: Dict[str, Dict[str, bool]] = {}
    for name, cls in sorted(_REGISTRY.items()):
        served = getattr(cls, "workload_capability", frozenset())
        caps[name] = {op: op in served for op in WORKLOAD_OPS}
    return caps


def plan_backend(h: Hypergraph, batch_hint: Optional[int] = None, *,
                 mesh=None, device_budget_bytes: Optional[int] = None) -> str:
    """Pick a backend from graph size, label mass, query batch shape, and
    (optionally) the device topology.

    The policy is the reference's, unchanged, so both packages name the
    same backend on the same inputs, and ``build`` builds every backend
    it names; ``sharded`` runs on a logical block grid on one device.

    Args:
      h: the hypergraph to serve.
      batch_hint: expected query batch size (None/0 = trickle queries).
      mesh: an optional mesh (a ``LogicalMesh``, or any object with
        ``devices.size`` and ``axis_names``).  A mesh with more than one
        block opts the workload into distribution: if the
        dense closure working set (~12·m² bytes: operand + two gathered
        f32 panels) exceeds ``device_budget_bytes``, the planner picks
        ``sharded``.  A unit mesh (1 device) never routes to ``sharded``.
      device_budget_bytes: per-device memory budget for the closure
        working set; defaults to ``SINGLE_DEVICE_CLOSURE_BUDGET``.

    Policy:
      * multi-device mesh + closure beyond one device -> ``sharded``;
      * tiny line graphs with real batches -> dense semiring ``closure``;
      * anything where HL-index construction is tractable -> ``hl-index``
        (the paper's answer: microsecond merge-joins, batch via
        snapshot).  On a multi-device mesh the tractability ceiling
        scales with the device count capped by the host's cores, as
        sharded construction divides the work;
      * huge graphs, batched workload -> ``frontier``;
      * huge graphs, trickle queries -> ``online``.
    """
    q = int(batch_hint) if batch_hint else 0
    if h.m == 0:
        return "hl-index"
    devices = int(mesh.devices.size) if mesh is not None else 1
    if devices > 1 and len(mesh.axis_names) >= 2:
        # sharded needs two mesh axes to 2-D block-shard over; a 1-D mesh
        # falls through to the single-device policy rather than routing
        # to a backend that cannot be built on it
        budget = (SINGLE_DEVICE_CLOSURE_BUDGET if device_budget_bytes is None
                  else int(device_budget_bytes))
        if 12 * h.m * h.m > budget:
            return "sharded"
    if h.m <= 256 and q >= 64:
        return "closure"
    # label mass proxy: construction walks ~nnz * avg-degree host work;
    # sharded construction divides it across workers, so the budget
    # scales with the parallelism actually deliverable — the mesh device
    # count capped by the host's cores
    parallel = min(devices, os.cpu_count() or 1) if devices > 1 else 1
    label_budget = 2e6 * max(parallel, 1)
    if h.nnz * max(float(h.vertex_degrees.mean()) if h.n else 0.0, 1.0) \
            <= label_budget:
        return "hl-index"
    if q >= 256:
        return "frontier"
    return "online"


def build(h: Optional[Hypergraph] = None, backend: str = "auto", *,
          restore=None, batch_hint: Optional[int] = None, mesh=None,
          device: DeviceLike = None, **opts) -> "ReachabilityEngine":
    """Build a reachability engine over ``h``.

    Args:
      h: the hypergraph to serve.
      backend: a registry key (see ``available_backends()``) or
        ``"auto"`` to let ``plan_backend`` choose.
      restore: path to a ``repro_torch.store`` artifact — an
        ``IndexStore`` directory (checkpoint + WAL replay + re-attach,
        the warm-restart path) or a single ``save_index`` file.  No
        construction runs: the index loads mmap-backed and only the
        journaled update suffix replays.  With ``restore`` a non-auto
        ``backend`` asserts what the persisted engine must be.
      batch_hint: expected query batch size, consumed by the planner.
      mesh: optional ``LogicalMesh`` (``core/mesh.py``), consulted by
        the planner (see ``plan_backend``) and forwarded to the
        ``sharded`` backend, which partitions its closure over it, and to
        the HL-index backends, where a multi-block mesh asks for sharded
        construction.  A restored ``sharded`` engine lands on it.  A
        ``ProcessMesh`` puts ``sharded`` (both regimes) and the HL-index
        backends' sharded construction on ranks (every rank calls
        ``build`` with the same ``h``), and ``restore`` onto one loads
        the engine on the ranks (``load_index(mesh=pm)``).
      device: where device-resident structures land.  ``None`` means the
        mesh's device when a mesh is given, else ``"cuda"``; on a host
        without a CUDA device that raises — pass ``device="cpu"`` (or a
        CPU mesh) to run on the host.
      **opts: backend-specific options, passed to the backend's
        ``build`` (e.g. ``minimize_labels=False`` or ``use_kernels=True``
        for "hl-index", ``device_budget_bytes`` for the planner) — or,
        with ``restore``, the ``restore_engine`` options (``verify``,
        ``checkpoint_every``, ``attach``).
    """
    if device is None and isinstance(mesh, (LogicalMesh, ProcessMesh)):
        device = mesh.device
    if restore is not None:
        if h is not None:
            raise ValueError(
                "build(restore=...) loads a persisted engine; passing a "
                "hypergraph too is ambiguous — use one or the other")
        from ..store import restore_engine
        return restore_engine(
            restore, mesh=mesh, device=device,
            expect_backend=None if backend == "auto" else backend, **opts)
    if h is None:
        raise ValueError("build() needs a hypergraph (or restore=<path>)")
    dev = resolve_device(device)
    budget = opts.pop("device_budget_bytes", None)
    if backend == "auto":
        backend = plan_backend(h, batch_hint, mesh=mesh,
                               device_budget_bytes=budget)
    try:
        cls = _REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; available: {available_backends()}"
        ) from None
    if mesh is not None and backend in _MESH_AWARE_BACKENDS:
        opts.setdefault("mesh", mesh)
    return cls.build(h, device=dev, **opts)


# Backends whose ``build`` consumes a mesh: "sharded" partitions its
# closure over it; the HL-index backends shard *construction* over it
# (neighbor overlaps on the mesh's device, per-block component shards).
_MESH_AWARE_BACKENDS = frozenset({"sharded", "hl-index", "hl-index-basic"})


# ---------------------------------------------------------------------------
# HL-index backends (the paper's structure)
# ---------------------------------------------------------------------------

def _resolve_construction(construction: str, mesh, workers,
                          num_shards) -> str:
    """The one auto-resolution rule both HL-index backends share:
    ``"auto"`` means sharded construction iff a multi-device mesh,
    ``workers``, or ``num_shards`` asks for it; anything else must be a
    ``CONSTRUCTION_MODES`` key."""
    if construction == "auto":
        return ("sharded"
                if (workers or num_shards
                    or (mesh is not None and int(mesh.devices.size) > 1))
                else "serial")
    if construction not in CONSTRUCTION_MODES:
        raise ValueError(
            f"unknown construction {construction!r}; available: "
            f"{sorted(CONSTRUCTION_MODES)}")
    return construction

@register_backend("hl-index")
class HLIndexEngine(_EngineBase):
    """Algorithm 3 (+ Algorithm 4 minimization) served by Algorithm 5
    merge-joins; batches run on the padded device snapshot.  Updates are
    component-scoped (``apply_updates``): only the affected line-graph
    components are rebuilt, and only their vertices' snapshot rows are
    re-derived."""

    name = "hl-index"
    update_capability = "scoped"
    workload_capability = _LABEL_OPS | _TRAVERSAL_OPS
    _gate_hop_bounded = True

    def __init__(self, h: Hypergraph, idx: HLIndex,
                 builder: Callable[[Hypergraph], HLIndex] = build_fast,
                 minimizer: Optional[Callable[[HLIndex], HLIndex]] = None,
                 *, device: DeviceLike = None):
        super().__init__(h)
        self.device = resolve_device(device)
        self.idx = idx
        self.construction = "serial"     # overwritten by ``build``
        self._builder = builder          # scoped-update (re)construction
        self._minimizer = minimizer      # applied to the sub-index too
        self._snap: Optional[DeviceSnapshot] = None

    @classmethod
    def build(cls, h: Hypergraph, *, minimize_labels: bool = True,
              index: Optional[HLIndex] = None,
              construction: str = "auto", mesh=None,
              workers: Optional[int] = None,
              num_shards: Optional[int] = None,
              use_kernels: bool = False,
              device: DeviceLike = None) -> "HLIndexEngine":
        """``index`` reuses a prebuilt (unminimized) HL-index instead of
        running construction again — e.g. to derive the minimized engine
        from an ablation engine's labels.

        ``construction`` picks the builder from ``CONSTRUCTION_MODES``:
        ``"serial"`` (Algorithm 3 on one host thread), ``"sharded"``
        (component-sharded construction, ``workers`` forked processes —
        byte-identical labels, see ``hlindex.build_sharded``), or
        ``"auto"`` (sharded iff a multi-device ``mesh``, ``workers``, or
        ``num_shards`` asks for it).  Scoped updates keep using the same
        construction mode on the affected component(s).  ``mesh``
        additionally routes the neighbor-overlap precompute onto the
        mesh's device when ``auto_device_overlaps`` says so, and sets
        the default workers and shards from its block count.

        ``use_kernels`` answers batch queries through the hand-written
        ``label_join`` CUDA kernel (``KernelSnapshot``) instead of the
        tensor-op ``batched_mr`` — answers are byte-identical either way.

        ``device`` is where the snapshot lands: ``None`` means ``"cuda"``
        and raises on a host without a CUDA device.

        On a ``ProcessMesh`` (every rank calls ``build`` with the same
        arguments) the sharded construction runs across the ranks and
        every rank holds the whole ``HLIndex`` and its whole snapshot on
        its device, as the reference's engine keeps a single-device
        snapshot; ``rank_mesh`` records the mesh.  Scoped updates rebuild
        the touched components on every rank alike (the builder binds no
        mesh, as the reference's), after the ranks agree on the edits.
        """
        device = resolve_device(device)
        construction = _resolve_construction(construction, mesh, workers,
                                             num_shards)
        minimizer = minimize if minimize_labels else None
        if construction == "sharded":
            builder = functools.partial(build_sharded, workers=workers,
                                        num_shards=num_shards)
            if index is not None:
                idx = minimizer(index) if minimizer else index
            else:
                # minimization runs inside the shards too (exact: dual
                # sets are component-confined), so the whole build
                # parallelizes — byte-identical to minimize(build_fast(h))
                idx = build_sharded(h, minimizer=minimizer, workers=workers,
                                    num_shards=num_shards, mesh=mesh)
        else:
            builder = build_fast
            idx = index if index is not None else build_fast(h)
            if minimizer is not None:
                idx = minimizer(idx)
        eng = cls(h, idx, builder=builder, minimizer=minimizer,
                  device=device)
        eng.construction = construction
        eng.use_kernels = bool(use_kernels)
        if isinstance(mesh, ProcessMesh):
            eng.rank_mesh = mesh
        return eng

    def mr(self, u: int, v: int) -> int:
        self._check_vertex_ids(u, v)
        return mr_query(self.idx, int(u), int(v))

    def s_reach(self, u: int, v: int, s: int) -> bool:
        self._check_vertex_ids(u, v)
        return s_reach_query(self.idx, int(u), int(v), int(s))

    def _witness_hub(self, u: int, v: int, k: int) -> Optional[int]:
        """The Algorithm-5 join's meeting hub: a hyperedge labeled on
        both sides with min(s_u, s_v) = k (no label pair can exceed
        MR, so >= k is the argmax)."""
        label_v = self.idx.label_dict(v)
        for e, su in zip(self.idx.labels_edge[u], self.idx.labels_s[u]):
            sv = label_v.get(int(e))
            if sv is not None and min(int(su), sv) >= k:
                return int(e)
        return None

    def mr_batch(self, us, vs) -> np.ndarray:
        us, vs = self._device_pairs(us, vs)
        return self._query_snapshot().mr(us, vs).cpu().numpy()

    def s_reach_batch(self, us, vs, s: int) -> np.ndarray:
        us, vs = self._device_pairs(us, vs)
        return self._query_snapshot().s_reach(us, vs, int(s)).cpu().numpy()

    def snapshot(self) -> DeviceSnapshot:
        """Current padded device form.  After a scoped graph change the
        stale snapshot is patched: only the rows marked dirty are
        re-padded and copied over a clone of the old tensors
        (byte-identical to a from-scratch derivation); a full-rebuild
        change re-derives whole.
        """
        if self._snapshot_current():
            return self._snap
        basis, dirty = self._snap, self._dirty_rows
        if basis is None or dirty is None:
            snap = DeviceSnapshot.from_hlindex(self.idx, self.name,
                                               version=self.version,
                                               device=self.device)
            self.last_snapshot_refresh_rows = self.h.n
        else:
            snap = self._patched_snapshot(basis, dirty)
            self.last_snapshot_refresh_rows = int(dirty.size)
        self._snap = snap
        self._dirty_rows = np.empty(0, np.int64)
        return snap

    def _patched_snapshot(self, basis: DeviceSnapshot,
                          dirty: np.ndarray) -> DeviceSnapshot:
        idx, n = self.idx, self.h.n
        lengths = np.zeros(n, np.int64)
        basis_n = int(basis.ranks.shape[0])
        lengths[:basis_n] = basis.lengths.cpu().numpy()
        lengths[dirty] = [idx.labels_s[int(u)].size for u in dirty]
        lmax = int(lengths.max()) if n else 0
        row_ranks, row_svals, row_lengths = pad_label_rows(
            [idx.labels_rank[int(u)] for u in dirty],
            [idx.labels_s[int(u)] for u in dirty], pad_to=lmax)
        return basis.patch_rows(dirty, row_ranks, row_svals, row_lengths,
                                n=n, lmax=lmax, version=self.version,
                                backend=self.name)

    def _apply_update(self, inserts=(), deletes=()) -> None:
        new_h, self.idx, report = apply_updates(
            self.h, self.idx, inserts, deletes,
            builder=self._builder, minimizer=self._minimizer)
        self._graph_changed(
            new_h, dirty_rows=(None if report.full_rebuild
                               else report.refreshed_vertices))

    def nbytes(self) -> int:
        return self.idx.nbytes()


@register_backend("hl-index-basic")
class HLIndexBasicEngine(HLIndexEngine):
    """Algorithm 2 construction (no MCD/neighbor-index pruning, no
    minimization) — the ablation baseline, same query and scoped-update
    paths (updates rebuild the affected components with Algorithm 2)."""

    name = "hl-index-basic"

    @classmethod
    def build(cls, h: Hypergraph, *, cover_check: bool = True,
              construction: str = "auto", mesh=None,
              workers: Optional[int] = None,
              num_shards: Optional[int] = None,
              use_kernels: bool = False,
              device: DeviceLike = None) -> "HLIndexBasicEngine":
        device = resolve_device(device)
        base = functools.partial(build_basic, cover_check=cover_check)
        construction = _resolve_construction(construction, mesh, workers,
                                             num_shards)
        if construction == "sharded":
            builder = functools.partial(build_sharded, base=base,
                                        workers=workers,
                                        num_shards=num_shards)
            idx = build_sharded(h, base=base, workers=workers,
                                num_shards=num_shards, mesh=mesh)
        else:
            builder = base
            idx = base(h)
        eng = cls(h, idx, builder=builder, device=device)
        eng.construction = construction
        eng.use_kernels = bool(use_kernels)
        if isinstance(mesh, ProcessMesh):
            eng.rank_mesh = mesh
        return eng


# ---------------------------------------------------------------------------
# Index-free backends
# ---------------------------------------------------------------------------

@register_backend("online")
class OnlineEngine(_EngineBase):
    """Algorithm 1 bidirectional search (the paper's Base*); zero build
    cost beyond the optional neighbor cache, which updates patch on the
    1-hop touched set only.  A host structure (``core/online.py``): it
    lands nothing on a device, so ``device`` is accepted for a uniform
    ``build`` signature and not used."""

    name = "online"
    update_capability = "incremental"
    workload_capability = _TRAVERSAL_OPS

    def __init__(self, h: Hypergraph, cache: Optional[NeighborCache]):
        super().__init__(h)
        self.cache = cache

    @classmethod
    def build(cls, h: Hypergraph, *, precompute: bool = True,
              device: DeviceLike = None) -> "OnlineEngine":
        return cls(h, NeighborCache(h) if precompute else None)

    def mr(self, u: int, v: int) -> int:
        self._check_vertex_ids(u, v)
        return mr_online(self.h, int(u), int(v), self.cache)

    def _apply_update(self, inserts=(), deletes=()) -> None:
        new_h, old_to_new, touched = apply_edge_edits(self.h, inserts,
                                                      deletes)
        if self.cache is not None:
            self.cache = self.cache.updated(new_h, old_to_new, touched)
        self._graph_changed(new_h)

    def nbytes(self) -> Optional[int]:
        return self.cache.nbytes() if self.cache is not None else 0


@register_backend("frontier")
class FrontierEngine(_EngineBase):
    """Index-free sparse line-graph frontier sweeps — the batch path for
    graphs beyond dense-closure scale.  The line graph lives on
    ``device`` (``core/frontier.py``); ``rounds`` bounds propagation
    (None = |E|, exact).  ``last_sweeps`` holds one record per sweep of
    the latest batch (threshold, alive edges, rounds run)."""

    name = "frontier"
    update_capability = "incremental"
    workload_capability = _TRAVERSAL_OPS

    def __init__(self, h: Hypergraph, g: SparseLineGraph,
                 rounds: Optional[int]):
        super().__init__(h)
        self.g = g
        self.device = g.device
        self.rounds = rounds
        self.last_sweeps: List[Dict] = []

    @classmethod
    def build(cls, h: Hypergraph, *, rounds: Optional[int] = None,
              device: DeviceLike = None) -> "FrontierEngine":
        return cls(h, SparseLineGraph(h, device=device), rounds)

    def _apply_update(self, inserts=(), deletes=()) -> None:
        new_h, old_to_new, touched = apply_edge_edits(self.h, inserts,
                                                      deletes)
        self.g = self.g.updated(new_h, old_to_new, touched)
        self._graph_changed(new_h)

    def mr(self, u: int, v: int) -> int:
        return int(self.mr_batch([int(u)], [int(v)])[0])

    def s_reach(self, u: int, v: int, s: int) -> bool:
        return bool(self.s_reach_batch([int(u)], [int(v)], int(s))[0])

    def mr_batch(self, us, vs) -> np.ndarray:
        us, vs = validate_batch(us, vs, self.h.n)
        self.last_sweeps = []
        return frontier_batched_mr(self.g, us, vs, rounds=self.rounds,
                                   log=self.last_sweeps)

    def s_reach_batch(self, us, vs, s: int) -> np.ndarray:
        us, vs = validate_batch(us, vs, self.h.n)
        self.last_sweeps = []
        return frontier_batched_s_reach(self.g, us, vs, int(s),
                                        rounds=self.rounds,
                                        log=self.last_sweeps)

    def _bounded_s_reach(self, u: int, v: int, s: int, k: int) -> bool:
        # bounded *device* path: a walk of k hyperedges is k - 1
        # line-graph steps of the frontier sweep (``last_sweeps`` holds
        # its record)
        self.last_sweeps = []
        return bool(frontier_batched_s_reach(
            self.g, [u], [v], s, rounds=k - 1, log=self.last_sweeps)[0])


# ---------------------------------------------------------------------------
# Baseline backends (Section IV / VII structures)
# ---------------------------------------------------------------------------

@register_backend("ete")
class ETEEngine(_EngineBase):
    """Hyperedge-to-hyperedge 2-hop labeling; snapshot merges each
    vertex's incident label lists into the shared padded form, landed on
    ``device``.  Batches join that snapshot like the HL-index's: through
    ``batched_mr``, or with ``use_kernels`` through the ``label_join``
    kernel by vertex id (``label_join_gather``).  The structure is
    static: updates are unsupported, so the snapshot always has the
    engine's ``n`` rows, and ``validate_batch`` holds every id to it
    before anything is landed or launched."""

    name = "ete"
    workload_capability = _LABEL_OPS

    def __init__(self, h: Hypergraph, ete: ETEIndex, *,
                 device: DeviceLike = None):
        super().__init__(h)
        self.device = resolve_device(device)
        self.ete = ete
        self._snap: Optional[DeviceSnapshot] = None

    @classmethod
    def build(cls, h: Hypergraph, *, use_kernels: bool = False,
              device: DeviceLike = None) -> "ETEEngine":
        eng = cls(h, build_ete(h), device=device)
        eng.use_kernels = bool(use_kernels)
        return eng

    def mr(self, u: int, v: int) -> int:
        self._check_vertex_ids(u, v)
        return self.ete.mr(int(u), int(v))

    def mr_batch(self, us, vs) -> np.ndarray:
        us, vs = self._device_pairs(us, vs)
        return self._query_snapshot().mr(us, vs).cpu().numpy()

    def s_reach_batch(self, us, vs, s: int) -> np.ndarray:
        us, vs = self._device_pairs(us, vs)
        return self._query_snapshot().s_reach(us, vs, int(s)).cpu().numpy()

    def snapshot(self) -> DeviceSnapshot:
        if not self._snapshot_current():
            merged = [self.ete._merged(self.h.edges_of(u))
                      for u in range(self.h.n)]
            ranks, svals, lengths = pad_label_rows([r for r, _ in merged],
                                                   [s for _, s in merged])
            self._snap = DeviceSnapshot.from_padded(ranks, svals, lengths,
                                                    self.name,
                                                    version=self.version,
                                                    device=self.device)
        return self._snap

    def nbytes(self) -> int:
        return self.ete.nbytes()


@register_backend("threshold")
class ThresholdEngine(_EngineBase):
    """HypED-style per-threshold union-find components (exact; storage
    O(S·m) — the blow-up the paper contrasts against).  A host structure,
    like ``mst-oracle``: ``device`` is accepted and not used."""

    name = "threshold"

    def __init__(self, h: Hypergraph, tci: ThresholdComponentIndex):
        super().__init__(h)
        self.tci = tci

    @classmethod
    def build(cls, h: Hypergraph, *, cap: Optional[int] = None,
              device: DeviceLike = None) -> "ThresholdEngine":
        return cls(h, ThresholdComponentIndex(h, cap=cap))

    def mr(self, u: int, v: int) -> int:
        self._check_vertex_ids(u, v)
        return self.tci.mr(int(u), int(v))

    def nbytes(self) -> int:
        return self.tci.nbytes()


@register_backend("mst-oracle")
class MSTOracleEngine(_EngineBase):
    """Maximum-spanning-forest bottleneck oracle — the independent exact
    reference the cross-validation suite pins every backend against.
    A host structure: it lands nothing on a device, so ``device`` is
    accepted for a uniform ``build`` signature and not used."""

    name = "mst-oracle"

    def __init__(self, h: Hypergraph, oracle: MSTOracle):
        super().__init__(h)
        self.oracle = oracle

    @classmethod
    def build(cls, h: Hypergraph, *,
              device: DeviceLike = None) -> "MSTOracleEngine":
        return cls(h, MSTOracle(h))

    def mr(self, u: int, v: int) -> int:
        self._check_vertex_ids(u, v)
        return self.oracle.mr(int(u), int(v))


# ---------------------------------------------------------------------------
# Dense closure backend
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _close_on_device(h: Hypergraph, method: str, device: torch.device
                     ) -> Tuple[np.ndarray, torch.Tensor, Dict[str, float]]:
    """``W*`` of ``h`` closed on ``device``: the host int32 copy, the
    device copy, and the host-clock seconds of each step (device work
    synchronised)."""
    seconds = {}
    t0 = time.perf_counter()

    def lap(step: str) -> None:
        nonlocal t0
        _sync(device)
        t1 = time.perf_counter()
        seconds[step] = t1 - t0
        t0 = t1

    if h.m == 0:            # no hyperedges: nothing is reachable
        w_star = torch.zeros((0, 0), dtype=torch.int32, device=device)
    else:
        w = device_line_graph(h, device=device)
        lap("line_graph")
        w_star = close_line_graph(w, method)
        del w
        lap("closure")
    host = w_star.cpu().numpy()
    lap("host_copy")
    return host, w_star, seconds


@register_backend("closure")
class ClosureEngine(_EngineBase):
    """Dense (max, min)-semiring closure W* [m, m] (``semiring.py``).

    Built on ``device``: the line graph by the ``overlap`` kernel, then
    ⌈log2 m⌉ squaring rounds of the ``maxmin_matmul`` kernel
    (``method="maxmin"``) or of the ``threshold_step`` kernel over the
    distinct-threshold batch (``method="threshold"``); on the host the same
    code runs the plain versions.  ``w_star`` is kept as a host int32
    array: scalar ``mr`` reads it there.

    Its snapshot is the degenerate-but-exact label form: every hyperedge
    is a hub, ``L(u)[e] = max_{e_u ∋ u} W*[e_u, e]``.  Bottleneck triangle
    inequality makes the shared searchsorted join exact on these rows
    (equality is attained at the hub e = e_u of an optimal pair).  Batches
    go through ``DeviceSnapshot.mr`` (``batched_mr``), as in the
    reference.  Updates rebuild ``W*`` whole on the device (``"rebuild"``,
    as in the reference) and drop the stale snapshot at once.
    """

    name = "closure"
    update_capability = "rebuild"
    workload_capability = _LABEL_OPS | _TRAVERSAL_OPS
    _gate_hop_bounded = True

    def __init__(self, h: Hypergraph, w_star: np.ndarray,
                 method: str = "maxmin", *, device: DeviceLike = None,
                 w_star_device: Optional[torch.Tensor] = None):
        super().__init__(h)
        self.device = resolve_device(device)
        self.w_star = w_star
        self._method = method
        self._snap: Optional[DeviceSnapshot] = None
        # the build's device copy of W*, kept only until the snapshot has
        # been derived from it (saves re-landing m^2 int32 from the host)
        self._w_star_device = w_star_device
        # host-clock seconds of the build's steps, device work included
        self.build_seconds: Dict[str, float] = {}

    @classmethod
    def build(cls, h: Hypergraph, *, method: str = "maxmin",
              device: DeviceLike = None) -> "ClosureEngine":
        device = resolve_device(device)
        if h.m and method not in CLOSURE_METHODS:
            raise ValueError(method)
        host, w_star, seconds = _close_on_device(h, method, device)
        eng = cls(h, host, method, device=device, w_star_device=w_star)
        eng.build_seconds = seconds
        return eng

    def _apply_update(self, inserts=(), deletes=()) -> None:
        # dense closures have no cheap incremental form (one new overlap
        # can rewrite O(m²) entries); recompute whole on the device (the
        # overlap kernel, then the closure kernel's rounds), same protocol
        new_h, _, _ = apply_edge_edits(self.h, inserts, deletes)
        self.w_star, self._w_star_device, self.build_seconds = \
            _close_on_device(new_h, self._method, self.device)
        self._graph_changed(new_h)

    def mr(self, u: int, v: int) -> int:
        # scalar lookups stay on the host matrix (no reason to build the
        # [n, m] snapshot for a trickle of queries)
        self._check_vertex_ids(u, v)
        return int(vertex_mr_from_edge_mr(self.h, self.w_star,
                                          [int(u)], [int(v)])[0])

    def mr_batch(self, us, vs) -> np.ndarray:
        # batches go through the device join — the reason the planner
        # picks this backend for batched small-graph workloads
        us, vs = self._device_pairs(us, vs)
        return self._query_snapshot().mr(us, vs).cpu().numpy()

    def s_reach_batch(self, us, vs, s: int) -> np.ndarray:
        us, vs = self._device_pairs(us, vs)
        return self._query_snapshot().s_reach(us, vs, int(s)).cpu().numpy()

    def snapshot(self) -> DeviceSnapshot:
        """Label rows ``svals[u] = max over e_u ∋ u of W*[e_u, :]``, derived
        on the device: one gather of W* rows per incidence slot, max-folded
        into the owning vertex's row (degree-0 vertices keep zero rows);
        ranks are ``arange(m)`` on every row, lengths ``m``."""
        if not self._snapshot_current():
            h, m, dev = self.h, self.h.m, self.device
            w_star = self._w_star_device
            if w_star is None:
                # a restored W* is a read-only view into its checkpoint:
                # host_to_device copies it rather than sharing its pages
                w_star = host_to_device(self.w_star, dev)
            svals = torch.zeros((h.n, m), dtype=torch.int32, device=dev)
            deg = np.diff(h.v_ptr)
            for j in range(int(deg.max()) if h.n else 0):
                # the j-th incident hyperedge of every vertex that has one
                owners = np.nonzero(deg > j)[0]
                rows = torch.from_numpy(owners).to(dev)
                edges = torch.from_numpy(h.v_idx[h.v_ptr[owners] + j]).to(dev)
                svals.index_copy_(0, rows, torch.maximum(
                    svals.index_select(0, rows), w_star.index_select(0, edges)))
            ranks = torch.arange(m, dtype=torch.int32, device=dev)
            self._snap = DeviceSnapshot(
                ranks=ranks.expand(h.n, m).contiguous(), svals=svals,
                lengths=torch.full((h.n,), m, dtype=torch.int32, device=dev),
                backend=self.name, version=self.version)
            self._w_star_device = None
            self.last_snapshot_refresh_rows = h.n
            self._dirty_rows = np.empty(0, np.int64)
        return self._snap

    def nbytes(self) -> int:
        return int(self.w_star.nbytes)


# ---------------------------------------------------------------------------
# Mesh backend — lives in distributed.py; importing it here registers
# "sharded" so the registry is complete after `import engine`.
# ---------------------------------------------------------------------------

from . import distributed as _distributed  # noqa: E402,F401
