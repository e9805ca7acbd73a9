"""HL-index maintenance under hyperedge updates (paper §V-D).

The paper sketches insert/delete maintenance but defers the algorithm;
this is **component-scoped maintenance**: labels never cross connected
components of the line graph (a walk cannot leave a component), so an
insertion/deletion only invalidates labels whose hub lies in the touched
component(s).  Both the label *content* and the label *construction* are
scoped:

1. ``apply_edge_edits`` (hypergraph.py) applies the graph edit and
   reports the 1-hop touched hyperedges; ``component_of`` expands them
   to the affected line-graph component(s) of the new graph.
2. ``induced_subhypergraph`` extracts exactly those components and the
   construction algorithm (``build_fast`` by default) runs on the
   sub-hypergraph alone — the full graph is never re-traversed.
3. ``splice_rank`` (hlindex.py) composes a global importance rank —
   surviving out-of-scope hyperedges keep their old relative order,
   in-scope hyperedges follow in sub-index order — and the splice maps
   the sub-index's labels back into the global id space.  Vertices
   outside the scope keep their label arrays (and any minimization
   state) byte-for-byte; vertices inside get the fresh sub-labels.

Why the splice is exact: the scope is a union of whole components of
the *new* line graph.  Every fragment of a deleted hyperedge's old
component contains one of its old neighbors (take the last hyperedge
before the deleted one on any old path into the fragment), so seeding
the BFS with those neighbors covers all fragments; an inserted
hyperedge seeds its own merged component.  A vertex is incident either
only to in-scope or only to out-of-scope hyperedges (hyperedges sharing
a vertex are line-graph adjacent), so each label list is rebuilt whole
or kept whole — never mixed — and cross-group rank order is
unobservable by any query.

Limitation (recorded): hyperedge importance is recomputed only inside
the scope, so an update that changes vertex degrees can in principle
reorder *other* components' hyperedges; the original order is kept for
untouched components (any total order yields a correct index — order
only affects minimality).

``builder`` is any callable producing an ``HLIndex`` for the scope's
sub-hypergraph — ``build_fast`` (default) or ``build_basic``.

Counterpart of ``repro/core/maintenance.py``, same names in the same
order and the same results byte for byte; host numpy only, nothing here
touches a device.  The engines (``core/engine.py``) turn an
``UpdateReport`` into the dirty rows of their device snapshot.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .hypergraph import (Hypergraph, NeighborCSR, apply_edge_edits,
                         induced_subhypergraph)
from .hlindex import HLIndex, build_fast, splice_rank

__all__ = ["insert_hyperedge", "delete_hyperedge", "apply_updates",
           "component_of", "normalize_update_batch", "UpdateReport"]


def normalize_update_batch(h: Hypergraph, inserts: Sequence[Iterable[int]] = (),
                           deletes: Sequence[int] = ()
                           ) -> Tuple[List[List[int]], List[int]]:
    """Validate and canonicalize one update batch *before* it is applied
    (or journaled — a write-ahead sink is handed the canonical batch, so
    a rejected batch is never written durably).

    Mirrors ``apply_edge_edits`` exactly: deletes must name existing
    hyperedges of ``h`` (same ``IndexError``), inserts dedup-sort their
    members and drop empties (same ``IndexError`` on negative vertex
    ids), and non-empty inserts keep their argument order (their appended
    hyperedge ids depend on it).  Applying the canonical batch is
    byte-identical to applying the original.

    Returns ``(inserts, deletes)`` as plain nested int lists — directly
    JSON-serializable for a journal.
    """
    dels = sorted({int(d) for d in deletes})
    for d in dels:
        if not 0 <= d < h.m:
            raise IndexError(f"delete of hyperedge {d} out of range "
                             f"[0, {h.m})")
    ins: List[List[int]] = []
    for ed in inserts:
        arr = np.unique(np.asarray(list(ed), dtype=np.int64))
        if arr.size == 0:
            continue
        if arr.min() < 0:
            raise IndexError(f"insert with negative vertex id {arr.min()}")
        ins.append([int(x) for x in arr])
    return ins, dels


@dataclasses.dataclass(frozen=True)
class UpdateReport:
    """What a maintenance step touched — the dirty-rows contract consumed
    by snapshot caching (``engine.snapshot()`` re-derives only these label
    rows; the serving layer patches only these rows of its resident
    snapshot copies).

    * ``scope`` — hyperedges whose labels were rebuilt (the affected
      line-graph component(s)).
    * ``refreshed_vertices`` — sorted vertex ids whose ``(labels_rank,
      labels_s)`` arrays may differ from the pre-update index.  Every
      other vertex's label row is byte-identical (the splice keeps the
      arrays by reference and ``splice_rank`` preserves out-of-scope rank
      values), so a padded snapshot only needs these rows re-derived.
    * ``full_rebuild`` — True when the whole index was rebuilt (scope
      covered the graph, rank key space exhausted, or there was no old
      index); ``refreshed_vertices`` then covers every vertex.
    * ``neighbors`` — the 1-hop-patched ``NeighborCSR`` for the new
      graph, when the caller passed one in (``apply_updates(...,
      neighbors=)``); callers that keep a persistent neighbor index feed
      it back into the next update so no full O(Σd²) pair pass ever
      reruns.
    """

    scope: int
    refreshed_vertices: np.ndarray
    full_rebuild: bool
    neighbors: Optional[NeighborCSR] = None


def component_of(h: Hypergraph, seeds: Sequence[int],
                 neighbors: Optional[NeighborCSR] = None) -> Set[int]:
    """Connected component(s) of the line graph containing ``seeds``.
    With ``neighbors`` the BFS reads precomputed CSR rows instead of
    recomputing each neighborhood on the fly."""
    row = neighbors.row if neighbors is not None else h.neighbors_od
    seen: Set[int] = set(int(s) for s in seeds)
    stack = list(seen)
    while stack:
        e = stack.pop()
        nb, _ = row(e)
        for e2 in nb:
            e2 = int(e2)
            if e2 not in seen:
                seen.add(e2)
                stack.append(e2)
    return seen


def _splice(new_h: Hypergraph, old_idx: HLIndex, old_to_new: np.ndarray,
            scope: np.ndarray, refresh_vertices: np.ndarray,
            builder: Callable[[Hypergraph], HLIndex],
            minimizer: Optional[Callable[[HLIndex], HLIndex]],
            identity_map: bool,
            neighbors: Optional[NeighborCSR] = None
            ) -> Tuple[HLIndex, np.ndarray]:
    """Build the index for the ``scope`` hyperedges of ``new_h`` only and
    splice it over the surviving labels of ``old_idx``.  With
    ``identity_map`` (no deletions: hyperedge ids unshifted) untouched
    vertices share all three label arrays with the old index; rank
    values of out-of-scope hyperedges are preserved by ``splice_rank``,
    so ``labels_rank`` is shared in both cases.  ``neighbors`` (the
    patched CSR over ``new_h``) is restricted to the scope and handed to
    the builder, so scope construction never recomputes neighborhoods.
    Returns ``(new_idx, refreshed_vertices)`` — the rows whose label
    content changed."""
    if scope.size:
        sub_h, sub_verts = induced_subhypergraph(new_h, scope)
        sub_idx = (builder(sub_h, neighbors=neighbors.induced(scope))
                   if neighbors is not None else builder(sub_h))
        if minimizer is not None:
            sub_idx = minimizer(sub_idx)
        sub_rank = sub_idx.rank
        if sub_rank.shape[0] != sub_h.m:
            raise ValueError(
                f"builder returned an index over {sub_rank.shape[0]} "
                f"hyperedges for a scope of {sub_h.m} — the splice needs "
                f"one rank key per in-scope hyperedge")
    else:
        sub_h, sub_verts = None, np.empty(0, np.int64)
        sub_idx, sub_rank = None, np.empty(0, np.int64)

    rank = splice_rank(old_idx.rank, old_to_new, scope, sub_rank, new_h.m)
    perm = np.argsort(rank)

    refresh = np.zeros(new_h.n, bool)
    refresh[sub_verts] = True
    refresh[refresh_vertices[refresh_vertices < new_h.n]] = True
    local_of = np.full(new_h.n, -1, np.int64)
    local_of[sub_verts] = np.arange(sub_verts.size)

    # out-of-scope vertices share all label arrays with the old index
    # (never mutated; splice_rank preserved their hubs' rank values) —
    # only hyperedge ids need remapping, and only when deletions shifted
    # ids.  Start from whole-list copies and patch the refreshed rows.
    empty = np.empty(0, np.int64)
    pad = [empty] * (new_h.n - old_idx.h.n)
    le: List[np.ndarray] = list(old_idx.labels_edge) + pad
    lr: List[np.ndarray] = list(old_idx.labels_rank) + pad
    ls: List[np.ndarray] = list(old_idx.labels_s) + pad
    if not identity_map:
        for u in range(old_idx.h.n):
            if le[u].size and not refresh[u]:
                le[u] = old_to_new[le[u]]
    for u in np.nonzero(refresh)[0]:
        lu = int(local_of[u])
        if lu >= 0:
            e = scope[sub_idx.labels_edge[lu]]
            le[u] = e
            lr[u] = rank[e] if e.size else empty
            ls[u] = sub_idx.labels_s[lu]
        else:                           # lost its last hyperedge: no labels
            le[u] = lr[u] = ls[u] = empty

    # duals: vertex ids are never renumbered, so out-of-scope hyperedges
    # keep their (vertex, s) arrays; in-scope ones come from the sub-index
    if identity_map:
        du: List[np.ndarray] = list(old_idx.dual_u) + [empty] * (
            new_h.m - old_idx.h.m)
        ds: List[np.ndarray] = list(old_idx.dual_s) + [empty] * (
            new_h.m - old_idx.h.m)
    else:
        kept_old = np.nonzero(old_to_new >= 0)[0]
        du = [old_idx.dual_u[int(e)] for e in kept_old]
        ds = [old_idx.dual_s[int(e)] for e in kept_old]
        du += [empty] * (new_h.m - len(du))
        ds += [empty] * (new_h.m - len(ds))
    for loc, e in enumerate(scope):
        du[int(e)] = sub_verts[sub_idx.dual_u[loc]]
        ds[int(e)] = sub_idx.dual_s[loc]

    stats = dict(old_idx.stats)
    if sub_idx is not None:
        for key, val in sub_idx.stats.items():
            stats[f"sub_{key}"] = val
    stats["maintenance_scope"] = int(scope.size)
    stats["maintenance_subgraph_m"] = int(sub_h.m) if sub_h is not None else 0
    idx = HLIndex(h=new_h, rank=rank, perm=perm, labels_edge=le,
                  labels_rank=lr, labels_s=ls, dual_u=du, dual_s=ds,
                  stats=stats)
    # new vertices (n grew) are refreshed by construction: they either got
    # fresh sub-labels or start empty — both differ from "no row at all"
    refreshed = refresh.copy()
    refreshed[old_idx.h.n:] = True
    return idx, np.nonzero(refreshed)[0]


def apply_updates(h: Hypergraph, idx: Optional[HLIndex],
                  inserts: Sequence[Iterable[int]] = (),
                  deletes: Sequence[int] = (), *,
                  builder: Callable[[Hypergraph], HLIndex] = build_fast,
                  minimizer: Optional[Callable[[HLIndex], HLIndex]] = None,
                  neighbors: Optional[NeighborCSR] = None
                  ) -> Tuple[Hypergraph, HLIndex, UpdateReport]:
    """Apply a batch of hyperedge inserts/deletes and maintain the index.

    Returns ``(new_h, new_idx, report)``.  Construction runs only on the
    affected line-graph component(s) (``builder`` on the extracted
    sub-hypergraph, ``minimizer`` applied to the sub-index if given);
    everything else is spliced from ``idx``.  ``idx=None`` builds from
    scratch.  The ``UpdateReport`` names the vertex rows whose label
    content changed — the dirty-rows contract snapshot caching consumes.

    ``neighbors`` — a ``NeighborCSR`` over ``h``.  It is 1-hop patched to
    the new graph (``NeighborCSR.updated``), drives the component BFS and
    the scope builder, and comes back in ``report.neighbors`` so a
    persistent caller pays the full pair pass at most once.  Answers are
    exactly those of a full rebuild (tests/test_torch_maintenance.py
    holds the labels byte-identical to the reference's).
    """
    new_h, old_to_new, touched = apply_edge_edits(h, inserts, deletes)
    nbr = (neighbors.updated(new_h, old_to_new, touched)
           if neighbors is not None else None)

    def rebuilt(scope_size: int) -> Tuple[Hypergraph, HLIndex, UpdateReport]:
        new_idx = (builder(new_h, neighbors=nbr) if nbr is not None
                   else builder(new_h))
        if minimizer is not None:
            new_idx = minimizer(new_idx)
        new_idx.stats["maintenance_scope"] = scope_size
        new_idx.stats["maintenance_subgraph_m"] = int(new_h.m)
        return new_h, new_idx, UpdateReport(
            scope=scope_size, refreshed_vertices=np.arange(new_h.n),
            full_rebuild=True, neighbors=nbr)

    if idx is None:
        return rebuilt(int(new_h.m))
    affected = (component_of(new_h, touched, neighbors=nbr)
                if touched.size else set())
    scope = np.fromiter(sorted(affected), np.int64, len(affected))
    # vertices of deleted hyperedges may have lost their last hyperedge
    # (degree 0 in new_h) without being incident to any in-scope edge —
    # their stale labels must be dropped, so force-refresh them
    refresh_extra = (np.unique(np.concatenate(
        [h.edge(int(d)) for d in deletes])) if len(deletes)
        else np.empty(0, np.int64))
    rank_headroom = (int(idx.rank.max()) if idx.rank.size else 0) < 2 ** 30
    if scope.size == new_h.m or not rank_headroom:
        # everything affected (or the sparse rank key space ran out after
        # ~2^30 cumulative scope edges): plain dense rebuild
        return rebuilt(int(scope.size))
    new_idx, refreshed = _splice(new_h, idx, old_to_new, scope,
                                 refresh_extra, builder, minimizer,
                                 identity_map=not len(deletes),
                                 neighbors=nbr)
    return new_h, new_idx, UpdateReport(scope=int(scope.size),
                                        refreshed_vertices=refreshed,
                                        full_rebuild=False, neighbors=nbr)


def insert_hyperedge(h: Hypergraph, idx: HLIndex,
                     vertices: Sequence[int]) -> Tuple[Hypergraph, HLIndex]:
    """Insert a hyperedge; returns (new graph, maintained index)."""
    new_h, new_idx, _ = apply_updates(h, idx, inserts=[vertices])
    return new_h, new_idx


def delete_hyperedge(h: Hypergraph, idx: HLIndex, edge_id: int
                     ) -> Tuple[Hypergraph, HLIndex]:
    """Delete a hyperedge; rebuilds every fragment of its old component."""
    new_h, new_idx, _ = apply_updates(h, idx, deletes=[edge_id])
    return new_h, new_idx
