"""Algorithm 1: online bidirectional priority-based max-reachability search.

Faithful to the paper's pseudocode: two max-priority queues seeded with
(e, |e|) for hyperedges incident to each endpoint (Corollary 1), phase
alternation via ``switch``, meeting-point result update, and the two
pruning rules (line 10: dominated revisit; line 16: OD ≤ current result).

``Base`` computes neighbors on the fly (O(δd) each); ``Base*`` (the paper's
starred variant) reuses a precomputed neighbor adjacency.

Counterpart of ``repro/core/online.py``, same names in the same order.
Algorithm 1 is a per-query priority search on the host (``heapq``), so
this module stays numpy and Python: nothing of it runs on a device.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from .hypergraph import Hypergraph

__all__ = ["mr_online", "precompute_neighbors", "NeighborCache"]


class NeighborCache:
    """Optional precomputed neighbor lists (the paper's Base* / adjacency N).

    Memory O(Σ|N(e)|) — the expensive structure the neighbor-index M of
    Alg. 3 is designed to avoid during construction; for *queries* it is a
    straightforward time/space trade.
    """

    def __init__(self, h: Hypergraph,
                 _lists: Optional[Tuple[List[np.ndarray],
                                        List[np.ndarray]]] = None):
        if _lists is not None:
            self.nbrs, self.ods = _lists
            return
        self.nbrs: List[np.ndarray] = []
        self.ods: List[np.ndarray] = []
        for e in range(h.m):
            nb, od = h.neighbors_od(e)
            self.nbrs.append(nb)
            self.ods.append(od)

    def __call__(self, e: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.nbrs[e], self.ods[e]

    def updated(self, new_h: Hypergraph, old_to_new: np.ndarray,
                touched) -> "NeighborCache":
        """Cache for the edited graph: only hyperedges in ``touched`` (new
        ids — see ``apply_edge_edits``) recompute their neighbor lists;
        every other surviving hyperedge keeps its lists with ids remapped.
        An untouched hyperedge never neighbors a deleted one (neighbors of
        deleted hyperedges are by definition touched), so the remap is
        total on kept lists."""
        touched_set = {int(t) for t in touched}
        old_of = np.full(new_h.m, -1, np.int64)
        kept = np.nonzero(old_to_new >= 0)[0]
        old_of[old_to_new[kept]] = kept
        nbrs: List[np.ndarray] = []
        ods: List[np.ndarray] = []
        for e in range(new_h.m):
            e_old = int(old_of[e])
            if e in touched_set or e_old < 0:
                nb, od = new_h.neighbors_od(e)
            else:
                # old_to_new is strictly increasing on survivors, so the
                # remapped list keeps the sorted-id invariant as-is
                nb = old_to_new[self.nbrs[e_old]]
                od = self.ods[e_old]
            nbrs.append(nb)
            ods.append(od)
        return NeighborCache(new_h, _lists=(nbrs, ods))

    def nbytes(self) -> int:
        return sum(a.nbytes + b.nbytes for a, b in zip(self.nbrs, self.ods))


def precompute_neighbors(h: Hypergraph) -> NeighborCache:
    return NeighborCache(h)


def mr_online(h: Hypergraph, u: int, v: int,
              neighbors: Optional[NeighborCache] = None) -> int:
    """MR(u, v) via Algorithm 1.  Returns 0 if not reachable."""
    get_nbrs = neighbors if neighbors is not None else h.neighbors_od

    visit_in: Dict[int, int] = {}
    visit_out: Dict[int, int] = {}
    q_in: List[Tuple[int, int]] = []   # max-heap via negated s
    q_out: List[Tuple[int, int]] = []
    result = 0

    for e in h.edges_of(u):
        heapq.heappush(q_out, (-h.edge_size(int(e)), int(e)))
    for e in h.edges_of(v):
        heapq.heappush(q_in, (-h.edge_size(int(e)), int(e)))

    def run_phase(q_same, visit_same, visit_other) -> int:
        """Process one phase (current queue contents) of one direction."""
        nonlocal result
        for _ in range(len(q_same)):
            if not q_same:
                break
            neg_s, e = heapq.heappop(q_same)
            s = -neg_s
            if s <= visit_same.get(e, -1):           # line 10
                continue
            visit_same[e] = s                        # line 11
            so = visit_other.get(e, -1)
            if so > result:                          # lines 12-14
                result = max(result, min(s, so))
                continue
            nb, od = get_nbrs(e)
            for e2, w in zip(nb, od):                # lines 15-17
                w = int(w)
                if w <= result:                      # line 16
                    continue
                ns = min(s, w)
                e2 = int(e2)
                if ns <= visit_same.get(e2, -1):
                    continue
                heapq.heappush(q_same, (-ns, e2))
        return result

    switch = 0
    while q_in or q_out:
        if switch == 0:
            run_phase(q_in, visit_in, visit_out)
            switch = 1
        else:
            run_phase(q_out, visit_out, visit_in)
            switch = 0
    return result
