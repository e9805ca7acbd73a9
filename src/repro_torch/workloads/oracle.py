"""Landmark s-distance oracle (Hyper-distance Oracles, PAPERS.md,
restated under the paper's s-overlap walk semantics).

``DistanceOracle`` answers "how many hyperedges does an s-walk from u
to v need" with a *certified upper bound*: every returned value is the
length of an actual walk routed through a landmark hyperedge, so

    exact == 0  <=>  bound == 0        (reachability is never wrong)
    exact <= bound                      (and equal through a landmark)

Construction: on the >= s line graph, pick one landmark per connected
component (the max-degree hyperedge — high-degree roots cover the most
walks, the same importance intuition as the HL-index hub order) plus a
few extra global top-degree landmarks for tightness, and run one BFS
tree per landmark.  A query folds E(u) and E(v) onto each landmark's
tree: min over landmarks of d(E(u), l) + d(l, E(v)) + 1 hyperedges.
Per-component coverage is what certifies the zero case — any walk of
length >= 2 lives inside one component, whose landmark then yields a
finite bound; length-1 walks (a shared edge of size >= s) are checked
directly.

Counterpart of ``repro/workloads/oracle.py``: host numpy with the same
stable sorts, so ``landmarks`` and the ``[landmarks, m]`` int32 distance
table equal the reference's byte for byte.
"""
from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING, List

import numpy as np

from ..core.baselines import line_graph_edges

if TYPE_CHECKING:                      # annotation-only; no runtime import
    from ..core.hypergraph import Hypergraph

__all__ = ["DistanceOracle"]


class DistanceOracle:
    """BFS trees rooted at high-degree landmarks of the >= s line
    graph; ``distance(u, v)`` serves certified upper bounds on the
    s-distance (0 = provably no s-walk)."""

    def __init__(self, h: Hypergraph, s: int, *, extra_landmarks: int = 4):
        self.h = h
        self.s = int(s)
        if self.s < 1:
            raise ValueError(f"s-distance needs s >= 1; got {s}")
        m = h.m
        src, dst, od = line_graph_edges(h)
        keep = od >= self.s
        src, dst = src[keep], dst[keep]
        adj: List[List[int]] = [[] for _ in range(m)]
        for a, b in zip(src, dst):
            adj[int(a)].append(int(b))
            adj[int(b)].append(int(a))
        self._adj = adj
        deg = np.fromiter((len(a) for a in adj), np.int64, m)
        # components of the alive graph; one landmark each certifies
        # the zero case (module docstring)
        comp = np.full(m, -1, np.int64)
        n_comp = 0
        for e0 in range(m):
            if comp[e0] >= 0 or not adj[e0]:
                continue
            comp[e0] = n_comp
            queue = deque([e0])
            while queue:
                e = queue.popleft()
                for nb in adj[e]:
                    if comp[nb] < 0:
                        comp[nb] = n_comp
                        queue.append(nb)
            n_comp += 1
        landmarks: List[int] = []
        for c in range(n_comp):
            members = np.nonzero(comp == c)[0]
            best = members[np.lexsort((members, -deg[members]))[0]]
            landmarks.append(int(best))
        for e in np.lexsort((np.arange(m), -deg)):
            if len(landmarks) >= n_comp + int(extra_landmarks):
                break
            if deg[e] > 0 and int(e) not in landmarks:
                landmarks.append(int(e))
        self.landmarks = tuple(landmarks)
        self._dist = np.full((len(landmarks), m), -1, np.int32)
        for i, lm in enumerate(landmarks):
            d = self._dist[i]
            d[lm] = 0
            queue = deque([lm])
            while queue:
                e = queue.popleft()
                for nb in adj[e]:
                    if d[nb] < 0:
                        d[nb] = d[e] + 1
                        queue.append(nb)

    @property
    def num_landmarks(self) -> int:
        return len(self.landmarks)

    def nbytes(self) -> int:
        return int(self._dist.nbytes)

    def distance(self, u: int, v: int) -> int:
        """Certified upper bound on the s-distance in hyperedges
        (0 = no s-walk; nonzero bounds are lengths of actual walks)."""
        h, s = self.h, self.s
        u, v = int(u), int(v)
        eu = [int(e) for e in h.edges_of(u)]
        ev = [int(e) for e in h.edges_of(v)]
        ev_set = set(ev)
        sizes = h.edge_sizes
        if any(e in ev_set and int(sizes[e]) >= s for e in eu):
            return 1
        best = None
        if eu and ev:
            for i in range(len(self.landmarks)):
                d = self._dist[i]
                du_all = d[eu]
                dv_all = d[ev]
                du = du_all[du_all >= 0]
                dv = dv_all[dv_all >= 0]
                if du.size == 0 or dv.size == 0:
                    continue
                # cand == 1 only when both sides sit on the landmark
                # itself; landmarks have an alive neighbor, so od >= s
                # forces |lm| >= s and the shared-edge check above
                # already answered — every surviving cand is a real
                # multi-edge walk through lm
                cand = int(du.min()) + int(dv.min()) + 1
                if best is None or cand < best:
                    best = cand
        return 0 if best is None else best
