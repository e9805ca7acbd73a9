"""Baselines from Section IV / VII — the part the main path is checked with.

* ``MSTOracle`` — maximum-spanning-forest bottleneck oracle (classic
  maximin-path identity), an independent exact implementation used to
  cross-validate the HL-index on larger graphs.
* ``line_graph_edges`` — the sparse line-graph edge list it is built from.

Counterpart of ``repro/core/baselines.py``; the other baselines there
(``vtv_query``, ``ETEIndex``, ``ThresholdComponentIndex``) and the
brute-force workload references follow with roadmap items A6 and A8.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .hypergraph import Hypergraph

__all__ = ["MSTOracle", "line_graph_edges"]


def line_graph_edges(h: Hypergraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse line-graph edge list (i < j, OD > 0) built from incidence."""
    src: List[int] = []
    dst: List[int] = []
    ods: List[int] = []
    for e in range(h.m):
        nb, od = h.neighbors_od(e)
        for e2, w in zip(nb, od):
            if e < int(e2):
                src.append(e)
                dst.append(int(e2))
                ods.append(int(w))
    return (np.array(src, np.int64), np.array(dst, np.int64),
            np.array(ods, np.int64))


class _DSU:
    def __init__(self, n: int):
        self.p = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.p
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return int(x)

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra



# ---------------------------------------------------------------------------
# MST bottleneck oracle (independent exact implementation)
# ---------------------------------------------------------------------------

class MSTOracle:
    """Maximin(e_i, e_j) equals the minimum edge on the maximum-spanning-
    forest path — an O(m α) build + O(m) per query independent oracle."""

    def __init__(self, h: Hypergraph):
        self.h = h
        src, dst, od = line_graph_edges(h)
        order = np.argsort(-od)
        dsu = _DSU(h.m)
        adj: List[List[Tuple[int, int]]] = [[] for _ in range(h.m)]
        for i in order:
            a, b_, w = int(src[i]), int(dst[i]), int(od[i])
            if dsu.find(a) != dsu.find(b_):
                dsu.union(a, b_)
                adj[a].append((b_, w))
                adj[b_].append((a, w))
        self.adj = adj

    def edge_mr(self, ei: int, ej: int) -> int:
        if ei == ej:
            return self.h.edge_size(ei)
        # BFS on the forest tracking the path bottleneck
        best = {ei: np.iinfo(np.int64).max}
        stack = [ei]
        while stack:
            x = stack.pop()
            for y, w in self.adj[x]:
                nb = min(best[x], w)
                if y not in best:
                    best[y] = nb
                    if y == ej:
                        return int(nb)
                    stack.append(y)
        return 0

    def mr(self, u: int, v: int) -> int:
        out = 0
        for eu in self.h.edges_of(u):
            for ev in self.h.edges_of(v):
                out = max(out, self.edge_mr(int(eu), int(ev)))
        return out
