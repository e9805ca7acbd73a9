"""Hop-bounded s-reachability: is there an s-walk of at most k
hyperedges joining u and v (K-Reach's question, PAPERS.md, under the
paper's s-overlap walk semantics).

Two serving paths share one contract:

* ``bounded_s_distance`` — host BFS over the >= s line graph with an
  explicit hop budget; the generic engine path, and the k-bounded
  building block the landmark oracle's exactness tests lean on.
* ``FrontierEngine`` overrides ``s_reach_k`` with the frontier sweep
  on the device at ``rounds = k - 1`` (a walk of k hyperedges is k - 1
  line-graph steps) — the bounded *device* path.

Index-backed engines wrap either path in a pruning gate: an HL-index /
closure lookup answers unbounded s-reach in O(label) time, so ``mr(u,
v) < s`` rejects immediately (no bounded walk can exist where no walk
exists), and ``k >= m`` accepts immediately (a shortest walk never
repeats a hyperedge, so m edges always suffice).

Counterpart of ``repro/workloads/hop_bounded.py``: host BFS, unchanged.
"""
from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:                      # annotation-only; no runtime import
    from ..core.hypergraph import Hypergraph

__all__ = ["bounded_s_distance", "hop_bounded_s_reach"]


def bounded_s_distance(h: Hypergraph, u: int, v: int, s: int,
                       max_hyperedges: Optional[int] = None) -> int:
    """Fewest hyperedges in an s-walk joining ``u`` and ``v`` (0 = none
    within the budget).  A one-edge walk needs a shared edge of size
    >= s; longer walks BFS the >= s line graph, where every edge on the
    walk has size >= s automatically (od <= min size)."""
    u, v, s = int(u), int(v), int(s)
    budget = h.m if max_hyperedges is None else int(max_hyperedges)
    if budget < 1:
        return 0
    eu = [int(e) for e in h.edges_of(u)]
    ev_set = {int(e) for e in h.edges_of(v)}
    sizes = h.edge_sizes
    if any(e in ev_set and int(sizes[e]) >= s for e in eu):
        return 1
    if budget < 2:
        return 0
    seen = set(eu)
    frontier = deque((e, 1) for e in eu)
    while frontier:
        e, d = frontier.popleft()
        if d >= budget:
            continue
        nbrs, ods = h.neighbors_od(e)
        for nb, od in zip(nbrs, ods):
            nb = int(nb)
            if int(od) < s or nb in seen:
                continue
            if nb in ev_set:
                return d + 1
            seen.add(nb)
            frontier.append((nb, d + 1))
    return 0


def hop_bounded_s_reach(h: Hypergraph, u: int, v: int, s: int,
                        k: int) -> bool:
    """``s_reach_k``: an s-walk of at most ``k`` hyperedges exists."""
    return bounded_s_distance(h, u, v, s, max_hyperedges=int(k)) > 0
