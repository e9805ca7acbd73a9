"""Witness extraction: turn a yes/no MR answer into the hyperedge walk
that achieves it.

The reconstruction is hub-anchored meet-in-the-middle.  An HL-index
query answers MR(u, v) = k through a common hub label (e*, s_u), (e*,
s_v) with min(s_u, s_v) = k — the hub names a hyperedge some optimal
walk passes through, but the labels deliberately do not store the walk
itself (that is what keeps them |label|-sized).  ``extract_witness``
re-expands the two halves: a forward BFS from u's incident edges and a
backward BFS from v's, both restricted to the >= k line graph, meeting
at the hub when one is known (label backends) or wherever the frontiers
first touch (closure backends, where every hyperedge is a hub).  Any
path in the >= k line graph is by construction a walk with overlap
degree >= k, and k = MR is the maximum possible, so the checker's
equality test (``verify_witness``) is exact, not approximate.

Completeness: MR(u, v) = k means some valid walk exists.  A one-edge
walk is a shared incident edge of size k (checked first).  A longer
walk e_1..e_t has every edge forward- and backward-reachable, so either
some meeting edge yields a combined walk of length >= 2, or — when both
frontiers only meet at shared *seed* edges too small to stand alone —
the adjacent pair (e_{t-1}, e_t) is caught by the pair scan.

Counterpart of ``repro/workloads/witness.py``: the same iteration order
(sorted seeds, neighbors in stored order, the forward depth map in
insertion order, the stop at the label-named hub), so the walks equal
the reference's, not merely pass ``verify_witness``.
"""
from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING, Dict, Iterable, Optional, Tuple

if TYPE_CHECKING:                      # annotation-only; no runtime import
    from ..core.hypergraph import Hypergraph

__all__ = ["extract_witness"]


def _bfs(h: Hypergraph, seeds: Iterable[int], k: int,
         ) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Multi-source BFS over the >= k line graph.  Returns (parent,
    depth) maps; seeds have parent -1, depth 0.  Deterministic: seeds
    and neighbors are visited in sorted / stored order."""
    parent: Dict[int, int] = {}
    depth: Dict[int, int] = {}
    queue: deque = deque()
    for e in sorted(int(e) for e in seeds):
        if e not in parent:
            parent[e] = -1
            depth[e] = 0
            queue.append(e)
    while queue:
        e = queue.popleft()
        nbrs, ods = h.neighbors_od(e)
        for nb, od in zip(nbrs, ods):
            nb = int(nb)
            if int(od) >= k and nb not in parent:
                parent[nb] = e
                depth[nb] = depth[e] + 1
                queue.append(nb)
    return parent, depth


def _path_to_seed(parent: Dict[int, int], e: int) -> Tuple[int, ...]:
    """Walk ``e`` back to its seed: returns (seed, ..., e)."""
    out = [e]
    while parent[out[-1]] != -1:
        out.append(parent[out[-1]])
    return tuple(reversed(out))


def extract_witness(h: Hypergraph, u: int, v: int, k: int,
                    hub: Optional[int] = None) -> Tuple[int, ...]:
    """The hyperedge walk certifying MR(u, v) = k (see module
    docstring).  ``k`` must be the true MR — the caller computes it
    through whatever index it owns; a wrong k either fails the search
    (k too large) or yields a walk the checker rejects (k too small).
    Returns () for k <= 0."""
    if k <= 0:
        return ()
    eu = [int(e) for e in h.edges_of(int(u))]
    ev = [int(e) for e in h.edges_of(int(v))]
    ev_set = set(ev)
    sizes = h.edge_sizes
    # one-edge walk: WOD = |e|, and no walk can beat k = MR, so a shared
    # edge of size >= k has size exactly k and is itself optimal
    shared = sorted(e for e in eu if e in ev_set and int(sizes[e]) >= k)
    if shared:
        return (shared[0],)
    par_f, dep_f = _bfs(h, eu, k)
    par_b, dep_b = _bfs(h, ev, k)
    # meeting edges: combined walk fwd-half + bwd-half; a length-1
    # combination (both halves are the same seed edge) was ruled out by
    # the shared-edge check unless |e| < k, in which case it is invalid
    # and skipped here
    best = None                        # (total_hops, meet_edge)
    for e, df in dep_f.items():
        db = dep_b.get(e)
        if db is None or (df + db == 0 and int(sizes[e]) < k):
            continue
        cand = (df + db, e)
        if hub is not None and e == int(hub):
            best = cand                # prefer the label-named hub
            break
        if best is None or cand < best:
            best = cand
    if best is not None:
        e = best[1]
        fwd = _path_to_seed(par_f, e)
        bwd = _path_to_seed(par_b, e)
        return fwd + tuple(reversed(bwd))[1:]
    # frontiers only meet at undersized shared seeds: stitch an adjacent
    # pair (a, b) with a forward-reached, b backward-reached, od >= k
    pair = None                        # (total_hops, a, b)
    for a in sorted(par_f):
        nbrs, ods = h.neighbors_od(a)
        for nb, od in zip(nbrs, ods):
            nb = int(nb)
            if int(od) >= k and nb in par_b:
                cand = (dep_f[a] + dep_b[nb], a, nb)
                if pair is None or cand < pair:
                    pair = cand
    if pair is None:
        raise ValueError(
            f"no >= {k} walk joins {u} and {v}: k is not their MR")
    _, a, b = pair
    fwd = _path_to_seed(par_f, a)
    bwd = _path_to_seed(par_b, b)
    return fwd + tuple(reversed(bwd))
