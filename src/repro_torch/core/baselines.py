"""Baselines from Section IV / VII.

* ``vtv_query`` — the vertex-to-vertex 2-hop extension the paper shows to
  be *incorrect* (Example 5: it over-estimates because the hub vertex
  forgets which hyperedge each side used).
* ``ETEIndex`` — hyperedge-to-hyperedge labeling (correct, but query cost
  grows with |E(u)|·|E(v)| label mass; the paper's merge-sort variant is
  implemented).
* ``ThresholdComponentIndex`` — HypED-style per-threshold structure: for
  every candidate s, union-find components of the ≥s line graph.  Exact
  for MR, but storage is O(S·m) with S up to δ — reproducing the paper's
  observation that HypED-style oracles blow up when s ranges to tens of
  thousands (their OOM rows in Exp-1).
* ``MSTOracle`` — maximum-spanning-forest bottleneck oracle (classic
  maximin-path identity), an independent exact implementation used to
  cross-validate the semiring closure and the HL-index on larger graphs.
* ``line_graph_edges`` — the sparse line-graph edge list the last two and
  the frontier sweeps (``frontier.py``) are built from.

Counterpart of ``repro/core/baselines.py``: host numpy, the same
algorithms and the same stable sorts, so labels and component ids equal
the reference's byte for byte.  The brute-force workload references
(``brute_force_*``) close the module, as in the reference.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

from .hypergraph import Hypergraph
from .hlindex import _Builder

__all__ = ["vtv_query", "ETEIndex", "build_ete", "ThresholdComponentIndex",
           "MSTOracle", "line_graph_edges",
           "brute_force_s_distance", "brute_force_s_reach_k",
           "brute_force_witness", "brute_force_mr_set",
           "brute_force_mr_from_set", "brute_force_top_s"]


# ---------------------------------------------------------------------------
# VTV (incorrect) — kept only to demonstrate the paper's Example 5 pitfall
# ---------------------------------------------------------------------------

def vtv_query(mr_vertex: np.ndarray, u: int, v: int,
              hubs: Optional[np.ndarray] = None) -> int:
    """Best-case VTV 2-hop answer: max_w min(MR(u,w), MR(w,v)) over hub
    vertices.  Even with *perfect* vertex-to-vertex values this
    over-estimates (the two legs may force incompatible hyperedge pairs at
    the hub), which is exactly the paper's Example 5 argument — so any
    realizable VTV index is unsound for MR.
    """
    w = np.arange(mr_vertex.shape[0]) if hubs is None else hubs
    legs = np.minimum(mr_vertex[u, w], mr_vertex[w, v])
    return int(legs.max()) if legs.size else 0


# ---------------------------------------------------------------------------
# ETE index
# ---------------------------------------------------------------------------

class ETEIndex:
    """Hyperedge-to-hyperedge 2-hop labels: Le(e) = [(hub_rank, hub, s)]."""

    def __init__(self, h: Hypergraph, rank: np.ndarray,
                 labels: List[List[Tuple[int, int]]]):
        self.h = h
        self.rank = rank
        self.labels_rank: List[np.ndarray] = []
        self.labels_s: List[np.ndarray] = []
        for e in range(h.m):
            if labels[e]:
                hub = np.array([t[0] for t in labels[e]], np.int64)
                s = np.array([t[1] for t in labels[e]], np.int64)
                r = rank[hub]
                order = np.argsort(r, kind="stable")
                self.labels_rank.append(r[order])
                self.labels_s.append(s[order])
            else:
                self.labels_rank.append(np.empty(0, np.int64))
                self.labels_s.append(np.empty(0, np.int64))

    @property
    def num_labels(self) -> int:
        return int(sum(a.size for a in self.labels_s))

    def nbytes(self) -> int:
        return self.num_labels * 8

    def _merged(self, edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Merge the label lists of a vertex's hyperedges, keeping the max s
        per hub (the paper's merge-sort-based de-duplication)."""
        if edges.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        ranks = np.concatenate([self.labels_rank[int(e)] for e in edges])
        svals = np.concatenate([self.labels_s[int(e)] for e in edges])
        if ranks.size == 0:
            return ranks, svals
        order = np.lexsort((-svals, ranks))
        ranks, svals = ranks[order], svals[order]
        keep = np.ones(ranks.size, bool)
        keep[1:] = ranks[1:] != ranks[:-1]
        return ranks[keep], svals[keep]

    def mr(self, u: int, v: int) -> int:
        ra, sa = self._merged(self.h.edges_of(u))
        rb, sb = self._merged(self.h.edges_of(v))
        i = j = 0
        k = 0
        while i < ra.size and j < rb.size:
            if sa[i] <= k or ra[i] < rb[j]:
                i += 1
            elif sb[j] <= k or ra[i] > rb[j]:
                j += 1
            else:
                k = int(min(sa[i], sb[j]))
                i += 1
                j += 1
        return k


def build_ete(h: Hypergraph) -> ETEIndex:
    """ETE labeling via the same MCD-pruned traversal as Algorithm 3, but
    recording hyperedge-level labels (root, s) for every popped hyperedge."""
    b = _Builder(h)
    rank, sizes = b.rank, b.sizes
    mcd = np.zeros(h.m, np.int64)
    labels: List[List[Tuple[int, int]]] = [[] for _ in range(h.m)]
    for root in [int(x) for x in b.perm]:
        if mcd[root] == sizes[root]:
            continue
        mcd_root = int(mcd[root])
        q: List[Tuple[int, int]] = [(-int(sizes[root]), root)]
        while q:
            neg_s, e_u = heapq.heappop(q)
            s = -neg_s
            if b.visited_e[e_u] == root:
                continue
            b.visited_e[e_u] = root
            if e_u != root and s > mcd[e_u]:
                mcd[e_u] = s
            labels[e_u].append((root, s))
            nb, od = h.neighbors_od(e_u)
            for e_v, w in zip(nb, od):
                e_v, w = int(e_v), int(w)
                if (w > mcd_root and rank[e_v] > rank[root]
                        and b.visited_e[e_v] != root):
                    heapq.heappush(q, (-min(s, w), e_v))
    return ETEIndex(h, rank, labels)


# ---------------------------------------------------------------------------
# HypED-style threshold-component index
# ---------------------------------------------------------------------------

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


class ThresholdComponentIndex:
    """comp[s_idx, e] = component id of hyperedge e in the ≥s line graph.

    Built by one descending Kruskal sweep; MR(u,v) = largest threshold at
    which some pair of incident hyperedges share a component.  Storage
    O(S·m) — the HypED-style blow-up the paper contrasts against.
    """

    def __init__(self, h: Hypergraph, cap: Optional[int] = None):
        self.h = h
        src, dst, od = line_graph_edges(h)
        sizes = h.edge_sizes
        thresholds = np.unique(np.concatenate([od, sizes]))
        thresholds = thresholds[thresholds > 0][::-1]     # descending
        if cap is not None:
            thresholds = thresholds[:cap]
        self.thresholds = thresholds
        order = np.argsort(-od)
        src, dst, od = src[order], dst[order], od[order]
        dsu = _DSU(h.m)
        comp = np.empty((thresholds.size, h.m), np.int32)
        ei = 0
        for ti, t in enumerate(thresholds):
            while ei < od.size and od[ei] >= t:
                dsu.union(int(src[ei]), int(dst[ei]))
                ei += 1
            comp[ti] = [dsu.find(e) for e in range(h.m)]
        self.comp = comp

    def nbytes(self) -> int:
        return self.comp.nbytes

    def mr(self, u: int, v: int) -> int:
        eu = self.h.edges_of(u)
        ev = self.h.edges_of(v)
        if not eu.size or not ev.size:
            return 0
        sizes = self.h.edge_sizes
        for ti, t in enumerate(self.thresholds):
            # same component at threshold t: need both endpoints' hyperedges
            # alive at t (|e| ≥ t — a single-hyperedge walk has WOD |e|;
            # components only merge via OD ≥ t edges which imply |e| ≥ t).
            au = eu[sizes[eu] >= t]
            av = ev[sizes[ev] >= t]
            if au.size and av.size:
                cu = self.comp[ti, au]
                cv = self.comp[ti, av]
                if np.intersect1d(cu, cv).size:
                    return int(t)
        return 0


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

    def rows(self, edges) -> np.ndarray:
        """``edge_mr(e, f)`` for each ``e`` in ``edges`` and every hyperedge
        ``f``, int64 ``[len(edges), m]``: one walk of the forest per row
        where ``edge_mr`` walks once per pair.  ``mr`` pays that walk
        |E(u)|·|E(v)| times a query, a minute on a graph as dense as
        email-Eu; ``rows(E(u))[:, E(v)].max(initial=0)`` is the same MR."""
        sizes = self.h.edge_sizes
        out = np.zeros((len(edges), self.h.m), np.int64)
        for row, e in zip(out, edges):
            e = int(e)
            best = {e: np.iinfo(np.int64).max}
            stack = [e]
            while stack:
                x = stack.pop()
                for y, w in self.adj[x]:
                    if y not in best:
                        best[y] = min(best[x], w)
                        stack.append(y)
            del best[e]
            if best:
                row[np.fromiter(best.keys(), np.int64, len(best))] = \
                    np.fromiter(best.values(), np.int64, len(best))
            row[e] = sizes[e]
        return out


# ---------------------------------------------------------------------------
# Brute-force workload references.  The workload subsystem
# (repro_torch/workloads/) is pinned cell-by-cell against exactly these,
# so they are deliberately *independent* implementations: dense threshold
# sweeps and matrix-frontier expansion here vs the production hub-label /
# bounded-BFS / landmark paths there.
# ---------------------------------------------------------------------------

def brute_force_s_distance(h: Hypergraph, u: int, v: int, s: int) -> int:
    """Exact s-distance (fewest hyperedges in an s-walk; 0 = none) by
    dense boolean frontier expansion on the >= s line graph.  Shortest
    s-walks never repeat a hyperedge — a repeat collapses to a shorter
    walk, and the collapsed single-edge case is always valid because
    od >= s forces |e| >= s — so plain level expansion is exact."""
    m = h.m
    u, v, s = int(u), int(v), int(s)
    if m == 0:
        return 0
    eu = h.edges_of(u)
    ev = h.edges_of(v)
    if eu.size == 0 or ev.size == 0:
        return 0
    fu = np.zeros(m, bool)
    fu[eu] = True
    fv = np.zeros(m, bool)
    fv[ev] = True
    if bool((fu & fv & (h.edge_sizes >= s)).any()):
        return 1
    src, dst, od = line_graph_edges(h)
    keep = od >= s
    adj = np.zeros((m, m), bool)
    adj[src[keep], dst[keep]] = True
    adj |= adj.T
    reach = fu.copy()
    frontier = fu.copy()
    for t in range(2, m + 1):
        frontier = adj[frontier].any(axis=0) & ~reach
        if not frontier.any():
            return 0
        if bool((frontier & fv).any()):
            return t
        reach |= frontier
    return 0


def brute_force_s_reach_k(h: Hypergraph, u: int, v: int, s: int,
                          k: int) -> bool:
    """Hop-bounded s-reach: an s-walk of at most ``k`` hyperedges."""
    d = brute_force_s_distance(h, u, v, s)
    return 0 < d <= int(k)


def brute_force_witness(h: Hypergraph, u: int, v: int,
                        ) -> Tuple[int, Tuple[int, ...]]:
    """(MR(u, v), witness walk): descending threshold sweep to find the
    largest reachable s, then a parent-tracked BFS on the >= s line
    graph to recover one walk achieving it."""
    u, v = int(u), int(v)
    sizes = h.edge_sizes
    smax = int(sizes.max()) if h.m else 0
    k = 0
    for s in range(smax, 0, -1):
        if brute_force_s_distance(h, u, v, s) > 0:
            k = s
            break
    if k == 0:
        return 0, ()
    eu = sorted(int(e) for e in h.edges_of(u))
    ev_set = {int(e) for e in h.edges_of(v)}
    shared = [e for e in eu if e in ev_set and int(sizes[e]) >= k]
    if shared:
        return k, (shared[0],)
    parent = {e: -1 for e in eu}
    queue = list(eu)
    while queue:
        e = queue.pop(0)
        nbrs, ods = h.neighbors_od(e)
        for nb, w in zip(nbrs, ods):
            nb = int(nb)
            if int(w) >= k and nb not in parent:
                parent[nb] = e
                queue.append(nb)

    def backtrack(e: int) -> Tuple[int, ...]:
        out = [e]
        while parent[out[-1]] != -1:
            out.append(parent[out[-1]])
        return tuple(reversed(out))

    eu_set = set(eu)
    for t in sorted(ev_set):
        if t in parent and t not in eu_set:
            return k, backtrack(t)
    # remaining case: every reachable target is also an undersized seed
    # — the walk must *end* on a fresh edge adjacent to the tree
    for a in sorted(parent):
        nbrs, ods = h.neighbors_od(a)
        for nb, w in zip(nbrs, ods):
            if int(w) >= k and int(nb) in ev_set:
                return k, backtrack(a) + (int(nb),)
    raise AssertionError(
        f"threshold sweep said MR({u}, {v}) = {k} but no walk was found")


def brute_force_mr_set(h: Hypergraph, us, vs) -> int:
    """Set-to-set MR: max over the cross product, one oracle pair at a
    time."""
    oracle = MSTOracle(h)
    return max((oracle.mr(int(a), int(b)) for a in us for b in vs),
               default=0)


def brute_force_mr_from_set(h: Hypergraph, us, targets) -> np.ndarray:
    """Multi-source MR: per target, the best MR from any source."""
    oracle = MSTOracle(h)
    return np.array([max((oracle.mr(int(a), int(t)) for a in us),
                         default=0) for t in targets], np.int64)


def brute_force_top_s(h: Hypergraph, u: int, k: int,
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k strongest-s: every MR(u, .) via the oracle, ranked by
    (MR desc, vertex id asc), zeros and ``u`` itself dropped."""
    u = int(u)
    oracle = MSTOracle(h)
    scored = sorted((-oracle.mr(u, v), v) for v in range(h.n) if v != u)
    picked = [(v, -neg) for neg, v in scored if neg < 0][:int(k)]
    verts = np.array([v for v, _ in picked], np.int64)
    vals = np.array([s for _, s in picked], np.int64)
    return verts, vals
