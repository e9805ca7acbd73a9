"""Algorithm 4 — minimal HL-index generation.

Removes redundant labels from a complete HL-index: a label ``(e, s_u)`` of
``u`` is redundant iff for every vertex ``v`` reachable through hub ``e``
(the dual set ``D(e)``) some other hyperedge ``e'`` supports
``u ~> e ~> v`` with ``min(s'_u, s'_v) ≥ min(s_u, s_v)``.

Faithful structures: dual ``D``, inverted set ``I`` (Observation 1 filter),
non-redundant set ``NR`` (Lemma 7 co-marking), verification in
non-ascending ``s`` order.  Interpretation notes:

* ``NR`` tracks *unprocessed* vertices only; line 20's early exit fires
  when every remaining unverified entry is already marked, and line 21
  then keeps exactly those (processed survivors were kept at line 15).
* removals mutate ``L``/``D`` in place so later verifications (and later
  roots) see the shrunken index, matching the "iteratively identify and
  remove one at a time" semantics.

``exact_minimize`` is a beyond-paper post-pass that enforces *exact*
necessity by trial removal + query re-check; used by tests to measure how
close Algorithm 4 gets (see EXPERIMENTS.md §Minimality).
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

from .hlindex import HLIndex

__all__ = ["minimize", "exact_minimize"]


def _rebuild(idx: HLIndex, L: List[Dict[int, int]]) -> HLIndex:
    """Repack dict-of-dicts labels into a fresh HLIndex (rank-sorted)."""
    h, rank = idx.h, idx.rank
    le, lr, ls = [], [], []
    dual: List[List[Tuple[int, int]]] = [[] for _ in range(h.m)]
    for u in range(h.n):
        if L[u]:
            e = np.fromiter(L[u].keys(), np.int64, len(L[u]))
            s = np.fromiter(L[u].values(), np.int64, len(L[u]))
            order = np.argsort(rank[e], kind="stable")
            e, s = e[order], s[order]
        else:
            e = np.empty(0, np.int64)
            s = np.empty(0, np.int64)
        le.append(e)
        lr.append(rank[e] if e.size else np.empty(0, np.int64))
        ls.append(s)
        for ee, ss in zip(e, s):
            dual[int(ee)].append((u, int(ss)))
    du, ds = [], []
    for e in range(h.m):
        pairs = sorted(dual[e], key=lambda t: -t[1])
        du.append(np.array([p[0] for p in pairs], np.int64))
        ds.append(np.array([p[1] for p in pairs], np.int64))
    return HLIndex(h=h, rank=idx.rank, perm=idx.perm, labels_edge=le,
                   labels_rank=lr, labels_s=ls, dual_u=du, dual_s=ds,
                   stats=dict(idx.stats))


def minimize(idx: HLIndex) -> HLIndex:
    """Algorithm 4: produce a minimal HL-index L* from a complete one."""
    h = idx.h
    # L as dict-of-dicts (mutated in place), D as per-edge ordered entries
    L: List[Dict[int, int]] = [dict(zip(map(int, idx.labels_edge[u]),
                                        map(int, idx.labels_s[u])))
                               for u in range(h.n)]
    D: List[List[Tuple[int, int]]] = []
    for e in range(h.m):
        pairs = sorted(zip(map(int, idx.dual_u[e]), map(int, idx.dual_s[e])),
                       key=lambda t: -t[1])          # non-ascending s
        D.append(pairs)

    for root in [int(x) for x in idx.perm]:          # descending importance
        entries = D[root]
        if not entries:
            continue
        # lines 3-6: the paper's inverted set I over potential supporting
        # hubs (named `inv` here; `I` is an ambiguous identifier)
        inv: Dict[int, List[Tuple[int, int]]] = {}
        for v, s_v in entries:
            for e2, s2 in L[v].items():
                if e2 != root and s2 >= s_v:
                    inv.setdefault(e2, []).append((v, s_v))
        alive: Dict[int, int] = dict(entries)        # current V(D(root))
        NR: Set[int] = set()                         # unprocessed, pre-marked
        processed: Set[int] = set()
        for pos, (u, s_u) in enumerate(entries):     # line 7 (non-ascending s)
            pre_marked = u in NR
            NR.discard(u)
            # lines 9-13: support set S — computed even for pre-marked u,
            # since line 16's co-marking of unprocessed partners needs it
            # (a pair (u, w) supported only by `root` pins *both* labels).
            S: Set[int] = set()
            target = len(alive)
            complete = False
            for e2, s2u in L[u].items():
                if e2 == root:
                    continue
                for v, s_v in inv.get(e2, ()):
                    if v not in alive or s2u < s_v:
                        continue
                    S.add(v)
                    if len(S) == target:
                        complete = True
                        break
                if complete:
                    break
            processed.add(u)
            if not complete or pre_marked:           # line 14: keep
                for w in alive:                      # line 16
                    if w not in S and w not in processed:
                        NR.add(w)
            else:                                    # lines 18-19: remove
                del L[u][root]
                del alive[u]
            # line 20: all remaining unverified entries already marked
            remaining = [w for w, _ in entries[pos + 1:] if w in alive]
            if remaining and all(w in NR for w in remaining):
                break                                # line 21: keep them as-is
        D[root] = [(u, s) for u, s in entries if u in alive]
    return _rebuild(idx, L)


def exact_minimize(idx: HLIndex) -> HLIndex:
    """Beyond-paper exact-necessity post-pass: for every label, trial-remove
    and keep it only if some MR(u, v) over the hub's dual set changes.
    O(l · θ · l_v) — for tests/benchmarks, not the production path.
    """
    from .query import mr_query_dicts

    h = idx.h
    L: List[Dict[int, int]] = [dict(zip(map(int, idx.labels_edge[u]),
                                        map(int, idx.labels_s[u])))
                               for u in range(h.n)]
    rank = idx.rank
    # hub -> [(u, s)] view, kept in sync
    D: List[Dict[int, int]] = [dict() for _ in range(h.m)]
    for u in range(h.n):
        for e, s in L[u].items():
            D[e][u] = s
    for root in [int(x) for x in idx.perm]:
        for u, s_u in sorted(D[root].items(), key=lambda t: -t[1]):
            if root not in L[u]:
                continue
            del L[u][root]
            needed = False
            for v, s_v in D[root].items():
                if v == u or root not in L[v]:
                    continue
                if mr_query_dicts(L[u], L[v], rank) < min(s_u, s_v):
                    needed = True
                    break
            if needed:
                L[u][root] = s_u
            else:
                del D[root][u]
    return _rebuild(idx, L)
