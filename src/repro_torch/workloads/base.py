"""Shared workload types: the op registry, the ``Witness`` answer
shape, and the s-walk validity checker.

The workload subsystem answers five query families on top of the
engine protocol (see docs/ARCHITECTURE.md "Workloads"):

  witness     MR answers that return the actual hyperedge walk
  s_reach_k   hop-bounded s-reachability (at most k hyperedges)
  mr_set      set-to-set / multi-source MR reductions
  top_s       top-k strongest-s ranking per source vertex
  s_distance  landmark s-distance oracle (certified upper bounds)

Every op is gated per backend through ``workload_capability`` on the
engine class; asking an incapable backend raises
``WorkloadUnsupported`` — loud and typed, never a silent fallback.
The gate, the op tuple (``WORKLOAD_OPS``) and the exception live with
the registry in ``repro_torch.core.engine`` (re-exported from
``repro_torch.workloads``); this module holds the graph-level answer
shapes the engine layer lazily imports, keeping the dependency one-way.

Counterpart of ``repro/workloads/base.py``: the same host code, so a
``Witness`` and its checks are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Tuple

if TYPE_CHECKING:                      # annotation-only; no runtime import
    from ..core.hypergraph import Hypergraph

__all__ = ["Witness", "walk_wod", "verify_witness"]


@dataclasses.dataclass(frozen=True)
class Witness:
    """An MR answer plus its certificate: the hyperedge walk achieving
    it.  ``s == MR(u, v)``; ``walk`` is a sequence of hyperedge ids with
    ``u`` in the first edge, ``v`` in the last, and walk-overlap-degree
    exactly ``s`` (empty iff ``s == 0``).  ``verify_witness`` checks all
    of that from the hypergraph alone."""

    u: int
    v: int
    s: int
    walk: Tuple[int, ...]


def walk_wod(h: Hypergraph, walk) -> int:
    """Walk overlap degree: min consecutive hyperedge overlap, or the
    hyperedge size for a single-edge walk (Sec. II — a one-edge walk
    joins every pair inside that edge at s = |e|).  0 for an empty
    walk."""
    walk = [int(e) for e in walk]
    if not walk:
        return 0
    for e in walk:
        if not 0 <= e < h.m:
            raise IndexError(f"hyperedge id {e} out of range [0, {h.m})")
    if len(walk) == 1:
        return int(h.edge_size(walk[0]))
    return min(h.overlap(a, b) for a, b in zip(walk, walk[1:]))


def verify_witness(h: Hypergraph, w: Witness) -> bool:
    """True iff ``w`` is internally consistent: an unreachable answer
    carries no walk, and a reachable one carries a valid s-walk from
    ``u`` to ``v`` whose overlap degree equals the reported ``s``."""
    if w.s < 0:
        return False
    if w.s == 0:
        return len(w.walk) == 0
    if not w.walk:
        return False
    first, last = int(w.walk[0]), int(w.walk[-1])
    if int(w.u) not in map(int, h.edge(first)):
        return False
    if int(w.v) not in map(int, h.edge(last)):
        return False
    return walk_wod(h, w.walk) == int(w.s)
