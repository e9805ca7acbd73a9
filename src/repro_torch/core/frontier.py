"""Sparse frontier engine: batched s-reachability / MR on the line graph,
the index-free batch path for graphs past the label budget.

The dense (max,min)/threshold closures (``semiring.py``) cost O(m²)
memory; past a few tens of thousands of hyperedges the line graph no
longer fits dense.  This engine keeps the line graph *sparse* (an edge
list with overlap degrees, on the device) and answers batched queries
with data-parallel frontier sweeps:

  * ``frontier_batched_s_reach``: [Q] query pairs × one threshold s —
    0/1 frontier propagation, one gather and one scatter-max per round,
    O(rounds · E) work on [m, Q] lanes.
  * ``frontier_batched_mr``: binary search over the threshold ladder —
    one sweep per distinct mid threshold per step.

Counterpart of ``repro/core/frontier.py``, same names in the same order.
The reference's sweep is a jitted scatter-max under ``lax.scan`` (no
Pallas kernel); here it is the same scatter-max in PyTorch tensor ops
(``index_select`` + ``index_reduce`` with ``"amax"``), laid out for one
card:

* **Hyperedges first.** The frontier is ``reach [m, Q]`` uint8, so each
  round gathers whole rows by the 1-D ``src`` vector and scatters them by
  the 1-D ``dst`` vector; no index is ever expanded to ``[E, Q]``.
* **Dead edges dropped once per sweep.** Line-graph edges with overlap
  below ``s`` never carry a bit, so they are filtered out before the
  rounds; the answers do not change.
* **Queries chunked.** One round's temporary is ``[alive edges, Qc]``
  bytes; ``Qc`` is chosen so that it stays within ``ROUND_BYTES``.
* **Rounds stop at the fixpoint.** A round only adds bits, so a round
  that adds none ends the sweep with the bits a full scan would give.
  The fixpoint is read back once per round (one ``torch.equal``, one
  synchronisation).  ``rounds`` (default ``m``, as in the reference)
  stays an exact upper bound: a bounded sweep stops there.

Seeds are built on the device from the vertex -> hyperedge CSR
(``v_ptr`` / ``v_idx``), copied to the device once per line graph.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, host_to_device, resolve_device
from .baselines import line_graph_edges
from .hypergraph import Hypergraph

__all__ = ["SparseLineGraph", "frontier_batched_s_reach",
           "frontier_batched_mr", "ROUND_BYTES"]

# budget of one round's temporary, the gathered [alive edges, Qc] uint8
# rows: queries are chunked so that it stays within this
ROUND_BYTES = 4 * 2**30


def _int32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


class SparseLineGraph:
    """Symmetrized line-graph edge list on the device.

    ``src`` / ``dst`` / ``od`` (directed edges, both directions) and
    ``sizes`` are int32 tensors on ``device`` (``None`` = ``"cuda"``);
    ``thresholds`` (the ascending ladder of distinct positive overlap
    degrees and edge sizes) stays numpy.  The unsymmetrized host COO
    half-list is kept (``_coo``) so hyperedge updates can patch the
    structure incrementally (``updated``) instead of re-walking every
    neighborhood.
    """

    def __init__(self, h: Hypergraph,
                 _coo: Optional[Tuple[np.ndarray, np.ndarray,
                                      np.ndarray]] = None,
                 *, device: DeviceLike = None):
        src, dst, od = line_graph_edges(h) if _coo is None else _coo
        self.h = h
        self.device = dev = resolve_device(device)
        self._coo = (src, dst, od)
        self.src = torch.from_numpy(_int32(np.concatenate([src, dst]))).to(dev)
        self.dst = torch.from_numpy(_int32(np.concatenate([dst, src]))).to(dev)
        self.od = torch.from_numpy(_int32(np.concatenate([od, od]))).to(dev)
        self.sizes = torch.from_numpy(_int32(h.edge_sizes)).to(dev)
        self.thresholds = np.unique(np.concatenate(
            [np.asarray(od), np.asarray(h.edge_sizes)]))
        self.thresholds = self.thresholds[self.thresholds > 0]
        # vertex -> hyperedge CSR for seeding on the device (a restored
        # graph's CSR is a read-only checkpoint view: copied, not shared)
        self._v_ptr = host_to_device(np.asarray(h.v_ptr, np.int64), dev)
        self._v_idx = host_to_device(np.asarray(h.v_idx, np.int64), dev)

    def updated(self, new_h: Hypergraph, old_to_new: np.ndarray,
                touched) -> "SparseLineGraph":
        """Line graph of the edited hypergraph, patched incrementally:
        pairs with both endpoints outside ``touched`` (new ids — see
        ``apply_edge_edits``) are kept with ids remapped; overlaps are
        recomputed only for the 1-hop touched set.  Overlap degrees of
        untouched pairs cannot have changed (both endpoint vertex sets
        are unchanged), so the splice is exact.  The host half-list is
        spliced exactly as the reference splices it; the device tensors
        are then landed from it whole."""
        src, dst, od = self._coo
        if new_h.m == 0:                # graph emptied: no line graph left
            empty = np.empty(0, np.int64)
            return SparseLineGraph(new_h, _coo=(empty, empty, empty),
                                   device=self.device)
        s2 = old_to_new[src] if src.size else src
        d2 = old_to_new[dst] if dst.size else dst
        touched_mask = np.zeros(new_h.m, bool)
        touched_mask[np.asarray(touched, np.int64)] = True
        keep = (s2 >= 0) & (d2 >= 0)
        keep &= ~(touched_mask[np.clip(s2, 0, None)]
                  | touched_mask[np.clip(d2, 0, None)])
        srcs, dsts, ods = [s2[keep]], [d2[keep]], [od[keep]]
        for t in np.asarray(touched, np.int64):
            t = int(t)
            nb, w = new_h.neighbors_od(t)
            # pair (t, x): untouched x is only generated from t's side;
            # touched x is generated from both — keep the t < x copy
            sel = (~touched_mask[nb]) | (nb > t)
            srcs.append(np.full(int(sel.sum()), t, np.int64))
            dsts.append(nb[sel])
            ods.append(w[sel])
        return SparseLineGraph(new_h, _coo=(np.concatenate(srcs),
                                            np.concatenate(dsts),
                                            np.concatenate(ods)),
                               device=self.device)

    def _seed_columns(self, vertices) -> torch.Tensor:
        """[m, Q] uint8 on the device: column q marks the hyperedges
        incident to ``vertices[q]``.  Ids outside [0, n) raise
        ``IndexError`` on the host, before anything is indexed."""
        ids = np.asarray(vertices, np.int64).reshape(-1)
        n, m, dev = self.h.n, self.h.m, self.device
        if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= n):
            bad = int(ids.min()) if int(ids.min()) < 0 else int(ids.max())
            raise IndexError(f"seed vertex id {bad} out of range [0, {n})")
        q = ids.size
        out = torch.zeros((m, q), dtype=torch.uint8, device=dev)
        if q == 0 or m == 0:
            return out
        ids = torch.from_numpy(ids).to(dev)
        start = self._v_ptr[ids]
        deg = self._v_ptr[ids + 1] - start
        cols = torch.repeat_interleave(torch.arange(q, device=dev), deg)
        first = torch.cumsum(deg, 0) - deg       # first slot of each column
        slot = torch.arange(cols.numel(), device=dev) - first[cols]
        out[self._v_idx[start[cols] + slot], cols] = 1
        return out

    def seed(self, vertices) -> torch.Tensor:
        """[Q, m] bool on the device: hyperedges incident to each query
        vertex (the reference's ``seed`` layout)."""
        return self._seed_columns(vertices).T.contiguous().bool()


def _scatter_max(reach: torch.Tensor, dst: torch.Tensor,
                 contrib: torch.Tensor) -> torch.Tensor:
    """``reach`` with row ``dst[i]`` max-folded with ``contrib[i]``, out
    of place (torch marks ``index_reduce`` as beta; its one-time warning
    says nothing about this use)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"index_reduce\(\) is in beta")
        return reach.index_reduce(0, dst, contrib, "amax")


def _sweep(g: SparseLineGraph, src: torch.Tensor, dst: torch.Tensor,
           us: np.ndarray, vs: np.ndarray, s: int, rounds: int
           ) -> Tuple[torch.Tensor, int]:
    """[Q] bool on the device: does any ≥s walk of at most ``rounds``
    line-graph steps join a u-seed edge to a v-seed edge; and the rounds
    run (the last one found nothing new, unless ``rounds`` ran out)."""
    alive_node = (g.sizes >= s).to(torch.uint8).unsqueeze(1)
    reach = g._seed_columns(us) & alive_node           # [m, Q]
    run = 0
    while run < rounds:
        contrib = reach.index_select(0, src)           # [alive edges, Q]
        new = _scatter_max(reach, dst, contrib)
        del contrib
        run += 1
        if torch.equal(new, reach):                    # fixpoint
            break
        reach = new
    hit = reach & g._seed_columns(vs) & alive_node
    return hit.any(dim=0).bool(), run          # any() of uint8 is uint8


def frontier_batched_s_reach(g: SparseLineGraph, us, vs, s: int,
                             rounds: Optional[int] = None, *,
                             log: Optional[List[Dict]] = None
                             ) -> np.ndarray:
    """u ~s~> v for each query pair (boolean [Q], on the host).

    ``rounds`` bounds the line-graph steps (``None`` = m, exact).  With
    ``log`` (a list), one record per sweep is appended: ``s``, queries,
    alive directed edges, the round cap, the rounds run per query chunk,
    the chunk width, and the sweep's milliseconds on the host clock (the
    answers' copy to the host ends it, so the device work is inside)."""
    t0 = time.perf_counter()
    r = rounds if rounds is not None else g.h.m
    r = min(r, g.h.m)
    us = np.asarray(us, np.int64).reshape(-1)
    vs = np.asarray(vs, np.int64).reshape(-1)
    # the directed edges with overlap >= s: the only ones that carry a bit
    alive = g.od >= int(s)
    src, dst = g.src[alive].long(), g.dst[alive].long()
    width = max(1, min(us.size, ROUND_BYTES // max(src.numel(), 1)))
    answers, runs = [], []
    for a in range(0, us.size, width):
        ok, run = _sweep(g, src, dst, us[a:a + width], vs[a:a + width],
                         int(s), r)
        answers.append(ok)
        runs.append(run)
    out = (torch.cat(answers).cpu().numpy() if answers
           else np.zeros(0, bool))
    if log is not None:
        log.append({"s": int(s), "queries": int(us.size),
                    "alive_edges": int(src.numel()), "rounds_cap": int(r),
                    "rounds": runs, "chunk_queries": int(width),
                    "ms": (time.perf_counter() - t0) * 1e3})
    return out


def frontier_batched_mr(g: SparseLineGraph, us, vs,
                        rounds: Optional[int] = None, *,
                        log: Optional[List[Dict]] = None) -> np.ndarray:
    """MR(u, v) per query pair via bisection over the threshold ladder
    (int64 [Q]).  ``log`` collects one record per sweep, as in
    ``frontier_batched_s_reach``."""
    thr = g.thresholds
    q = len(us)
    ok0 = frontier_batched_s_reach(g, us, vs, int(thr[0]), rounds, log=log) \
        if thr.size else np.zeros(q, bool)
    # lo/hi are ladder indices; answer = thr[best] where reachable
    best = np.full(q, -1, np.int64)
    best[ok0] = 0
    lo_i = np.zeros(q, np.int64)
    hi_i = np.full(q, thr.size - 1, np.int64)
    active = ok0.copy()
    # per-query bisection, batched: all active queries test their own mid
    # threshold — grouped by distinct mid value per iteration
    for _ in range(int(np.ceil(np.log2(max(thr.size, 2)))) + 1):
        if not active.any():
            break
        mids = (lo_i + hi_i + 1) // 2
        for t_idx in np.unique(mids[active]):
            sel = active & (mids == t_idx)
            if not sel.any():
                continue
            ok = frontier_batched_s_reach(g, np.asarray(us)[sel],
                                          np.asarray(vs)[sel],
                                          int(thr[t_idx]), rounds, log=log)
            idx = np.nonzero(sel)[0]
            reach_idx = idx[ok]
            fail_idx = idx[~ok]
            lo_i[reach_idx] = mids[reach_idx]
            best[reach_idx] = mids[reach_idx]
            hi_i[fail_idx] = mids[fail_idx] - 1
        done = lo_i >= hi_i
        active &= ~done
    out = np.zeros(q, np.int64)
    mask = best >= 0
    out[mask] = thr[best[mask]]
    return out
