"""State carried across from the reference package.

Functions that take the reference's state as plain numpy arrays and give
this package's objects, so an index or a snapshot built by one stack can
be served by the other, and an LM's parameters drawn by one run in the
other.  Nothing of the reference is imported here: a
caller pulls the arrays out of its objects with ``np.asarray`` and hands
them in.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .core.baselines import ETEIndex, ThresholdComponentIndex
from .core.engine import ClosureEngine
from .core.frontier import SparseLineGraph
from .core.hlindex import HLIndex
from .core.hypergraph import Hypergraph
from .core.query import DeviceSnapshot
from .device import DeviceLike

__all__ = ["hypergraph_from_arrays", "hlindex_from_arrays",
           "snapshot_from_arrays", "closure_engine_from_arrays",
           "ete_index_from_arrays", "line_graph_from_arrays",
           "threshold_index_from_arrays", "lm_state_dict_from_params"]


def _int64(a) -> np.ndarray:
    return np.array(a, dtype=np.int64)          # always a copy


def hypergraph_from_arrays(n: int, e_ptr, e_idx, v_ptr, v_idx) -> Hypergraph:
    """A ``Hypergraph`` from its dual-CSR arrays (edge -> vertices and
    vertex -> edges), checked for consistent sizes."""
    e_ptr, e_idx = _int64(e_ptr), _int64(e_idx)
    v_ptr, v_idx = _int64(v_ptr), _int64(v_idx)
    m = int(e_ptr.size - 1)
    if m < 0 or v_ptr.size != int(n) + 1:
        raise ValueError(
            f"CSR offsets do not match n={n}: e_ptr has {e_ptr.size} "
            f"entries, v_ptr has {v_ptr.size}")
    if e_idx.size != v_idx.size or e_idx.size != int(e_ptr[-1]) \
            or v_idx.size != int(v_ptr[-1]):
        raise ValueError("CSR index arrays do not match their offsets")
    return Hypergraph(n=int(n), m=m, e_ptr=e_ptr, e_idx=e_idx,
                      v_ptr=v_ptr, v_idx=v_idx)


def hlindex_from_arrays(h: Hypergraph, rank, perm,
                        labels_edge: Sequence, labels_rank: Sequence,
                        labels_s: Sequence, dual_u: Sequence,
                        dual_s: Sequence,
                        stats: Optional[Dict[str, float]] = None) -> HLIndex:
    """An ``HLIndex`` over ``h`` from per-vertex label rows and
    per-hyperedge dual rows (lists of arrays, as the reference keeps
    them)."""
    if not (len(labels_edge) == len(labels_rank) == len(labels_s) == h.n):
        raise ValueError(f"need one label row per vertex (n={h.n})")
    if not (len(dual_u) == len(dual_s) == h.m):
        raise ValueError(f"need one dual row per hyperedge (m={h.m})")
    return HLIndex(h=h, rank=_int64(rank), perm=_int64(perm),
                   labels_edge=[_int64(a) for a in labels_edge],
                   labels_rank=[_int64(a) for a in labels_rank],
                   labels_s=[_int64(a) for a in labels_s],
                   dual_u=[_int64(a) for a in dual_u],
                   dual_s=[_int64(a) for a in dual_s],
                   stats=dict(stats or {}))


def snapshot_from_arrays(ranks, svals, lengths, backend: str = "hl-index",
                         version: int = 0, *,
                         device: DeviceLike = None) -> DeviceSnapshot:
    """A ``DeviceSnapshot`` from padded label arrays (``ranks`` /
    ``svals`` [n, Lmax], ``lengths`` [n]) landed on ``device``
    (``None`` = ``"cuda"``)."""
    ranks, svals = np.asarray(ranks), np.asarray(svals)
    lengths = np.asarray(lengths)
    if ranks.ndim != 2 or ranks.shape != svals.shape \
            or lengths.shape != (ranks.shape[0],):
        raise ValueError(
            f"padded label arrays disagree: ranks{ranks.shape} "
            f"svals{svals.shape} lengths{lengths.shape}")
    return DeviceSnapshot.from_padded(ranks, svals, lengths, backend,
                                      int(version), device=device)


def closure_engine_from_arrays(h: Hypergraph, w_star, method: str = "maxmin",
                               device: DeviceLike = None) -> ClosureEngine:
    """A ``closure`` engine over ``h`` serving a ``W*`` [m, m] computed
    elsewhere (the reference's ``ClosureEngine.w_star``), copied as int32;
    its snapshot lands on ``device`` (``None`` = ``"cuda"``)."""
    w_star = np.array(w_star, dtype=np.int32)          # always a copy
    if w_star.shape != (h.m, h.m):
        raise ValueError(f"W* has shape {w_star.shape}, the graph needs "
                         f"({h.m}, {h.m})")
    return ClosureEngine(h, w_star, method, device=device)


def ete_index_from_arrays(h: Hypergraph, rank, labels_rank: Sequence,
                          labels_s: Sequence) -> ETEIndex:
    """An ``ETEIndex`` over ``h`` from its per-hyperedge label rows (hub
    ranks ascending, and their s values), as the reference keeps them."""
    if not (len(labels_rank) == len(labels_s) == h.m):
        raise ValueError(f"need one label row per hyperedge (m={h.m})")
    idx = ETEIndex(h, _int64(rank), [[] for _ in range(h.m)])
    idx.labels_rank = [_int64(a) for a in labels_rank]
    idx.labels_s = [_int64(a) for a in labels_s]
    return idx


def line_graph_from_arrays(h: Hypergraph, src, dst, od, *,
                           device: DeviceLike = None) -> SparseLineGraph:
    """A ``SparseLineGraph`` over ``h`` from the host COO half-list the
    reference keeps (``SparseLineGraph._coo``: ``src < dst`` pairs and
    their overlap degrees), landed on ``device`` (``None`` = ``"cuda"``)."""
    src, dst, od = _int64(src), _int64(dst), _int64(od)
    if not src.shape == dst.shape == od.shape or src.ndim != 1:
        raise ValueError(f"COO arrays disagree: src{src.shape} "
                         f"dst{dst.shape} od{od.shape}")
    return SparseLineGraph(h, _coo=(src, dst, od), device=device)


def threshold_index_from_arrays(h: Hypergraph, comp,
                                thresholds) -> ThresholdComponentIndex:
    """A ``ThresholdComponentIndex`` over ``h`` from its component table
    (``comp`` [S, m], int32) and descending ``thresholds`` [S]."""
    comp = np.array(comp, dtype=np.int32)
    thresholds = _int64(thresholds)
    if comp.ndim != 2 or comp.shape != (thresholds.size, h.m):
        raise ValueError(f"comp has shape {comp.shape}, the graph and "
                         f"thresholds need ({thresholds.size}, {h.m})")
    tci = ThresholdComponentIndex.__new__(ThresholdComponentIndex)
    tci.h, tci.thresholds, tci.comp = h, thresholds, comp
    return tci


def lm_state_dict_from_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """A ``TransformerLM`` ``state_dict`` from the reference's parameter
    pytree (nested dicts of arrays, ``np.asarray``-able).  Key paths join
    with ``.``; every leaf under ``blocks`` carries the reference's
    stacked layer axis ``[L, ...]`` and is split into ``blocks.<i>.``
    entries, one per layer.  The tensors are float32 copies on the CPU;
    ``model.load_state_dict`` lands them on the model's device."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + (str(key),))
            return
        arr = np.array(node, dtype=np.float32)          # always a copy
        if path[0] == "blocks":
            for i, layer in enumerate(arr):
                out[".".join(("blocks", str(i)) + path[1:])] = \
                    torch.from_numpy(np.ascontiguousarray(layer))
        else:
            out[".".join(path)] = torch.from_numpy(arr)

    walk(params, ())
    return out
