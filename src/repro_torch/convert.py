"""State carried across from the reference package.

Functions that take the reference's state as plain numpy arrays and give
this package's objects, so an index or a snapshot built by one stack can
be served by the other, and an LM's parameters drawn by one run in the
other.  Nothing of the reference is imported here: a
caller pulls the arrays out of its objects with ``np.asarray`` and hands
them in.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

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
           "threshold_index_from_arrays", "lm_layers_from_params",
           "lm_state_dict_from_params", "nest_layers",
           "lm_params_from_state_dict", "host_copy", "STACKED"]


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


# the reference's parameter trees stack these groups of layers on a leading
# axis (``lax.scan`` over layers); the port keeps one module per layer
STACKED = ("blocks", "groups", "enc_blocks", "dec_blocks")


def lm_layers_from_params(params: Mapping) -> Dict[str, np.ndarray]:
    """The reference's parameter pytree (nested dicts and lists of
    ``np.asarray``-able leaves) as flat ``state_dict``-style keys joined
    with ``.``, numpy arrays in their own dtypes (views of the given
    arrays where they are numpy already: nothing is copied).  Every leaf
    under a ``STACKED`` group carries the reference's layer axis
    ``[L, ...]`` and is split into ``<group>.<i>.`` entries, one per
    layer; a list (the hybrid's ``tail``) is walked by index."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + (str(key),))
            return
        if isinstance(node, list):
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
            return
        arr = np.asarray(node)
        if path[0] in STACKED:
            for i, layer in enumerate(arr):
                out[".".join((path[0], str(i)) + path[1:])] = \
                    np.ascontiguousarray(layer)
        else:
            out[".".join(path)] = arr

    walk(params, ())
    return out


def lm_state_dict_from_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """A model's ``state_dict`` (any family of ``repro_torch.models``) from
    the reference's parameter pytree: ``lm_layers_from_params`` as float32
    tensors on the CPU; ``model.load_state_dict`` lands them on the
    model's device."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))  # a copy
            for k, v in lm_layers_from_params(params).items()}


def host_copy(leaf) -> np.ndarray:
    """A host copy of ``leaf``: a tensor (any device, bf16 as float32) or
    an array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def nest_layers(flat: Mapping[str, object], stack=np.stack) -> Dict:
    """Inverse of ``lm_layers_from_params`` on any leaves: ``.``-joined
    keys become nested dicts, ``<group>.<i>.`` entries of a ``STACKED``
    group are joined with ``stack`` (a list of the layers' leaves, in
    layer order), and a dict whose keys are exactly 0..n-1 becomes a
    list (the hybrid's ``tail``)."""
    tree: Dict = {}
    stacks: Dict[Tuple[str, ...], Dict[int, object]] = {}
    for key, leaf in flat.items():
        parts = key.split(".")
        if parts[0] in STACKED:
            path = (parts[0],) + tuple(parts[2:])
            stacks.setdefault(path, {})[int(parts[1])] = leaf
        else:
            _put(tree, parts, leaf)
    for path, layers in stacks.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"layers of {'.'.join(path)} are not 0.."
                             f"{len(layers) - 1}: {sorted(layers)}")
        _put(tree, list(path), stack([layers[i]
                                      for i in range(len(layers))]))
    return _lists(tree)


def _put(tree: Dict, parts, leaf) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = leaf


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == [str(i) for i in range(len(node))] \
            and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def _stack_to_host(leaves):
    if isinstance(leaves[0], torch.Tensor):
        # one stack on the tensors' device, then one host copy
        return host_copy(torch.stack([t.detach() for t in leaves]))
    return np.stack([np.asarray(x) for x in leaves])


def lm_params_from_state_dict(state_dict: Mapping[str, object],
                              specs: Optional[Mapping] = None) -> Dict:
    """The reference's parameter pytree from a model's ``state_dict`` (or
    any mapping of those keys to tensors or arrays, on any device): host
    numpy copies in their own dtypes (bf16 as float32), stacked on the
    layer axis, the hybrid's ``tail`` a list.  A hybrid without trailing
    blocks has no ``tail`` entry to nest; pass its ``param_specs()`` as
    ``specs`` to get the reference's empty list.  Inverse of
    ``lm_state_dict_from_params``; the reference's ``model.apply`` takes
    the result as its ``params``."""
    tree = nest_layers({k: v if k.split(".")[0] in STACKED else host_copy(v)
                        for k, v in state_dict.items()},
                       stack=_stack_to_host)
    for key, value in (specs or {}).items():
        if value == [] and key not in tree:
            tree[key] = []
    return tree
