"""(max, min)-semiring formulation of max-reachability — the dense closure
path, and the oracle for the tests.

Key identity: with ``W[i,j] = OD(e_i, e_j)`` (diagonal ``|e_i|``), the
hyperedge-level max-reachability matrix is the bottleneck-path closure
``W*`` under the (max, min) semiring, and

    MR(u, v) = max_{e_u ∋ u, e_v ∋ v} W*[e_u, e_v].

Two closure strategies:

* ``maxmin_closure`` — repeated squaring with the (max, min) matmul,
  ⌈log2 m⌉ rounds with no early exit.  On CUDA tensors each squaring is one
  launch of the ``maxmin_matmul`` kernel (CUDA cores: a (max, min)
  contraction has no tensor-core form).
* ``threshold_closure_mr`` — the same closure as a batch of boolean
  transitive closures, one per distinct overlap threshold;
  ``MR[i,j] = max{s : reach_s}``.  The batch is bf16 0/1 on both devices;
  on CUDA tensors each round is one launch of the ``threshold_step``
  kernel (tensor cores) over the whole ``[S, m, m]`` batch.

On CPU tensors the same functions run each kernel's plain PyTorch version.
``mr_matrix`` forms the line graph ``W`` on the device (the ``overlap``
kernel on the card, ``Hypergraph.line_graph`` on the host), closes it and
returns ``W*`` as a host int32 array.

Counterpart of ``repro/core/semiring.py``, same names in the same order;
``device_line_graph`` and ``close_line_graph`` are the two halves of
``mr_matrix``, public so callers can time or check them one by one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.maxmin_matmul import maxmin_matmul as _maxmin_kernel
from ..kernels.ops import default_rounds
from ..kernels.overlap import overlap
from ..kernels.threshold_closure import (largest_threshold,
                                         threshold_adjacency, threshold_step)
from .hypergraph import Hypergraph

__all__ = [
    "maxmin_matmul", "maxmin_closure", "boolean_closure",
    "threshold_closure_mr", "mr_matrix", "mr_oracle_dense",
    "vertex_mr_from_edge_mr", "distinct_thresholds",
    "closure_rounds_to_fixpoint", "device_line_graph", "close_line_graph",
    "CLOSURE_METHODS",
]

CLOSURE_METHODS = ("maxmin", "threshold")


def maxmin_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  block: int = 512) -> torch.Tensor:
    """C[i,j] = max_k min(A[i,k], B[k,j]) for non-negative inputs.

    The ``maxmin_matmul`` kernel on CUDA tensors; on CPU tensors its plain
    version, blocked over k (``block`` columns at a time) to bound the
    [i,k,j] broadcast.  Zero is the (max, min) annihilator/identity pair on
    the non-negative domain, so blocking the contraction is exact.
    """
    return _maxmin_kernel(a, b, block=block)


def maxmin_closure(w: torch.Tensor, *, block: int = 512,
                   max_rounds: Optional[int] = None) -> torch.Tensor:
    """Bottleneck-path closure by repeated squaring:
    R ← max(R, R∘R), ⌈log2 m⌉ rounds (or ``max_rounds``)."""
    rounds = max_rounds if max_rounds is not None else default_rounds(w.shape[0])
    r = w
    for _ in range(rounds):
        r = torch.maximum(r, maxmin_matmul(r, r, block=block))
    return r


def boolean_closure(adj: torch.Tensor, *,
                    rounds: Optional[int] = None) -> torch.Tensor:
    """Transitive closure of a boolean adjacency (float 0/1) via repeated
    squaring with real matmuls.  adj must include self-loops for closure
    semantics.  A plain tensor-op function, as in the reference: no
    kernel of this package sits under it."""
    n_rounds = rounds if rounds is not None else default_rounds(adj.shape[-1])
    r = adj
    for _ in range(n_rounds):
        r = (r @ r > 0).to(adj.dtype)
    return r


def closure_rounds_to_fixpoint(w: torch.Tensor, *, block: int = 512,
                               max_rounds: int = 64) -> int:
    """Squaring rounds until the bottleneck closure stops changing —
    ⌈log2(effective s-walk diameter)⌉, typically 3-6 on real hypergraphs
    vs the worst-case ⌈log2 m⌉ ladder (one host-visible equality check per
    round)."""
    r = w
    for i in range(1, max_rounds + 1):
        r2 = torch.maximum(r, maxmin_matmul(r, r, block=block))
        if torch.equal(r2, r):
            return i
        r = r2
    return max_rounds


def distinct_thresholds(w) -> np.ndarray:
    """All distinct positive entries of the line graph (off-diagonal OD
    values and diagonal |e| values), ascending, as a host array of ``w``'s
    dtype.  ``w`` is a host array or a tensor (reduced where it lies)."""
    if isinstance(w, torch.Tensor):
        vals = torch.unique(w).cpu().numpy()
    else:
        vals = np.unique(w)
    return vals[vals > 0]


def threshold_closure_mr(w: torch.Tensor,
                         thresholds: Optional[np.ndarray] = None, *,
                         rounds: Optional[int] = None) -> torch.Tensor:
    """MR matrix via threshold-batched boolean closure, float32 (as the
    reference's), on ``w``'s device.

    Exact iff ``thresholds`` covers every distinct positive value of W
    (default).  A coarser ladder gives a lower bound — the bucketized
    (approximate) mode used when δ is huge.
    """
    if thresholds is None:
        thresholds = distinct_thresholds(w)
    thresholds = np.asarray(thresholds)
    if thresholds.size == 0:
        return torch.zeros_like(w)
    n_rounds = rounds if rounds is not None else default_rounds(w.shape[0])
    t = torch.as_tensor(thresholds).to(w.device)
    # [S, m, m] 0/1 in bf16: exact, and the threshold_step kernel's type
    reach = threshold_adjacency(w, t, dtype=torch.bfloat16)
    for _ in range(n_rounds):
        reach = threshold_step(reach)
    # MR[i,j] = largest threshold whose closure connects i and j, taken in
    # float32 (a bf16 product would round thresholds above 256).
    mr = largest_threshold(reach, t.to(w.dtype))
    # reach includes the trivial i==i at every threshold via self-loops; fix
    # the diagonal to the true single-walk value |e_i| = W[i,i].
    mr.diagonal().copy_(w.diagonal())
    return mr


def device_line_graph(h: Hypergraph, *,
                      device: DeviceLike = None) -> torch.Tensor:
    """The line graph W [m, m] int32 on ``device`` (``None`` = ``"cuda"``).
    On the card: the ``overlap`` kernel over the dense incidence
    (``Hypergraph.to_incidence``, built on the host, copied, cast to bf16
    on the card: exact for 0/1), cast to int32 — its diagonal ``|e_i|`` is
    what B·Bᵀ gives.  On the host: ``Hypergraph.line_graph``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return torch.from_numpy(h.line_graph(np.int32))
    b_inc = torch.from_numpy(h.to_incidence(np.float32)).to(dev)
    return overlap(b_inc.to(torch.bfloat16)).to(torch.int32)


def close_line_graph(w: torch.Tensor, method: str = "maxmin") -> torch.Tensor:
    """``W*`` [m, m] int32 from the line graph, on ``w``'s device."""
    if method == "maxmin":
        return maxmin_closure(w)
    if method == "threshold":
        return threshold_closure_mr(w).to(torch.int32)
    raise ValueError(method)


def mr_matrix(h: Hypergraph, *, method: str = "maxmin",
              device: DeviceLike = None) -> np.ndarray:
    """Hyperedge-level MR matrix W* for a whole hypergraph, computed on
    ``device`` (``None`` = ``"cuda"``), returned as a host int32 array."""
    if h.m == 0:                # no hyperedges: nothing is reachable
        return np.zeros((0, 0), np.int32)
    if method not in CLOSURE_METHODS:
        raise ValueError(method)
    w = device_line_graph(h, device=device)
    return close_line_graph(w, method).cpu().numpy()


def vertex_mr_from_edge_mr(h: Hypergraph, w_star: np.ndarray,
                           us: Sequence[int], vs: Sequence[int]) -> np.ndarray:
    """MR(u, v) = max over incident hyperedge pairs of W* (host)."""
    w_star = np.asarray(w_star)
    out = np.zeros(len(us), w_star.dtype)
    for q, (u, v) in enumerate(zip(us, vs)):
        eu = h.edges_of(int(u))
        ev = h.edges_of(int(v))
        if eu.size and ev.size:
            out[q] = w_star[np.ix_(eu, ev)].max()
    return out


def mr_oracle_dense(h: Hypergraph, *, device: DeviceLike = None) -> np.ndarray:
    """Full vertex-level MR matrix [n, n] (tests on small graphs only)."""
    w_star = mr_matrix(h, device=device)
    out = np.zeros((h.n, h.n), w_star.dtype)
    for u in range(h.n):
        eu = h.edges_of(u)
        if not eu.size:
            continue
        rows = w_star[eu, :]                      # [deg(u), m]
        for v in range(h.n):
            ev = h.edges_of(v)
            if ev.size:
                out[u, v] = rows[:, ev].max()
    return out
