"""Public facade for hypergraph reachability — the one import surface.

    from repro_torch.api import build_engine, random_hypergraph

    h = random_hypergraph(1000, 1500)
    eng = build_engine(h, "hl-index", use_kernels=True)   # on the GPU
    eng.mr(u, v)                     # scalar max-reachability (host)
    eng.s_reach(u, v, s)             # scalar s-reachability (host)
    eng.mr_batch(us, vs)             # [Q] int32, one label_join launch
    eng.s_reach_batch(us, vs, s)     # [Q] bool
    snap = eng.snapshot()            # device-resident padded label tensors
    snap.mr(us, vs)                  # tensor-op batch join, stays on device

Every backend (see ``available_backends()``) answers through the same
``ReachabilityEngine`` protocol; ``backend="auto"`` lets the planner pick.

``build_engine(..., device=None)`` lands the label tensors on ``"cuda"``
and raises on a host without a CUDA device; ``device="cpu"`` runs the
same code on the host, with each kernel's plain PyTorch version in place
of the kernel.

Backends today: ``hl-index``, ``hl-index-basic``, ``mst-oracle`` and
``closure`` — the dense (max, min) closure ``W*``, built on the device by
the ``overlap`` kernel and ⌈log2 m⌉ launches of ``maxmin_matmul``
(``method="maxmin"``, the default) or ``threshold_step``
(``method="threshold"``); the planner picks it for small line graphs with
real batches (``build_engine(h, "auto", batch_hint=1000)``).

    eng = build_engine(h, "closure", method="threshold")  # on the GPU
    eng.mr_batch(us, vs)             # [Q] int32 from the [n, m] label rows

Updates, the request service, the store, the workload families and the
remaining backends of the reference facade are not here yet;
``ROADMAP.md`` lists them in the order they are ported.
"""
from __future__ import annotations

from repro_torch.core.engine import (ReachabilityEngine, DeviceSnapshot,
                                     SnapshotUnsupported, UpdateUnsupported,
                                     WorkloadUnsupported, available_backends,
                                     plan_backend, register_backend,
                                     validate_batch)
from repro_torch.core.engine import build as build_engine
from repro_torch.core.hypergraph import (Hypergraph, from_edge_lists, compact,
                                         random_hypergraph,
                                         planted_chain_hypergraph,
                                         colocation_hypergraph, paper_figure1)

__all__ = [
    "ReachabilityEngine", "DeviceSnapshot", "SnapshotUnsupported",
    "UpdateUnsupported", "WorkloadUnsupported", "build_engine",
    "available_backends", "plan_backend", "register_backend",
    "validate_batch",
    "Hypergraph", "from_edge_lists", "compact", "random_hypergraph",
    "planted_chain_hypergraph", "colocation_hypergraph", "paper_figure1",
]
