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

Backends today: every backend of the reference, ``sharded`` on a
logical mesh included (below).  ``hl-index`` and ``hl-index-basic``; ``closure`` — the dense (max, min)
closure ``W*``, built on the device by the ``overlap`` kernel and
⌈log2 m⌉ launches of ``maxmin_matmul`` (``method="maxmin"``, the
default) or ``threshold_step`` (``method="threshold"``); the planner
picks it for small line graphs with real batches
(``build_engine(h, "auto", batch_hint=1000)``).

    eng = build_engine(h, "closure", method="threshold")  # on the GPU
    eng.mr_batch(us, vs)             # [Q] int32 from the [n, m] label rows

Past the label budget (``nnz`` × mean vertex degree > 2e6) the planner
picks the index-free backends: ``online`` (Algorithm 1 on the host) for
trickle queries and ``frontier`` (sparse line-graph sweeps on the device)
for batches of 256 or more:

    eng = build_engine(h)                      # "online" on such a graph
    eng = build_engine(h, batch_hint=1024)     # "frontier", on the GPU
    eng.mr_batch(us, vs)             # [Q] int64, one sweep per bisection step

The baselines ``ete`` (its snapshot joins like the HL-index's, through
the ``label_join`` kernel with ``use_kernels=True``), ``threshold`` and
``mst-oracle`` are built by name.

Hyperedge updates go through the same engine — no rebuilding by hand:

    eng.update(inserts=[[3, 7, 9]], deletes=[4])   # in place
    eng.mr(u, v)                     # answers == full rebuild
    snap2 = eng.snapshot()           # only the dirty label rows re-derived

``update_capabilities()`` maps each backend to how it absorbs updates:
scoped construction on the affected line-graph component(s)
(``hl-index`` / ``hl-index-basic``), a patch on the 1-hop touched set
(``online`` / ``frontier``), a whole rebuild on the device (``closure``),
or ``UpdateUnsupported`` (``ete``, ``threshold``, ``mst-oracle``).

Heavy request traffic goes through the request service instead of
hand-assembled batches (``repro_torch.serve``); its knobs live in a typed
``ServiceConfig``:

    svc = serve(h, config=ServiceConfig(max_batch=4096,
                                        use_kernels=True))   # on the GPU
    f = svc.mr(4, 8)                             # Future[int]
    g = svc.submit(SReachRequest(4, 8, s=2))     # Future[bool], mixed s ok
    f.result(); g.result()
    svc.update(inserts=[[3, 7, 9]])              # snapshot swapped between
    svc.close()                                  #   micro-batches

``serve(h, device="cpu", start=False)`` runs the same service on the host
without a thread (``svc.drain()`` answers what is pending).  Requests
carry ``tenant`` / ``priority`` / ``deadline_ms``; the admission queue is
weighted-fair across tenants within strict priority bands, and
``ServiceConfig(replicas=N)`` serves round-robin off N device-resident
snapshot copies (``ReplicaGroup``) that the dirty rows of each update are
written into.

The five workload families ride the same engines and the same service,
gated per backend by ``workload_capabilities()`` as in the reference:

    w = eng.mr_witness(u, v)         # Witness(u, v, s=MR, walk=(e, ...))
    verify_witness(eng.h, w)         # True: a valid s-walk of strength s
    eng.top_s(u, 10)                 # int64 (vertices, MR), one mr_batch
    eng.mr_set(U, V)                 # int: max MR over U x V, one mr_batch
    eng.s_reach_k(u, v, s, k)        # bool: an s-walk of <= k hyperedges
    eng.s_distance(u, v, s)          # int: certified bound (DistanceOracle)
    svc.top_s(u, 10)                 # Future[((vertex, mr), ...)]

Indexes persist and restart without construction (``repro_torch.store``,
the reference's file format byte for byte, so either package restores
what the other saved):

    save_index("idx.hlidx", eng)                 # one checksummed file
    eng = load_index("idx.hlidx")                # mmap page-in, on the GPU
    svc.checkpoint(IndexStore("store/"))         # + write-ahead log
    svc = ReachabilityService.restore("store/", use_kernels=True)
    eng = build_engine(restore="store/", device="cpu")

``build_engine(h, "hl-index", workers=4)`` builds the index by line-graph
component shards in a fork pool (byte-identical labels).  The mesh is a
logical block grid on one device (``make_mesh``, as ``repro.api``'s):

    mesh = make_mesh((2, 2), ("data", "model"))          # on the card
    eng = build_engine(h, backend="sharded", mesh=mesh, schedule="ring")
    eng.mr_batch(us, vs)             # served off the block-partitioned W*
    eng = build_engine(h, "sharded", mesh=mesh, build_labels=True)
    eng = build_engine(h, "hl-index", mesh=mesh)      # auto: sharded build
    svc = serve(h, "sharded", mesh=mesh)              # mesh-resident serving

``make_mesh(..., device="cpu")`` runs all of it on the host.

A ``ProcessMesh`` puts each block on its own rank of a
``torch.distributed`` process group (one process a block, started by
``torchrun`` or a spawn); every rank runs the same calls:

    torch.distributed.init_process_group("nccl")        # or "gloo"
    pm = make_process_mesh((2, 2), ("data", "model"))
    eng = build_engine(h, backend="sharded", mesh=pm, use_kernels=True)
    eng.mr_batch(us, vs)             # the same answers on every rank
    eng = build_engine(h, "sharded", mesh=pm, build_labels=True)
    eng = build_engine(h, "hl-index", mesh=pm)   # build_sharded on the ranks
    eng.update(inserts=[[0, 1]])     # the same edits on every rank

Both regimes of ``sharded``, ``hl-index`` / ``hl-index-basic``,
``build_sharded``, ``neighbor_csr(mesh=)`` and ``DeviceSnapshot.to_mesh``
run on ranks, and so do serving, replicas and the store.  A service on
ranks has one leader: every rank builds the same service, global rank 0
admits the requests and the others serve its stream of micro-batches,
updates and checkpoints until it closes:

    svc = serve(h, "sharded", mesh=pm, build_labels=True,
                config=ServiceConfig(use_kernels=True))
    if pm.rank == 0:                 # the leader: the only one clients call
        f = svc.mr(4, 8); svc.update(inserts=[[3, 7, 9]]); f.result()
        svc.checkpoint(IndexStore("store/"))   # rank 0 writes, all attach
        svc.close()                  # the followers' follow() returns
    else:
        svc.follow()                 # submit / update raise here
    svc = ReachabilityService.restore("store/", mesh=pm)  # on every rank

``save_index`` / ``load_index(mesh=pm)`` / ``IndexStore`` write from rank
0 alone (the ranks share one filesystem), return the same manifest on
every rank, and land a closure's W* one block a rank.
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.core.engine import (ReachabilityEngine, DeviceSnapshot,
                                     SnapshotUnsupported, UpdateUnsupported,
                                     WorkloadUnsupported, WORKLOAD_OPS,
                                     available_backends, update_capabilities,
                                     workload_capabilities, plan_backend,
                                     register_backend, validate_batch)
from repro_torch.core.engine import build as build_engine
from repro_torch.core.hypergraph import (Hypergraph, from_edge_lists, compact,
                                         random_hypergraph,
                                         planted_chain_hypergraph,
                                         colocation_hypergraph, paper_figure1)
from repro_torch.core.mesh import (LogicalMesh, ProcessMesh,
                                   default_line_graph_mesh, make_mesh,
                                   make_process_mesh)
from repro_torch.device import DeviceLike
from repro_torch.serve.reach_service import (MRRequest, MRSetRequest,
                                             ReachabilityService, Request,
                                             SDistanceRequest, ServiceConfig,
                                             SReachKRequest, SReachRequest,
                                             TopSRequest, WitnessRequest)
from repro_torch.serve.replicas import ReplicaGroup
from repro_torch.serve.scheduler import (PRIORITY_CLASSES, DeadlineExceeded,
                                         TenantSpec)
from repro_torch.store import (IndexStore, load_index, read_hif, save_index,
                               write_hif)
from repro_torch.workloads import DistanceOracle, Witness, verify_witness

__all__ = [
    "ReachabilityEngine", "DeviceSnapshot", "SnapshotUnsupported",
    "UpdateUnsupported", "build_engine",
    "available_backends", "update_capabilities", "plan_backend",
    "register_backend", "validate_batch",
    "ReachabilityService", "ReplicaGroup", "serve", "ServiceConfig",
    "TenantSpec", "PRIORITY_CLASSES", "DeadlineExceeded",
    "Request", "MRRequest", "SReachRequest",
    # workload surface: one pinned set — engine capabilities, request
    # kinds, and the answer/verification types
    "WorkloadUnsupported", "WORKLOAD_OPS", "workload_capabilities",
    "WitnessRequest", "SReachKRequest", "MRSetRequest", "TopSRequest",
    "SDistanceRequest", "Witness", "verify_witness", "DistanceOracle",
    "Hypergraph", "from_edge_lists", "compact", "random_hypergraph",
    "planted_chain_hypergraph", "colocation_hypergraph", "paper_figure1",
    "IndexStore", "save_index", "load_index", "read_hif", "write_hif",
    "LogicalMesh", "make_mesh", "default_line_graph_mesh",
    "ProcessMesh", "make_process_mesh",
]

# service knobs that used to ride along in serve(**opts); still accepted
# for one release through the deprecation shim below, as in the reference
_LEGACY_SERVICE_KWARGS = ("max_batch", "min_bucket", "max_wait_ms",
                          "axes", "use_kernels")


def serve(h_or_engine, backend: str = "auto", *,
          config: ServiceConfig = None, mesh=None,
          start: bool = True, batch_hint=None, device: DeviceLike = None,
          **opts) -> ReachabilityService:
    """One-call serving: build an engine (unless given one) and wrap it
    in a ``ReachabilityService`` (or, with ``config.replicas > 1``, a
    ``ReplicaGroup``).

    Args:
      h_or_engine: a ``Hypergraph`` to build an engine over, or an
        already-built ``ReachabilityEngine`` to serve as-is (an engine
        built on ranks is served on its ranks).
      config: a ``ServiceConfig`` — the typed home of every serving knob
        (batching, tenant weights, priorities, replicas, kernels).
        Defaults to ``ServiceConfig()``.
      backend / batch_hint / mesh / device / engine ``**opts``:
        forwarded to ``build_engine`` when a hypergraph is passed.
        ``device=None`` means the mesh's device, or ``"cuda"`` without a
        mesh, and raises without a CUDA device; pass ``device="cpu"``
        (or a CPU mesh) to serve on the host.  ``mesh`` (a
        ``LogicalMesh`` or a ``ProcessMesh``) is also handed to the
        service so the resident snapshot is kept on it.  With a
        ``ProcessMesh`` every rank calls ``serve`` alike and the engine
        builds on the ranks; rank 0 gets the leader, the others a
        follower that serves in ``follow()`` (``ReachabilityService``).
        A prebuilt engine not built on ranks, served with a
        ``ProcessMesh``, becomes an engine on those ranks for good
        (``engine.on_ranks``), also after the service closes.
      start: start the background admission thread (``start=False`` =
        synchronous mode; call ``svc.drain()``).

    ``config.axes`` names the mesh (row, column) axes in both layers
    and is forwarded to both: the ``sharded`` engine's block partition
    and the service's ``to_mesh`` re-landing.  ``config.use_kernels``
    reaches the engine build (for backends that take it) and the
    service; with a prebuilt engine it configures the service alone.

    Deprecated: the service knobs (``max_batch``, ``min_bucket``,
    ``max_wait_ms``, ``axes``, ``use_kernels``) are still accepted as
    bare keyword arguments — they fold into ``config`` with a
    ``DeprecationWarning``.  Everything else in ``**opts`` is an
    engine-build option.
    """
    legacy = {k: opts.pop(k) for k in _LEGACY_SERVICE_KWARGS if k in opts}
    cfg = config if config is not None else ServiceConfig()
    if legacy:
        warnings.warn(
            f"passing service options {sorted(legacy)} to serve() as bare "
            f"keyword arguments is deprecated; pass "
            f"config=ServiceConfig(...) instead",
            DeprecationWarning, stacklevel=2)
        cfg = dataclasses.replace(cfg, **legacy)
    if isinstance(h_or_engine, Hypergraph):
        if cfg.use_kernels is not None:
            opts["use_kernels"] = cfg.use_kernels
        # resolve "auto" here so backend-specific options route correctly
        # (axes must reach the sharded engine even when the planner — not
        # the caller — picked it)
        resolved = backend if backend != "auto" else plan_backend(
            h_or_engine, batch_hint, mesh=mesh,
            device_budget_bytes=opts.get("device_budget_bytes"))
        if cfg.axes is not None and resolved == "sharded":
            opts["axes"] = cfg.axes  # same axes in both layers
        engine = build_engine(h_or_engine, resolved, batch_hint=batch_hint,
                              mesh=mesh, device=device, **opts)
    else:
        rejected = sorted(opts)
        if backend != "auto":
            rejected.append(f"backend={backend!r}")
        if batch_hint is not None:
            rejected.append(f"batch_hint={batch_hint!r}")
        if device is not None:
            rejected.append(f"device={device!r}")
        if rejected:
            raise ValueError(
                f"engine options {rejected} make no sense with an "
                f"already-built engine — they would be silently ignored")
        engine = h_or_engine
    if cfg.replicas > 1:
        return ReplicaGroup(engine, config=cfg, mesh=mesh, start=start)
    return ReachabilityService(engine, config=cfg, mesh=mesh, start=start)
