"""Request-based reachability serving: ``ReachabilityService``.

The engine API (``repro_torch.core.engine``) is imperative — callers
invoke ``eng.mr_batch`` with batches they assembled themselves, and after
an ``update`` they must notice staleness and re-derive snapshots by hand.
This module turns that surface into a *service*: callers submit typed
requests and get futures; an admission loop coalesces whatever is pending
into one padded device batch per query kind and scatters the answers back.

    svc = repro_torch.api.serve(h, config=ServiceConfig(max_batch=1024))
    f1 = svc.mr(4, 8)                           # Future[int]
    f2 = svc.submit(SReachRequest(4, 8, s=2))   # Future[bool]
    f1.result(), f2.result()
    svc.update(inserts=[[3, 7, 9]])             # dispatch waits for it
    svc.close()

Design (the mechanisms the module exists for):

* **Admission micro-batching** — pending requests are grouped by query
  kind (``MRRequest`` vs ``SReachRequest``) and each group is padded to a
  power-of-two bucket size (``min_bucket`` .. ``max_batch``) before
  dispatch.  A CUDA launch takes any batch size, so the buckets are an
  admission policy here, kept so that a batch has the same shape, and
  the stats the same counts, as in the reference.  Padding slots repeat
  a real query pair, which is inert (answers past the true count are
  dropped before the scatter).  Mixed ``s`` values coalesce into one
  batch: on the snapshot path every s-reach answer is ``mr >= s`` off
  the same join.
* **One launch, one copy each way** — a group's ids land on the device
  in one host->device copy; with ``use_kernels`` the join is one
  ``label_join_gather`` launch on the resident snapshot; the answers
  come back in one device->host copy, the batch's only synchronisation.
  Requests are validated once, at admission, on a scalar path, so a
  batch pays no second ``validate_batch``.
* **Multi-tenant admission** — every request carries ``tenant`` /
  ``priority`` / ``deadline_ms`` metadata (defaults reproduce
  single-tenant behavior exactly).  The queue is a
  ``WeightedFairScheduler``: strict priority bands, deficit-weighted
  round-robin across tenants within a band, deadline-expired requests
  failed fast with ``DeadlineExceeded``.
* **Streaming delivery** — ``submit_stream()`` yields ``(request,
  future)`` pairs in *completion* order as micro-batches resolve them,
  and ``submit(..., on_result=fn)`` invokes a callback the moment one
  request's answer lands.
* **Version-keyed snapshot reuse** — every batch is served off one
  resident ``DeviceSnapshot`` keyed by ``engine.version``.  After
  ``update()`` the swap happens *between* micro-batches (never mid
  batch): the admission loop notices ``snap.version != engine.version``
  and asks the engine for its snapshot, which a scoped update patched
  row-wise (``snapshot()`` re-derives only the dirty rows), and installs
  it with a single reference swap.  A batch's ids are validated against
  the engine at admission, and the kernel reads rows by id, so a batch
  is only ever joined against the snapshot of the engine's version.
* **Mesh-resident serving** — pass ``mesh=`` (a ``LogicalMesh``) and the
  resident snapshot is kept on that block grid (``DeviceSnapshot.to_mesh``).
  After a scoped update only the dirty rows are re-landed into the
  mesh-resident copy (``to_mesh(base=..., dirty_rows=...)``, counted in
  ``mesh_rows_patched``); a snapshot the engine already derives on the
  service's mesh (the ``sharded`` backend's) is served as it is.
  ``repro_torch.serve.replicas`` builds read-replica fan-out on the same
  contract.
* **Serving on ranks** — on a ``ProcessMesh`` (``mesh=pm``, or an engine
  built on one) every rank constructs the same service over the same
  engine and config.  Global rank 0 is the *leader*: only its
  ``submit`` / ``submit_many`` / ``submit_stream`` / ``update`` /
  ``checkpoint`` / ``drain`` / ``close`` are called, and admission
  (deadlines, tenants, priorities, cancellation) runs there alone.  The
  other ranks are *followers*: each calls ``follow()``, which serves the
  leader's event stream (``repro_torch.serve.rank_stream``) until the
  leader closes; their ``submit`` and ``update`` raise.  Each
  micro-batch, update and checkpoint crosses as one event, so every rank
  runs the same dispatch over the same groups, enters every collective
  of the row assembly in the same order, and swaps its snapshot (and a
  ``ReplicaGroup`` its copies) between the same two micro-batches.  Every
  rank checks a batch's ids against its engine before the first
  collective, and ends each step with one status word: if a rank failed,
  every rank fails that step, the leader fails its futures, and serving
  goes on.  A rank that dies inside a collective takes the group down at
  the group's timeout; nothing papers over that.  An idle threaded
  leader sends a keep-alive every ``keepalive_s`` (a quarter of the
  group's timeout), so followers never time out while it is quiet; a
  synchronous leader (``start=False``) must dispatch or close within the
  timeout.  From the start of ``close()`` the leader refuses requests,
  so none can queue behind the close event.

Backends with no snapshot form (``mst-oracle``) are served through their
own ``mr_batch`` / ``s_reach_batch`` by the same admission loop — the
service degrades, never refuses.  Workload request kinds (``witness`` /
``s_reach_k`` / ``mr_set`` / ``top_s`` / ``s_distance``, see
``repro_torch.workloads``) ride the same admission queue with the same
tenant / priority / deadline metadata and their own per-kind dispatch
groups — so workload traffic never perturbs the padded mr / s_reach
buckets — and are answered one by one through the engine's workload
methods (``mr_set`` / ``top_s`` batch inside, through ``mr_batch``).  A
backend whose ``workload_capability`` lacks a kind refuses it at
admission with ``WorkloadUnsupported``.

Durability: ``checkpoint(store)`` writes the engine into a
``repro_torch.store.IndexStore`` and journals every later update there;
``ReachabilityService.restore(store_or_path, device=...)`` restarts
serving from it (checkpoint page-in + WAL replay, no construction).

Counterpart of ``repro/serve/reach_service.py``.
"""
from __future__ import annotations

import dataclasses
import operator
import queue as queue_mod
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..core import collectives as coll
from ..core.engine import SnapshotUnsupported, WorkloadUnsupported
from ..core.mesh import ProcessMesh
from ..core.query import KernelSnapshot
from ..device import DeviceLike
from ..kernels.build import load_library
from ..store import IndexStore, restore_engine
from . import rank_stream as rs
from .scheduler import (PRIORITY_CLASSES, DeadlineExceeded, TenantSpec,
                        WeightedFairScheduler, _Entry)

__all__ = ["Request", "MRRequest", "SReachRequest", "WitnessRequest",
           "SReachKRequest", "MRSetRequest", "TopSRequest",
           "SDistanceRequest", "ReachabilityService",
           "ServiceConfig", "ServiceStats", "REQUEST_TYPES",
           "PRIORITY_CLASSES", "TenantSpec", "DeadlineExceeded"]


@dataclasses.dataclass(frozen=True)
class Request:
    """Frozen base every service request derives from.  Carries the
    multi-tenant scheduling metadata; all three fields are keyword-only
    with defaults that mean one implicit tenant, one band, no deadline —
    ``MRRequest(4, 8)`` is a plain query.
    """

    tenant: str = dataclasses.field(default="default", kw_only=True)
    priority: str = dataclasses.field(default="standard", kw_only=True)
    deadline_ms: Optional[float] = dataclasses.field(default=None,
                                                     kw_only=True)


@dataclasses.dataclass(frozen=True)
class MRRequest(Request):
    """Problem 2: answer ``MR(u, v)`` — resolves to ``int``."""

    u: int
    v: int

    kind = "mr"


@dataclasses.dataclass(frozen=True)
class SReachRequest(Request):
    """Problem 1: is there an s-walk joining ``u`` and ``v`` — resolves
    to ``bool``.  Requests with different ``s`` coalesce into the same
    batch (the snapshot path answers all of them off one join)."""

    u: int
    v: int
    s: int

    kind = "s_reach"


@dataclasses.dataclass(frozen=True)
class WitnessRequest(Request):
    """Workload: MR with proof — resolves to the hyperedge walk that
    realizes ``MR(u, v)`` (empty walk when 0)."""

    u: int
    v: int

    kind = "witness"


@dataclasses.dataclass(frozen=True)
class SReachKRequest(Request):
    """Workload: hop-bounded s-reach — is there an s-walk of at most
    ``k`` hyperedges joining ``u`` and ``v``; resolves to ``bool``."""

    u: int
    v: int
    s: int
    k: int

    kind = "s_reach_k"


@dataclasses.dataclass(frozen=True)
class MRSetRequest(Request):
    """Workload: set-to-set MR — ``max`` of ``MR(u, v)`` over
    ``us x vs``; resolves to ``int``.  Vertex sets are stored as tuples
    so the request stays frozen/hashable."""

    us: Tuple[int, ...]
    vs: Tuple[int, ...]

    kind = "mr_set"

    def __post_init__(self):
        object.__setattr__(self, "us", tuple(self.us))
        object.__setattr__(self, "vs", tuple(self.vs))


@dataclasses.dataclass(frozen=True)
class TopSRequest(Request):
    """Workload: top-k strongest-s ranking — resolves to a tuple of
    ``(vertex, mr)`` pairs sorted by descending ``mr`` (ties by vertex
    id), zeros and ``u`` itself excluded."""

    u: int
    k: int

    kind = "top_s"


@dataclasses.dataclass(frozen=True)
class SDistanceRequest(Request):
    """Workload: landmark s-distance — resolves to an ``int`` certified
    upper bound on the number of hyperedges an s-walk from ``u`` to
    ``v`` needs (0 = provably no s-walk)."""

    u: int
    v: int
    s: int

    kind = "s_distance"


# kind -> request class (the reference's table, unchanged)
REQUEST_TYPES: Dict[str, type] = {MRRequest.kind: MRRequest,
                                  SReachRequest.kind: SReachRequest,
                                  WitnessRequest.kind: WitnessRequest,
                                  SReachKRequest.kind: SReachKRequest,
                                  MRSetRequest.kind: MRSetRequest,
                                  TopSRequest.kind: TopSRequest,
                                  SDistanceRequest.kind: SDistanceRequest}

# workload kinds gate on engine.workload_capability at submit; "mr" and
# "s_reach" (the padded-bucket kinds) every backend serves
_KIND_TO_OP: Dict[str, str] = {"witness": "witness",
                               "s_reach_k": "s_reach_k",
                               "mr_set": "mr_set",
                               "top_s": "top_s",
                               "s_distance": "s_distance"}


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Typed service configuration — the one documented way to set
    serving knobs (``repro_torch.api.serve(h, config=ServiceConfig(...))``).

    Batching: ``max_batch`` (admission cap / largest bucket),
    ``min_bucket`` (smallest padded shape), ``max_wait_ms`` (coalescing
    linger; 0 dispatches immediately).

    Placement: ``axes`` (mesh (row, column) axis names for ``to_mesh``),
    ``use_kernels`` (serve snapshot batches through the
    ``label_join_gather`` CUDA kernel, ``KernelSnapshot``; ``None``
    inherits the engine flag).

    Scheduling: ``tenants`` (``TenantSpec`` shares; unlisted tenants get
    ``default_weight``), ``quantum`` (DRR credits per pass — larger
    means coarser interleaving within a batch, same long-run shares).

    Fan-out: ``replicas`` — when > 1, ``repro_torch.api.serve`` builds a
    ``ReplicaGroup`` of that many device-resident snapshot copies
    instead of a single-snapshot service.
    """

    max_batch: int = 4096
    min_bucket: int = 8
    max_wait_ms: float = 0.5
    axes: Optional[Tuple[str, str]] = None
    use_kernels: Optional[bool] = None
    tenants: Tuple[TenantSpec, ...] = ()
    default_weight: float = 1.0
    quantum: int = 8
    replicas: int = 1

    def __post_init__(self):
        object.__setattr__(self, "max_batch", int(self.max_batch))
        object.__setattr__(self, "min_bucket", int(self.min_bucket))
        object.__setattr__(self, "max_wait_ms", float(self.max_wait_ms))
        object.__setattr__(self, "tenants", tuple(self.tenants))
        object.__setattr__(self, "quantum", int(self.quantum))
        object.__setattr__(self, "replicas", int(self.replicas))
        if (self.max_batch < 1 or self.min_bucket < 1
                or self.min_bucket > self.max_batch):
            raise ValueError(
                f"need 1 <= min_bucket <= max_batch; got min_bucket="
                f"{self.min_bucket} max_batch={self.max_batch}")
        for spec in self.tenants:
            if not isinstance(spec, TenantSpec):
                raise TypeError(
                    f"ServiceConfig.tenants entries must be TenantSpec; "
                    f"got {spec!r}")
        if not float(self.default_weight) > 0:
            raise ValueError(
                f"default_weight must be > 0; got {self.default_weight!r}")
        if self.quantum < 1:
            raise ValueError(f"quantum must be >= 1; got {self.quantum}")
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1; got {self.replicas}")


@dataclasses.dataclass
class ServiceStats:
    """Counters the admission loop maintains (read via ``stats()``); the
    same fields as the reference's, counted the same way.  On a follower
    rank of a service on ranks only the dispatch-side fields count (equal
    to the leader's); the admission-side ones (``submitted``,
    ``expired`` and the per-tenant maps) stay zero and empty there."""

    submitted: int = 0
    answered: int = 0
    expired: int = 0                 # failed fast with DeadlineExceeded
    batches: int = 0
    padded_queries: int = 0          # bucket padding slots dispatched
    bucket_histogram: Dict[int, int] = dataclasses.field(default_factory=dict)
    tenant_submitted: Dict[str, int] = dataclasses.field(default_factory=dict)
    tenant_answered: Dict[str, int] = dataclasses.field(default_factory=dict)
    tenant_expired: Dict[str, int] = dataclasses.field(default_factory=dict)
    snapshot_refreshes: int = 0
    rows_rederived: int = 0          # label rows re-derived across refreshes
    rows_full: int = 0               # rows a from-scratch refresh would cost
    mesh_rows_patched: int = 0       # rows re-landed into a mesh-resident copy
    kernel_batches: int = 0          # batches answered by the CUDA join
    workload_answered: Dict[str, int] = dataclasses.field(
        default_factory=dict)        # per-kind workload answers served
    updates: int = 0

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        for key in ("bucket_histogram", "tenant_submitted",
                    "tenant_answered", "tenant_expired",
                    "workload_answered"):
            d[key] = dict(sorted(d[key].items()))
        return d


def _resolve(fut: Future, value) -> None:
    """Resolve one future, tolerating a caller's concurrent ``cancel()``
    (a bare ``cancelled()`` pre-check races: the cancel can land between
    the check and ``set_result``, and the resulting InvalidStateError
    would poison the whole micro-batch through the dispatch error
    handler)."""
    try:
        fut.set_result(value)
    except InvalidStateError:
        pass                         # cancelled mid-dispatch: drop quietly


def _deliver(entry: _Entry, value) -> None:
    _resolve(entry.future, value)


def _bucket_size(q: int, min_bucket: int, max_batch: int) -> int:
    """Smallest power-of-two >= q, clamped to [min_bucket, max_batch]."""
    b = 1 << max(q - 1, 0).bit_length()
    return max(min(max(b, min_bucket), max_batch), q)


def rank_mesh_of(engine, mesh) -> Optional[ProcessMesh]:
    """The ``ProcessMesh`` a service on ``engine`` and ``mesh`` runs on:
    ``mesh`` if it is one, else the engine's ``rank_mesh``, else
    ``None`` (a service in one process)."""
    own = getattr(engine, "rank_mesh", None)
    if isinstance(mesh, ProcessMesh):
        if own is not None and own != mesh:
            raise ValueError(f"the engine is built on {own}, not on the "
                             f"service's {mesh}")
        return mesh
    return own


class ReachabilityService:
    """Request-based serving over any ``ReachabilityEngine``.

    Args:
      engine: a built engine (``repro_torch.api.build_engine``) — the
        service owns its snapshot lifecycle from here on.  The snapshot
        lives on the engine's device.
      config: a ``ServiceConfig``; the typed home of every serving knob
        (batching, scheduling, placement).  Defaults to
        ``ServiceConfig()``.
      mesh: optional ``LogicalMesh`` or ``ProcessMesh``; the resident
        snapshot is kept on it (``to_mesh``) and refreshed row-wise after
        scoped updates.  Ignored for backends with no snapshot form.  A
        ``ProcessMesh`` (or an engine built on one) makes this a service
        on ranks (module docstring): rank 0 leads, the others
        ``follow()``; an engine not built on ranks becomes an engine on
        them for good (``engine.on_ranks(mesh)``: its updates agree
        across the ranks and its store writes from rank 0, also after
        the service closes).
      start: start the background admission thread.  With
        ``start=False`` the service is synchronous: call ``drain()`` to
        process everything pending (deterministic; what the tests use).
      axes / max_batch / min_bucket / max_wait_ms / use_kernels: direct
        overrides of the matching ``config`` field (``None`` = take the
        config value).

    ``use_kernels=None`` inherits the engine's own ``use_kernels`` flag.
    With kernels on a CUDA engine the ``label_join`` library is built and
    loaded here, before the admission thread starts, so a failed build
    raises to the caller and the thread never compiles.  Every batch then
    launches ``label_join_gather`` on the admission thread's current
    stream, the stream its answers are read on.  An error of a batch
    (a refused launch, a device fault) fails that batch's futures; none
    is left pending.
    """

    # ReplicaGroup flips this; a plain service refuses a replicated
    # config rather than silently serving one copy
    _replica_aware = False

    def __init__(self, engine, *, config: Optional[ServiceConfig] = None,
                 mesh=None, axes: Optional[Tuple[str, str]] = None,
                 max_batch: Optional[int] = None,
                 min_bucket: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 use_kernels: Optional[bool] = None, start: bool = True):
        cfg = config if config is not None else ServiceConfig()
        overrides = {k: v for k, v in (("axes", axes),
                                       ("max_batch", max_batch),
                                       ("min_bucket", min_bucket),
                                       ("max_wait_ms", max_wait_ms),
                                       ("use_kernels", use_kernels))
                     if v is not None}
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        ranks = rank_mesh_of(engine, mesh)
        if cfg.replicas > 1 and not self._replica_aware:
            raise ValueError(
                f"ServiceConfig(replicas={cfg.replicas}) needs replica "
                f"fan-out — use repro_torch.api.serve (which builds a "
                f"ReplicaGroup) or repro_torch.serve.replicas.ReplicaGroup "
                f"directly")
        self.config = cfg
        self.engine = engine
        self.mesh = mesh
        self.axes = cfg.axes
        self.max_batch = cfg.max_batch
        self.min_bucket = cfg.min_bucket
        self.max_wait_s = cfg.max_wait_ms / 1e3
        self._stats = ServiceStats()
        self._queue = WeightedFairScheduler(
            cfg.tenants, default_weight=cfg.default_weight,
            quantum=cfg.quantum)
        self._cv = threading.Condition()
        # serializes dispatch against update(): a micro-batch always runs
        # against one coherent (engine, snapshot) pair, and the snapshot
        # swap happens strictly between batches
        self._dispatch_lock = threading.Lock()
        self._snap = None            # resident serving snapshot (mesh or not)
        self._host_snap = None       # the engine-derived snapshot _snap mirrors
        self._snapshot_ok: Optional[bool] = None   # None = not probed yet
        self.use_kernels = (bool(getattr(engine, "use_kernels", False))
                            if cfg.use_kernels is None
                            else bool(cfg.use_kernels))
        device = getattr(engine, "device", None)
        if self.use_kernels and device is not None and device.type == "cuda":
            load_library("label_join")
        self._kernel_snap: Optional[KernelSnapshot] = None
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # serving on ranks: the event stream, who leads, and the follower's
        # store (a checkpoint event names it)
        self._ranks = ranks
        self.leader = ranks is None or ranks.rank == 0
        self._stream = None
        self._closed = False
        self._store = None
        self.failed_events = 0       # events that failed on every rank
        if ranks is not None:
            engine.on_ranks(ranks)
            self._stream = rs.RankStream(ranks)
            self.keepalive_s = rs.keepalive_interval(ranks)
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReachabilityService":
        """Start the admission thread (a follower admits nothing: it
        serves in ``follow()``)."""
        if not self.leader:
            return self
        with self._cv:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="reach-service", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop the admission thread; everything already submitted is
        resolved first — answered, or failed with ``DeadlineExceeded``
        if its deadline passed (no future is left unresolved).  On ranks
        the leader then sends the close event, after which the followers'
        ``follow()`` returns.  The leader refuses requests from the
        start of ``close`` on, so none can arrive after the last drain."""
        with self._cv:
            self._running = False
            if self._stream is not None:
                self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if not self.leader:
            return
        self.drain()                 # no-thread mode: flush synchronously
        if self._stream is not None:
            with self._dispatch_lock:
                if not self._stream.closed:
                    self._stream.send(rs.CLOSE,
                                      version=self.engine.version)

    def __enter__(self) -> "ReachabilityService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request admission -------------------------------------------------

    def submit(self, request: Request, *,
               on_result: Optional[Callable[[Request, Future], None]] = None,
               ) -> Future:
        """Enqueue one typed request; returns a ``Future`` resolving to
        the kind's answer type (``int`` for ``MRRequest``, ``bool`` for
        ``SReachRequest``, the workload kinds' types as in the reference)
        — or raising ``DeadlineExceeded`` if ``deadline_ms`` elapses
        first.  Workload kinds the backend cannot serve are refused at
        admission with ``WorkloadUnsupported``.

        ``on_result`` is the callback delivery hook: called as
        ``on_result(request, future)`` the moment this request's future
        resolves (from the dispatching thread), whatever the outcome.

        Validation is the same contract as ``validate_batch`` (integer
        ids in ``[0, n)``) on a scalar fast path — admission is the
        per-request hot loop, so it avoids array round-trips."""
        self._check_leader("submit")
        if not isinstance(request, tuple(REQUEST_TYPES.values())):
            raise TypeError(
                f"expected one of {sorted(REQUEST_TYPES)} requests, got "
                f"{type(request).__name__}")
        self._validate_fields(request)
        op = _KIND_TO_OP.get(request.kind)
        if op is not None and op not in getattr(
                self.engine, "workload_capability", frozenset()):
            raise WorkloadUnsupported(
                f"backend {getattr(self.engine, 'name', '?')!r} does not "
                f"serve the {op!r} workload")
        if not isinstance(request.tenant, str) or not request.tenant:
            raise ValueError(
                f"request tenant must be a non-empty string; got "
                f"{request.tenant!r}")
        if request.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority class {request.priority!r}; available: "
                f"{sorted(PRIORITY_CLASSES)}")
        deadline_ms = None
        if request.deadline_ms is not None:
            deadline_ms = float(request.deadline_ms)
            if not deadline_ms > 0:
                raise ValueError(
                    f"deadline_ms must be > 0 (or None); got "
                    f"{request.deadline_ms!r}")
        fut: Future = Future()
        if on_result is not None:
            fut.add_done_callback(
                lambda f, _cb=on_result, _req=request: _cb(_req, f))
        now = time.monotonic()
        expiry = None if deadline_ms is None else now + deadline_ms / 1e3
        entry = _Entry(request, fut, now, expiry)
        with self._cv:
            self._check_leader("submit")     # close() may have begun
            self._queue.push(entry)
            self._stats.submitted += 1
            t = request.tenant
            self._stats.tenant_submitted[t] = \
                self._stats.tenant_submitted.get(t, 0) + 1
            self._cv.notify()
        return fut

    def _validate_fields(self, request: Request) -> None:
        """Per-kind query-field validation (the shared tenant/priority/
        deadline metadata checks stay in ``submit``).  Scalar fast path
        with the same contract as ``validate_batch``."""
        n = self.engine.h.n
        kind = request.kind

        def _vertex(x) -> int:
            try:
                i = operator.index(x)
            except TypeError:
                raise ValueError(
                    f"request vertex ids must have an integer dtype; got "
                    f"{x!r}") from None
            if not 0 <= i < n:
                raise IndexError(
                    f"request vertex id {i} out of range [0, {n})")
            return i

        def _count(x, name: str) -> int:
            try:
                i = operator.index(x)
            except TypeError:
                raise ValueError(
                    f"request {name} must have an integer dtype; got "
                    f"{x!r}") from None
            if i < 1:
                raise ValueError(f"request {name} must be >= 1; got {i}")
            return i

        if kind == "mr_set":
            for name, ids in (("us", request.us), ("vs", request.vs)):
                if not ids:
                    raise ValueError(
                        f"mr_set request field {name!r} must be a non-empty "
                        f"vertex set")
                for x in ids:
                    _vertex(x)
            return
        if kind == "top_s":
            _vertex(request.u)
            _count(request.k, "k")
            return
        # every remaining kind is a (u, v) pair query
        try:
            u = operator.index(request.u)
            v = operator.index(request.v)
        except TypeError:
            raise ValueError(
                f"request vertex ids must have an integer dtype; got "
                f"({request.u!r}, {request.v!r})") from None
        if not 0 <= u < n or not 0 <= v < n:
            bad = u if not 0 <= u < n else v
            raise IndexError(
                f"request vertex id {bad} out of range [0, {n})")
        if kind in ("s_reach", "s_reach_k", "s_distance"):
            try:
                s = operator.index(request.s)
            except TypeError:
                raise ValueError(
                    f"request s must have an integer dtype; got "
                    f"{request.s!r}") from None
            if s < 1:
                raise ValueError(f"s-reachability needs s >= 1; got {s}")
        if kind == "s_reach_k":
            _count(request.k, "k")

    def submit_many(self, requests: Sequence[Request]) -> List[Future]:
        return [self.submit(r) for r in requests]

    def submit_stream(self, requests: Iterable[Request],
                      ) -> Iterator[Tuple[Request, Future]]:
        """Submit ``requests`` and yield ``(request, resolved_future)``
        pairs in *completion* order, as micro-batches finish.  Futures
        arrive resolved; a deadline-expired request yields with
        ``DeadlineExceeded`` set rather than being dropped.

        In synchronous mode (``start=False``) the pending queue is
        drained inline after submission, so iteration still completes
        without a background thread."""
        done: "queue_mod.Queue[Tuple[Request, Future]]" = queue_mod.Queue()
        pairs = [(r, self.submit(
            r, on_result=lambda req, fut, _q=done: _q.put((req, fut))))
            for r in requests]
        if not self._running:
            self.drain()
        for _ in range(len(pairs)):
            yield done.get()

    def mr(self, u: int, v: int) -> Future:
        return self.submit(MRRequest(int(u), int(v)))

    def s_reach(self, u: int, v: int, s: int) -> Future:
        return self.submit(SReachRequest(int(u), int(v), int(s)))

    def witness(self, u: int, v: int) -> Future:
        return self.submit(WitnessRequest(int(u), int(v)))

    def s_reach_k(self, u: int, v: int, s: int, k: int) -> Future:
        return self.submit(SReachKRequest(int(u), int(v), int(s), int(k)))

    def mr_set(self, us: Iterable[int], vs: Iterable[int]) -> Future:
        return self.submit(MRSetRequest(tuple(int(x) for x in us),
                                        tuple(int(x) for x in vs)))

    def top_s(self, u: int, k: int) -> Future:
        return self.submit(TopSRequest(int(u), int(k)))

    def s_distance(self, u: int, v: int, s: int) -> Future:
        return self.submit(SDistanceRequest(int(u), int(v), int(s)))

    def _check_leader(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(
                f"{what} on a follower rank: a service on ranks takes "
                f"requests, updates and checkpoints on global rank 0 only; "
                f"this rank serves them in follow()")
        if self._closed:
            raise RuntimeError(f"{what} after close(): a service on ranks "
                               f"takes nothing once it closes")

    def update(self, inserts=(), deletes=()) -> None:
        """Apply hyperedge edits through the engine.  Dispatch stops for
        the whole update: it holds the dispatch lock, so a micro-batch
        already running finishes first, and requests admitted meanwhile
        wait (in the queue, or in a batch the admission thread has
        taken) until the update returns.  The next micro-batch then
        swaps in the refreshed snapshot and answers them against the new
        version.  On a graph whose update scope is its giant component
        that wait is the host rebuild's seconds.  On ranks the edits
        cross to every rank as one event and every rank applies them; a
        failure on any rank raises ``RuntimeError`` here."""
        self._check_leader("update")
        with self._dispatch_lock:
            if self._stream is None:
                self.engine.update(inserts, deletes)
            else:
                payload = rs.encode_edits(inserts, deletes)
                self._stream.send(rs.UPDATE, payload,
                                  version=self.engine.version)
                self._rank_update(*rs.decode_edits(payload),
                                  self.engine.version)
            self._stats.updates += 1

    # -- durability (repro_torch.store) ------------------------------------

    def checkpoint(self, store) -> int:
        """Durably checkpoint the engine into ``store`` (a
        ``repro_torch.store.IndexStore``) and attach the store as the
        engine's WAL sink — every subsequent ``update`` then journals
        (fsync) before applying, so a crash at any point is recoverable
        via ``restore``.  Runs under the dispatch lock, never mid-batch.
        Returns the checkpointed engine version.  On ranks the checkpoint
        is one event: every rank runs the store's rank route at the same
        point of the stream (rank 0 writes; the ranks share the store's
        filesystem)."""
        self._check_leader("checkpoint")
        with self._dispatch_lock:
            if self._stream is None:
                store.checkpoint(self.engine)
                store.attach(self.engine)
            else:
                self._stream.send(rs.CHECKPOINT, coll.encode_json(
                    {"path": str(store.path.resolve()),
                     "checkpoint_every": store.checkpoint_every,
                     "verify": store.verify}), version=self.engine.version)
                self._rank_checkpoint(store, None)
            return int(self.engine.version)

    @classmethod
    def restore(cls, store_or_path, *, device: DeviceLike = None,
                mesh=None, axes: Optional[Tuple[str, str]] = None,
                verify: bool = True,
                expect_backend: Optional[str] = None,
                **service_opts) -> "ReachabilityService":
        """Warm-restart serving from a store artifact of either package
        (an ``IndexStore`` instance, a store directory, or a single
        ``save_index`` file): the checkpoint loads mmap-backed — no
        construction — the WAL suffix replays, the store re-attaches as
        the WAL sink, and the service starts around the restored engine,
        whose snapshot lands on ``device`` (``None`` means ``"cuda"``).
        The engine arrives at its persisted version, so the first
        micro-batch installs a resident snapshot keyed to exactly that
        version — the same version-keyed swap a live ``update`` takes.
        ``service_opts`` are the constructor's (``use_kernels=True``
        serves through the ``label_join_gather`` kernel); ``mesh`` /
        ``axes`` place a ``sharded`` checkpoint and the resident snapshot
        on that logical mesh (with no ``device``, the mesh's).  With a
        ``ProcessMesh`` every rank calls this: each restores the engine on
        the ranks (``IndexStore.restore(mesh=pm)``) and gets its rank's
        service around it, rank 0 the leader."""
        if isinstance(store_or_path, IndexStore):
            engine = store_or_path.restore(device=device, mesh=mesh,
                                           verify=verify,
                                           expect_backend=expect_backend)
        else:
            engine = restore_engine(store_or_path, device=device, mesh=mesh,
                                    verify=verify,
                                    expect_backend=expect_backend)
        return cls(engine, mesh=mesh, axes=axes, **service_opts)

    def stats(self) -> ServiceStats:
        with self._dispatch_lock:
            return dataclasses.replace(
                self._stats,
                bucket_histogram=dict(self._stats.bucket_histogram),
                tenant_submitted=dict(self._stats.tenant_submitted),
                tenant_answered=dict(self._stats.tenant_answered),
                tenant_expired=dict(self._stats.tenant_expired),
                workload_answered=dict(self._stats.workload_answered))

    def pending(self) -> int:
        with self._cv:
            return len(self._queue)

    def backlog(self) -> Dict[str, int]:
        """Pending request count per tenant."""
        with self._cv:
            return self._queue.backlog()

    # -- admission loop ----------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (self._running and not len(self._queue)
                       and not self._keepalive_due()):
                    self._cv.wait(timeout=self._idle_wait_s())
                if not self._running and not len(self._queue):
                    return
                idle = not len(self._queue)  # quiet past the keep-alive
                if not idle:
                    # linger for the full coalescing window (each
                    # submit() notify wakes the wait, so loop until the
                    # deadline or a full batch) — the latency/throughput
                    # admission knob
                    deadline = time.monotonic() + self.max_wait_s
                    while (self._running
                            and len(self._queue) < self.max_batch):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                    batch, expired = self._queue.take(self.max_batch,
                                                      time.monotonic())
            if idle:
                self._keepalive()
                continue
            self._fail_expired(expired)
            if batch:
                self._dispatch(batch)

    def _idle_wait_s(self) -> float:
        if self._stream is None:
            return 0.05
        return max(min(0.05, self.keepalive_s), 1e-3)

    def _keepalive_due(self) -> bool:
        return (self._stream is not None and time.monotonic()
                - self._stream.last_sent >= self.keepalive_s)

    def _keepalive(self) -> None:
        with self._dispatch_lock:
            if not self._stream.closed and self._keepalive_due():
                self._stream.send(rs.KEEPALIVE, version=self.engine.version)

    def drain(self, max_batches: Optional[int] = None) -> int:
        """Synchronously dispatch pending requests in the caller's
        thread; returns the number of requests resolved (answered or
        deadline-failed).  This is the deterministic serving mode
        (``start=False``).  ``max_batches`` bounds the number of
        micro-batches taken — the fairness tests step one batch at a
        time to observe its composition."""
        total = 0
        batches = 0
        while max_batches is None or batches < max_batches:
            with self._cv:
                batch, expired = self._queue.take(self.max_batch,
                                                  time.monotonic())
            self._fail_expired(expired)
            if not batch and not expired:
                return total
            if batch:
                self._dispatch(batch)
                batches += 1
            total += len(batch) + len(expired)
        return total

    def _fail_expired(self, expired: List[_Entry]) -> None:
        if not expired:
            return
        now = time.monotonic()
        with self._dispatch_lock:
            self._stats.expired += len(expired)
            for entry in expired:
                t = entry.request.tenant
                self._stats.tenant_expired[t] = \
                    self._stats.tenant_expired.get(t, 0) + 1
        for entry in expired:
            waited_ms = (now - entry.enqueued) * 1e3
            try:
                entry.future.set_exception(
                    DeadlineExceeded(entry.request, waited_ms))
            except InvalidStateError:
                pass                 # cancelled while queued: drop quietly

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, batch: List[_Entry]) -> None:
        try:
            with self._dispatch_lock:
                groups: Dict[str, List[_Entry]] = {}
                for entry in batch:
                    groups.setdefault(entry.request.kind, []).append(entry)
                if self._stream is None:
                    snap = self._refresh_snapshot()
                    for kind, group in groups.items():
                        self._dispatch_group(kind, group, snap, _deliver)
                    self._stats.answered += len(batch)
                else:
                    version = self.engine.version
                    self._stream.send(rs.BATCH, rs.encode_batch(
                        [(k, [e.request for e in g])
                         for k, g in groups.items()]), version=version,
                        groups=len(groups))
                    self._rank_batch(groups, version, None, _deliver)
                for entry in batch:
                    t = entry.request.tenant
                    self._stats.tenant_answered[t] = \
                        self._stats.tenant_answered.get(t, 0) + 1
        except Exception as exc:                       # noqa: BLE001
            # the admission loop must keep running: the batch's futures
            # carry the error (a refused launch, a device fault) instead
            for entry in batch:
                if not entry.future.done():
                    entry.future.set_exception(exc)

    # -- serving on ranks ----------------------------------------------------

    def follow(self) -> None:
        """Serve the leader's stream on a follower rank until the leader
        closes.  Each micro-batch is dispatched exactly as on the leader,
        its answers dropped; an event that failed on every rank is
        counted in ``failed_events`` and serving goes on with the next."""
        if self.leader:
            raise RuntimeError("follow() is for the follower ranks; the "
                               "leader (global rank 0) admits requests")
        while True:
            head, payload, error = self._stream.receive()
            if head.kind == rs.CLOSE:
                self._closed = True
                return
            if head.kind == rs.KEEPALIVE:
                continue
            with self._dispatch_lock:
                try:
                    self._follow_event(head, payload, error)
                except Exception:                      # noqa: BLE001
                    # every rank raised this step's error (agree_or_raise)
                    self.failed_events += 1

    def _follow_event(self, head, payload, error) -> None:
        if head.kind == rs.BATCH:
            groups: Dict[str, List[_Entry]] = {}
            if error is None:
                try:
                    for kind, reqs in rs.decode_batch(payload,
                                                      REQUEST_TYPES):
                        groups[kind] = [_Entry(r, None, 0.0, None)
                                        for r in reqs]
                    if len(groups) != head.groups:
                        raise ValueError(f"{len(groups)} kind groups "
                                         f"decoded, {head.groups} sent")
                except Exception as exc:               # noqa: BLE001
                    error = exc
            self._rank_batch(groups, head.version, error, None)
        elif head.kind == rs.UPDATE:
            edits = ([], [])
            if error is None:
                try:
                    edits = rs.decode_edits(payload)
                except Exception as exc:               # noqa: BLE001
                    error = exc
            self._rank_update(*edits, head.version, error)
            self._stats.updates += 1
        else:                                          # rs.CHECKPOINT
            if error is None:
                try:
                    spec = coll.decode_json(payload)
                    if (self._store is None
                            or str(self._store.path) != spec["path"]):
                        self._store = IndexStore(
                            spec["path"],
                            checkpoint_every=spec["checkpoint_every"],
                            verify=spec["verify"])
                except Exception as exc:               # noqa: BLE001
                    error = exc
            self._rank_checkpoint(self._store, error)

    def _rank_checkpoint(self, store, error: Optional[Exception]) -> None:
        """The checkpoint event on every rank: the store's rank route
        (``IndexStore.checkpoint`` + ``attach``) at the same point of the
        stream."""
        coll.agree_or_raise(self._ranks, "checkpoint", error)
        store.checkpoint(self.engine)
        store.attach(self.engine)

    def _rank_batch(self, groups: Dict[str, List[_Entry]], version: int,
                    error: Optional[Exception], deliver) -> None:
        """One micro-batch on every rank: the ids and the engine version
        checked here before any collective, the snapshot swap, then each
        kind group, each step closed by one status word, so a rank's
        failure fails the step on every rank instead of leaving the
        others in a collective.  ``deliver(entry, answer)`` resolves a
        group's futures once every rank answered it (``None`` on a
        follower, which drops its answers)."""
        mesh = self._ranks
        if error is None:
            try:
                self._check_batch(groups, version)
            except Exception as exc:                   # noqa: BLE001
                error = exc
        coll.agree_or_raise(mesh, "micro-batch", error)
        error, snap = None, None
        try:
            snap = self._refresh_snapshot()
        except Exception as exc:                       # noqa: BLE001
            error = exc
        coll.agree_or_raise(mesh, "snapshot refresh", error)
        for kind, group in groups.items():
            answers: List[Tuple[_Entry, object]] = []
            error = None
            try:
                self._dispatch_group(kind, group, snap,
                                     lambda e, v: answers.append((e, v)))
            except Exception as exc:                   # noqa: BLE001
                error = exc
            coll.agree_or_raise(mesh, f"{kind} group", error)
            if deliver is not None:
                for entry, value in answers:
                    deliver(entry, value)
        self._stats.answered += sum(len(g) for g in groups.values())

    def _check_batch(self, groups: Dict[str, List[_Entry]],
                     version: int) -> None:
        """What each rank holds a received batch to before its first
        collective (C-watch-7): the engine version the leader served at,
        and every id in ``[0, n)`` of this rank's engine."""
        if self.engine.version != version:
            raise RuntimeError(f"engine version {self.engine.version} on "
                               f"this rank, {version} on the leader")
        for group in groups.values():
            for entry in group:
                self._validate_fields(entry.request)

    def _rank_update(self, inserts, deletes, version: int,
                     error: Optional[Exception] = None) -> None:
        """The update event on every rank: the version checked, then the
        engine's own update on ranks (its edits agreed, journaled from
        rank 0 when a store is attached), each step closed by a status
        word."""
        if error is None and self.engine.version != version:
            error = RuntimeError(f"engine version {self.engine.version} on "
                                 f"this rank, {version} on the leader")
        coll.agree_or_raise(self._ranks, "update", error)
        error = None
        try:
            self.engine.update(inserts, deletes)
        except Exception as exc:                       # noqa: BLE001
            error = exc
        coll.agree_or_raise(self._ranks, "update", error)

    def _dispatch_group(self, kind: str, group: List[_Entry], snap,
                        deliver) -> None:
        if kind in _KIND_TO_OP:
            self._dispatch_workload_group(kind, group, deliver)
            return
        q = len(group)
        us, vs = self._batch_ids(group)
        bucket = us.size
        self._stats.batches += 1
        self._stats.padded_queries += bucket - q
        self._stats.bucket_histogram[bucket] = \
            self._stats.bucket_histogram.get(bucket, 0) + 1
        if isinstance(snap, KernelSnapshot):
            self._stats.kernel_batches += 1

        if kind == "mr":
            if snap is not None:
                mr = self._snapshot_mr(snap, us, vs)[:q]
            else:
                mr = np.asarray(self.engine.mr_batch(us, vs))[:q]
            for entry, val in zip(group, mr):
                deliver(entry, int(val))
            return

        svals = np.fromiter((e.request.s for e in group), np.int64, q)
        if snap is not None:
            # one join answers every s at once: s_reach == mr >= s
            ok = self._snapshot_mr(snap, us, vs)[:q] >= svals
        elif svals.size and (svals == svals[0]).all():
            # uniform s: the backend's native (possibly cheaper) batch path
            ok = np.asarray(
                self.engine.s_reach_batch(us, vs, int(svals[0])))[:q]
        else:
            ok = np.asarray(self.engine.mr_batch(us, vs))[:q] >= svals
        for entry, val in zip(group, ok):
            deliver(entry, bool(val))

    def _dispatch_workload_group(self, kind: str, group: List[_Entry],
                                 deliver) -> None:
        """Workload kinds dispatch per-request through the engine's
        workload methods — witness reconstruction and the BFS-gated ops
        are host-side, while ``mr_set`` / ``top_s`` batch internally
        through ``mr_batch`` (the ``label_join_gather`` kernel when the
        engine enables it; ids were held to ``[0, n)`` at admission).
        Each kind still arrives as its own group, so workload traffic
        never perturbs the padded mr/s_reach bucket shapes."""
        eng = self.engine
        self._stats.batches += 1
        self._stats.workload_answered[kind] = \
            self._stats.workload_answered.get(kind, 0) + len(group)
        for entry in group:
            r = entry.request
            if kind == "witness":
                val = eng.mr_witness(r.u, r.v)
            elif kind == "s_reach_k":
                val = bool(eng.s_reach_k(r.u, r.v, r.s, r.k))
            elif kind == "mr_set":
                val = int(eng.mr_set(np.asarray(r.us, np.int64),
                                     np.asarray(r.vs, np.int64)))
            elif kind == "top_s":
                verts, vals = eng.top_s(r.u, r.k)
                val = tuple(zip(verts.tolist(), vals.tolist()))
            else:                    # s_distance (admission pinned kinds)
                val = int(eng.s_distance(r.u, r.v, r.s))
            deliver(entry, val)

    def _batch_ids(self, group: List[_Entry]) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        """The group's ``(us, vs)`` as int64 host arrays, padded to the
        admission bucket with a repeat of the first (real, validated)
        pair — inert: answers past the group's size are dropped before
        the scatter."""
        q = len(group)
        us = np.fromiter((e.request.u for e in group), np.int64, q)
        vs = np.fromiter((e.request.v for e in group), np.int64, q)
        bucket = _bucket_size(q, self.min_bucket, self.max_batch)
        if bucket > q:
            us = np.concatenate([us, np.full(bucket - q, us[0])])
            vs = np.concatenate([vs, np.full(bucket - q, vs[0])])
        return us, vs

    def _snapshot_mr(self, snap, us: np.ndarray, vs: np.ndarray
                     ) -> np.ndarray:
        """MR of one padded group off the serving snapshot: the ids land
        on its device in one copy, the join runs there (one
        ``label_join_gather`` launch through a ``KernelSnapshot``), and
        the ``[bucket]`` int32 answers come back in one copy — the
        group's only synchronisation."""
        pairs = torch.from_numpy(np.stack([us, vs])).to(snap.device)
        return snap.mr(pairs[0], pairs[1]).cpu().numpy()

    # -- snapshot lifecycle ------------------------------------------------

    def _refresh_snapshot(self):
        """The version-keyed snapshot swap, run between micro-batches
        (callers hold ``_dispatch_lock``).  Returns the resident serving
        snapshot, or None for snapshot-less backends."""
        eng = self.engine
        if self._snapshot_ok is False:
            return None
        if self._snap is not None and self._snap.version == eng.version:
            return self._serving_view()
        prev_host = self._host_snap
        try:
            # the fan-out hook: fresh snapshot (a scoped update left the
            # stale one as the patch basis, so only its dirty rows are
            # re-derived) + the row delta relative to prev_host (None if
            # the delta is unknowable and we must re-land in full)
            host, dirty = eng.snapshot_delta(prev_host)
        except SnapshotUnsupported:
            self._snapshot_ok = False
            return None
        self._snapshot_ok = True
        if host is prev_host and self._snap is not None:
            return self._serving_view()
        self._stats.snapshot_refreshes += 1
        self._stats.rows_rederived += int(eng.last_snapshot_refresh_rows)
        self._stats.rows_full += int(eng.h.n)
        if self.mesh is not None and not self._already_on_mesh(host):
            base = self._snap if (prev_host is not None
                                  and dirty is not None) else None
            # base is private to the service and dropped at the swap, so
            # its tensors are safe to donate (the rows land in place)
            snap = host.to_mesh(self.mesh, self.axes, base=base,
                                dirty_rows=dirty if base is not None
                                else None, donate_base=True)
            if base is not None and snap.ranks.shape == base.ranks.shape:
                self._stats.mesh_rows_patched += int(np.asarray(dirty).size)
        else:
            snap = host
        # single reference assignment = the atomic swap; in-flight code
        # never observes a half-updated snapshot
        self._host_snap, self._snap = host, snap
        return self._serving_view()

    def _serving_view(self):
        """The view micro-batches answer through: the resident snapshot,
        or — with ``use_kernels`` — a ``KernelSnapshot`` over it, rebuilt
        at every swap (so a patched snapshot can never be served through
        a stale wrapper)."""
        if not self.use_kernels or self._snap is None:
            return self._snap
        kv = self._kernel_snap
        if kv is None or kv.base is not self._snap:
            kv = KernelSnapshot(self._snap)
            self._kernel_snap = kv
        return kv

    def _already_on_mesh(self, snap) -> bool:
        """True when the engine's snapshot already sits on this service's
        mesh (the ``sharded`` backend derives mesh-resident snapshots: a
        label block of a ``ProcessMesh``, or the closure regime's
        snapshot kept on it) — re-landing it through ``to_mesh`` would
        keep a duplicate copy."""
        return getattr(snap, "mesh", None) == self.mesh
