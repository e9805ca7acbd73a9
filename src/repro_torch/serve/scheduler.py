"""Multi-tenant admission scheduling: priority bands + weighted fairness.

``ReachabilityService`` used to drain its queue FIFO, which is the wrong
policy the moment two consumers share one index: a tenant flooding
``submit_many`` pushes everyone else's requests behind its own backlog,
and a latency-sensitive probe waits behind thousands of batch-analytics
queries.  This module is the admission policy that replaces it:

* **Priority classes** (``PRIORITY_CLASSES``) are *strict* bands: a
  micro-batch takes every schedulable ``interactive`` request before the
  first ``standard`` one, and so on.  Priorities order work; they do not
  starve it — a band only yields to a higher band's actual backlog, and
  fairness below operates within each band.
* **Deficit-weighted round-robin across tenants** within a band
  (Shreedhar & Varghese DRR): each (band, tenant) queue accrues
  ``quantum * weight`` credits per scheduling pass and releases one
  request per credit.  Over any backlogged interval, tenant throughput
  converges to the weight ratio, so a greedy tenant's flood cannot
  delay a light tenant by more than one micro-batch — the bound the
  starvation tests assert.  Deficits reset when a tenant's queue
  empties (idle tenants bank no credit) and are capped at one batch, so
  a returning tenant cannot burst past its fair share.
* **Deadlines fail fast**: requests carry an optional ``deadline_ms``;
  an expired request is dropped at scheduling time and its future fails
  with ``DeadlineExceeded`` — it never occupies a bucket slot that a
  live request could use.

The scheduler is deliberately not thread-safe on its own: the service
already serializes admission under its condition variable, and keeping
locking out of this module makes the policy directly unit-testable.

Counterpart of ``repro/serve/scheduler.py``, kept line for line: the
same pushes and takes select the same entries in the same order
(tests/test_torch_multitenant.py holds the two side by side).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional, Tuple

__all__ = ["PRIORITY_CLASSES", "TenantSpec", "DeadlineExceeded",
           "WeightedFairScheduler"]

# priority class -> band index; lower band = served strictly first
PRIORITY_CLASSES: Dict[str, int] = {
    "interactive": 0,
    "standard": 1,
    "batch": 2,
}


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Declared share of one tenant: requests tagged ``tenant=name``
    receive service proportional to ``weight`` (relative to the other
    tenants backlogged in the same priority band).  Tenants never named
    in a spec get ``ServiceConfig.default_weight``."""

    name: str
    weight: float = 1.0

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise ValueError(
                f"tenant name must be a non-empty string; got {self.name!r}")
        w = float(self.weight)
        if not w > 0:
            raise ValueError(
                f"tenant {self.name!r} weight must be > 0; got {self.weight!r}")
        object.__setattr__(self, "weight", w)


class DeadlineExceeded(TimeoutError):
    """A request's ``deadline_ms`` elapsed before a micro-batch could
    take it.  Raised *through the future* (fail-fast at scheduling time)
    — the request never reaches the device."""

    def __init__(self, request, waited_ms: float):
        self.request = request
        self.waited_ms = float(waited_ms)
        super().__init__(
            f"{type(request).__name__} expired after waiting "
            f"{self.waited_ms:.2f} ms (deadline_ms="
            f"{request.deadline_ms!r})")


@dataclasses.dataclass
class _Entry:
    """One queued request: the future to resolve plus scheduling state
    (absolute expiry precomputed so ``take`` compares, not adds)."""

    request: object
    future: Future
    enqueued: float                     # time.monotonic() at submit
    expiry: Optional[float]             # absolute monotonic deadline


class WeightedFairScheduler:
    """Two-level admission queue: strict priority bands, deficit-weighted
    round-robin (DRR) across tenants within each band, FIFO within a
    (band, tenant) queue.

    ``take(limit, now)`` fills a micro-batch: it always returns as many
    schedulable requests as the limit allows (fairness shapes the batch
    *composition* under backlog, it never leaves bucket slots idle), plus
    the expired entries it swept aside, for the caller to fail.
    """

    def __init__(self, tenants: Tuple[TenantSpec, ...] = (), *,
                 default_weight: float = 1.0, quantum: int = 8):
        if not float(default_weight) > 0:
            raise ValueError(
                f"default_weight must be > 0; got {default_weight!r}")
        if int(quantum) < 1:
            raise ValueError(f"quantum must be >= 1; got {quantum!r}")
        self.quantum = int(quantum)
        self.default_weight = float(default_weight)
        self._weights: Dict[str, float] = {}
        for spec in tenants:
            if not isinstance(spec, TenantSpec):
                spec = TenantSpec(*spec) if isinstance(spec, tuple) \
                    else TenantSpec(**spec) if isinstance(spec, dict) \
                    else TenantSpec(str(spec))
            if spec.name in self._weights:
                raise ValueError(f"duplicate tenant spec {spec.name!r}")
            self._weights[spec.name] = spec.weight
        # band -> tenant -> FIFO queue; OrderedDict keeps the round-robin
        # order deterministic (insertion order of first pending request)
        self._bands: Dict[int, "OrderedDict[str, Deque[_Entry]]"] = {}
        self._deficit: Dict[Tuple[int, str], float] = {}
        self._size = 0

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self.default_weight)

    def __len__(self) -> int:
        return self._size

    def push(self, entry: _Entry) -> None:
        req = entry.request
        band = PRIORITY_CLASSES[req.priority]
        tenants = self._bands.setdefault(band, OrderedDict())
        queue = tenants.get(req.tenant)
        if queue is None:
            queue = tenants[req.tenant] = deque()
        queue.append(entry)
        self._size += 1

    def take(self, limit: int,
             now: float) -> Tuple[List[_Entry], List[_Entry]]:
        """Select up to ``limit`` entries for the next micro-batch.

        Returns ``(selected, expired)``: ``selected`` in dispatch order
        (strict bands, DRR within each), ``expired`` the entries whose
        deadline passed — swept out without consuming any deficit, so an
        expired flood costs its tenant nothing *and* frees no one else's
        share.  Each full DRR pass over a band's backlogged tenants
        accrues ``quantum * weight`` credit per tenant, so the loop
        always progresses (weights are validated > 0)."""
        selected: List[_Entry] = []
        expired: List[_Entry] = []
        if limit < 1:
            return selected, expired
        for band in sorted(self._bands):
            tenants = self._bands[band]
            while tenants and len(selected) < limit:
                for name in list(tenants):
                    queue = tenants[name]
                    key = (band, name)
                    # cap at one batch: an idle-then-bursting tenant can
                    # claim at most a full micro-batch of banked credit
                    deficit = min(
                        self._deficit.get(key, 0.0)
                        + self.quantum * self.weight(name),
                        float(limit))
                    while queue and len(selected) < limit:
                        head = queue[0]
                        if head.expiry is not None and now >= head.expiry:
                            expired.append(queue.popleft())
                            self._size -= 1
                            continue
                        if deficit < 1.0:
                            break
                        deficit -= 1.0
                        selected.append(queue.popleft())
                        self._size -= 1
                    if queue:
                        self._deficit[key] = deficit
                    else:
                        # DRR: an emptied queue forfeits residual credit
                        del tenants[name]
                        self._deficit.pop(key, None)
                    if len(selected) >= limit:
                        break
            if len(selected) >= limit:
                break
        # drop emptied bands so sorted() stays O(#active bands)
        for band in [b for b, t in self._bands.items() if not t]:
            del self._bands[band]
        return selected, expired

    def backlog(self) -> Dict[str, int]:
        """Pending request count per tenant (diagnostics/tests)."""
        counts: Dict[str, int] = {}
        for tenants in self._bands.values():
            for name, queue in tenants.items():
                counts[name] = counts.get(name, 0) + len(queue)
        return counts
