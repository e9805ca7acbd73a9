"""Serving substrate.

Two independent serving stacks live here, as in the reference:

* ``reach_service`` — ``ReachabilityService`` (typed requests, futures,
  admission micro-batching, version-keyed snapshot reuse) over any
  ``ReachabilityEngine`` backend; ``scheduler`` its weighted-fair
  admission queue; ``replicas`` the read-replica ``ReplicaGroup``;
* ``serve_step`` / ``kvcache`` — LM prefill and greedy decode.

Exports resolve lazily, so importing the reachability service (or
``repro_torch.api``) never pulls the LM model stack into the process.
"""
from typing import TYPE_CHECKING

_LAZY = {
    "make_serve_step": "serve_step",
    "make_prefill_step": "serve_step",
    "prefill_with_decode": "kvcache",
    "greedy_decode": "kvcache",
    "ReachabilityService": "reach_service",
    "Request": "reach_service",
    "MRRequest": "reach_service",
    "SReachRequest": "reach_service",
    "WitnessRequest": "reach_service",
    "SReachKRequest": "reach_service",
    "MRSetRequest": "reach_service",
    "TopSRequest": "reach_service",
    "SDistanceRequest": "reach_service",
    "ServiceConfig": "reach_service",
    "ServiceStats": "reach_service",
    "REQUEST_TYPES": "reach_service",
    "PRIORITY_CLASSES": "scheduler",
    "TenantSpec": "scheduler",
    "DeadlineExceeded": "scheduler",
    "WeightedFairScheduler": "scheduler",
    "Replica": "replicas",
    "ReplicaGroup": "replicas",
}

__all__ = sorted(_LAZY)

if TYPE_CHECKING:  # pragma: no cover - static analysis only
    from .kvcache import greedy_decode, prefill_with_decode      # noqa: F401
    from .reach_service import (MRRequest, MRSetRequest,         # noqa: F401
                                ReachabilityService, Request, REQUEST_TYPES,
                                SDistanceRequest, ServiceConfig,
                                ServiceStats, SReachKRequest, SReachRequest,
                                TopSRequest, WitnessRequest)
    from .replicas import Replica, ReplicaGroup                  # noqa: F401
    from .scheduler import (DeadlineExceeded, PRIORITY_CLASSES,  # noqa: F401
                            TenantSpec, WeightedFairScheduler)
    from .serve_step import make_prefill_step, make_serve_step   # noqa: F401


def __getattr__(name: str):
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
