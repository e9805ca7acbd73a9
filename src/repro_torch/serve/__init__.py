"""Serving: the request-based reachability service.

``reach_service`` holds ``ReachabilityService`` (typed requests, futures,
admission micro-batching, version-keyed snapshot reuse) over any
``ReachabilityEngine`` backend; ``scheduler`` its weighted-fair admission
queue; ``replicas`` the read-replica ``ReplicaGroup``.  Exports resolve
lazily, as in the reference.  The reference's LM serving cells
(``serve_step``, ``kvcache``) are roadmap item A12.
"""
from typing import TYPE_CHECKING

_LAZY = {
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
    from .reach_service import (MRRequest, MRSetRequest,         # noqa: F401
                                ReachabilityService, Request, REQUEST_TYPES,
                                SDistanceRequest, ServiceConfig,
                                ServiceStats, SReachKRequest, SReachRequest,
                                TopSRequest, WitnessRequest)
    from .replicas import Replica, ReplicaGroup                  # noqa: F401
    from .scheduler import (DeadlineExceeded, PRIORITY_CLASSES,  # noqa: F401
                            TenantSpec, WeightedFairScheduler)


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
