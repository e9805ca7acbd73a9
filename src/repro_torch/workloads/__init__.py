"""Query-workload subsystem: one HL-index, many workloads.

Five query families answered off the existing label/closure machinery
(engine methods gate them per backend; ``WorkloadUnsupported`` when a
backend can't serve one):

* witness extraction — ``engine.mr_witness(u, v)`` -> ``Witness``
* hop-bounded s-reach — ``engine.s_reach_k(u, v, s, k)`` -> bool
* set-to-set / multi-source MR — ``engine.mr_set(U, V)`` /
  ``engine.mr_from_set(U, targets)``
* top-k strongest-s ranking — ``engine.top_s(u, k)``
* landmark s-distance — ``engine.s_distance(u, v, s)`` (certified
  upper bounds; ``DistanceOracle`` is the standalone structure)

Counterpart of ``repro/workloads``: host numpy, as in the reference.
On the device run ``mr_set`` / ``mr_from_set`` / ``top_s`` (one
``mr_batch`` each: the ``label_join_gather`` kernel on the label
backends with ``use_kernels``) and ``frontier``'s bounded ``s_reach_k``
(its sweep).  Brute-force references live in
``repro_torch.core.baselines``.
"""
from repro_torch.core.engine import (WORKLOAD_OPS, WorkloadUnsupported,
                                     workload_capabilities)

from .base import Witness, walk_wod, verify_witness
from .hop_bounded import bounded_s_distance, hop_bounded_s_reach
from .oracle import DistanceOracle
from .setops import cross_pairs, normalize_vertex_set
from .topk import select_top_s
from .witness import extract_witness

__all__ = [
    "WORKLOAD_OPS", "Witness", "WorkloadUnsupported",
    "workload_capabilities", "walk_wod", "verify_witness",
    "extract_witness", "bounded_s_distance", "hop_bounded_s_reach",
    "DistanceOracle", "cross_pairs", "normalize_vertex_set",
    "select_top_s",
]
