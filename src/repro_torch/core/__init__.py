"""Core library of the port: hypergraph, HL-index construction and
minimisation (host, numpy), padded label snapshots and batched joins
(device, torch), the index-free and baseline structures, and the engine
facade over them.

The index-free and baseline structures are exported here under the
reference's names (``repro.core``): Algorithm 1 (``mr_online``,
``NeighborCache``), the Section IV / VII baselines (``vtv_query``,
``ETEIndex``, ``build_ete``, ``ThresholdComponentIndex``), the
brute-force workload references (``brute_force_*``) and the sparse
frontier sweeps (``SparseLineGraph``, ``frontier_batched_s_reach``,
``frontier_batched_mr``).  Everything else is imported from its module.
"""
from .online import mr_online, precompute_neighbors, NeighborCache
from .baselines import (vtv_query, ETEIndex, build_ete,
                        ThresholdComponentIndex, MSTOracle, line_graph_edges,
                        brute_force_s_distance, brute_force_s_reach_k,
                        brute_force_witness, brute_force_mr_set,
                        brute_force_mr_from_set, brute_force_top_s)
from .frontier import (SparseLineGraph, frontier_batched_s_reach,
                       frontier_batched_mr)

__all__ = [
    "mr_online", "precompute_neighbors", "NeighborCache",
    "vtv_query", "ETEIndex", "build_ete", "ThresholdComponentIndex",
    "MSTOracle", "line_graph_edges",
    "brute_force_s_distance", "brute_force_s_reach_k",
    "brute_force_witness", "brute_force_mr_set",
    "brute_force_mr_from_set", "brute_force_top_s",
    "SparseLineGraph", "frontier_batched_s_reach", "frontier_batched_mr",
]
