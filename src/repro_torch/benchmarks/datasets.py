"""Benchmark datasets.

The paper's 20 datasets are not redistributable offline, so the benches
run on *synthetic stand-ins matched to the published statistics*: the
``-s`` rows of ``BENCH_DATASETS`` at the reference's CPU-bench scale
(same names, sizes and seeds as the reference's ``benchmarks/datasets.py``,
so both packages bench the same graphs), the structured generators
(``CHAIN``, ``COLO``), and ``PUBLISHED_DATASETS`` at the published |V| and
|E| of three of them, which the card runs (``chip_smoke.py``).

External hypergraphs load through the same entry point: any name ending
in ``.hif.json`` (or ``.hif``) is treated as a path to an HIF
(Hypergraph Interchange Format) file and imported via
``repro_torch.store.read_hif``.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

from repro_torch.core.hypergraph import (Hypergraph, colocation_hypergraph,
                                         planted_chain_hypergraph,
                                         random_hypergraph)
from repro_torch.store import read_hif

__all__ = ["BENCH_DATASETS", "PUBLISHED_DATASETS", "make_dataset",
           "dataset_params"]

# name -> (paper analog, n, m, min_size, max_size, seed)
BENCH_DATASETS: Dict[str, Tuple[str, int, int, int, int, int]] = {
    "NC-s": ("NDC-classes (1.2k/1.2k, η=5)", 600, 620, 2, 8, 1),
    "SS-s": ("small-world (10k/10k, η=6.6)", 1500, 1500, 2, 7, 2),
    "BK-s": ("BrightKite (4.3k/5.2k, η=3.9)", 900, 1100, 2, 6, 3),
    "PS-s": ("primary-school (242/12.7k, η=126)", 120, 2500, 2, 5, 4),
    "EE-s": ("email-Eu (998/25.8k, η=85)", 400, 4000, 2, 6, 5),
    "WA-s": ("walmart-trips (89k/70k, η=5)", 4000, 3200, 2, 8, 6),
    # small enough that every registry backend (incl. the dense closure)
    # can be built and cross-validated in the engine suite
    "ENG-s": ("engine-suite synthetic (all backends)", 200, 256, 2, 6, 7),
}

# the same stand-ins at their sources' published |V| and |E| (edge sizes
# and seeds of the -s rows): what one H100 holds and builds in seconds
PUBLISHED_DATASETS: Dict[str, Tuple[str, int, int, int, int, int]] = {
    "PS": ("primary-school (242/12,704)", 242, 12_704, 2, 5, 4),
    "EE": ("email-Eu (998/25,800)", 998, 25_800, 2, 6, 5),
    "WA": ("walmart-trips (89,000/70,000)", 89_000, 70_000, 2, 8, 6),
}


def dataset_params(name: str) -> Dict[str, int]:
    """``random_hypergraph`` keyword arguments of a named stand-in:
    ``n``, ``m``, ``min_size``, ``max_size``, ``seed``."""
    table = PUBLISHED_DATASETS if name in PUBLISHED_DATASETS else \
        BENCH_DATASETS
    _, n, m, lo, hi, seed = table[name]
    return dict(n=n, m=m, min_size=lo, max_size=hi, seed=seed)


def make_dataset(name: str) -> Hypergraph:
    if name.endswith((".hif.json", ".hif")):
        if not os.path.exists(name):
            raise FileNotFoundError(f"HIF dataset file not found: {name}")
        return read_hif(name)
    if name == "CHAIN":
        return planted_chain_hypergraph(20, 50, overlap=3, extra_size=2)
    if name == "COLO":
        return colocation_hypergraph(500, 20, 21, p_checkin=0.02, seed=0)
    p = dataset_params(name)
    return random_hypergraph(p["n"], p["m"], min_size=p["min_size"],
                             max_size=p["max_size"], seed=p["seed"])
