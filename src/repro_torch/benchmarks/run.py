"""Benchmark entry point of the port: one function per paper table.
Prints ``name,value,unit`` CSV rows (per-query us, total-us, bytes,
counts), the reference's rows (``benchmarks/run.py``) but for its
``Min-batched-jax`` row, which is ``Min-batched-torch-ops`` and
``Min-batched-kernel`` here.

  PYTHONPATH=src python -m repro_torch.benchmarks.run              # card
  PYTHONPATH=src python -m repro_torch.benchmarks.run --quick      # subset
  PYTHONPATH=src python -m repro_torch.benchmarks.run --quick --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple


def collect(quick: bool, device: str = "cuda") -> List[Tuple[str, float, str]]:
    """Every row of the suite (or of its ``quick`` subset) on ``device``."""
    from repro_torch.device import resolve_device

    from . import kernels_bench as kb
    from . import paper_tables as pt

    dev = resolve_device(device)
    rows = []
    # Exp-1: query time (paper Fig. 2)
    for ds in (["NC-s", "BK-s"] if quick else
               ["NC-s", "BK-s", "PS-s", "EE-s"]):
        rows += pt.exp1_query_time(ds, n_q=300 if quick else 1000,
                                   include_online=not quick or ds == "NC-s",
                                   device=dev)
    # Exp-2: indexing time (Table IV, time)
    for ds in (["NC-s"] if quick else ["NC-s", "BK-s", "PS-s"]):
        rows += pt.exp2_indexing_time(ds, include_basic=(ds == "NC-s"))
    # Exp-3: space (Table IV, space)
    for ds in (["BK-s"] if quick else ["NC-s", "BK-s", "EE-s"]):
        rows += pt.exp3_space(ds)
    # Exp-4: scalability (Fig. 3)
    if not quick:
        rows += pt.exp4_scalability("WA-s")
    # Exp-5: case study (Fig. 4)
    rows += pt.exp5_case_study(device=dev)
    # unified engine API: every registered backend built, benchmarked and
    # cross-validated through the repro_torch.api facade
    rows += pt.engine_suite("ENG-s", n_q=64 if quick else 128, device=dev)
    # sharded backend vs single-device closure, both schedules (larger
    # logical grids come from repro_torch.benchmarks.bench_sharded)
    rows += pt.sharded_suite("ENG-s", n_q=64 if quick else 128, device=dev)
    # kernel/closure layer
    rows += kb.closure_bench(m=256 if quick else 512, device=dev)
    return rows


def print_csv(rows) -> None:
    print("name,value,unit")
    for name, val, unit in rows:
        print(f"{name},{float(val):.3f},{unit}")


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print_csv(collect(args.quick, args.device))


if __name__ == "__main__":
    main()
