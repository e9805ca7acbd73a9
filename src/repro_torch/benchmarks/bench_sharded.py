"""Sharded-vs-closure benchmark sweep over logical grid layouts, on the
port (the reference's ``benchmarks/bench_sharded.py``: same arguments and
keys, plus an ``env`` block and each result's ``layout``).

The reference runs one subprocess per host-device count, because its
device count is fixed when JAX starts.  The port's mesh is a logical grid
of blocks on one device (``repro_torch.core.mesh``), so one process runs
every layout: 1 block (1 x 1), 2 (1 x 2) and 4 (2 x 2), the near-square
grid for each count, each with both schedules (allgather, ring) through
``paper_tables.sharded_suite``, every row cross-validated against the
``mst-oracle``.  Writes ``build/bench_torch/BENCH_sharded.json``.

The grid is logical: on one card its blocks are views of one tensor, so
a row measures block contractions (float32 ``maxmin_matmul`` launches),
never a collective; compare allgather vs ring and the 1-block parity
with ``closure``.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_sharded
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_sharded --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_sharded --worker
"""
from __future__ import annotations

import argparse
import json
from typing import Sequence, Tuple

from repro_torch.device import DeviceLike, resolve_device

from .common import add_common_args, env_block, write_doc


def layout(blocks: int) -> Tuple[int, int]:
    """The near-square ``r x c`` grid of ``blocks`` blocks (4 -> 2 x 2,
    2 -> 1 x 2), as ``default_line_graph_mesh`` factors a device count."""
    r = max(1, int(blocks ** 0.5))
    while blocks % r:
        r -= 1
    return r, blocks // r


def rows_for(dataset: str, n_q: int, blocks: int, device: DeviceLike):
    from repro_torch.core.mesh import make_mesh

    from . import paper_tables as pt

    mesh = make_mesh(layout(blocks), ("data", "model"), device=device)
    return [(name, float(val), unit)
            for name, val, unit in pt.sharded_suite(dataset, n_q=n_q,
                                                    mesh=mesh)]


def worker(dataset: str, n_q: int, blocks: int = 1,
           device: DeviceLike = None) -> None:
    print(json.dumps(rows_for(dataset, n_q, blocks, device)))


def sweep(dataset: str, n_q: int, device_counts: Sequence[int],
          out_path: str, *, device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    results = []
    for nd in device_counts:
        rows = rows_for(dataset, n_q, nd, dev)
        results.append({"devices": nd, "layout": list(layout(nd)),
                        "rows": rows})
        for name, val, unit in rows:
            print(f"{name},{val:.3f},{unit}")
    doc = {
        "dataset": dataset,
        "n_q": n_q,
        "note": ("a logical grid of blocks on one device: every layout "
                 "measures block contractions (float32 maxmin_matmul "
                 "launches on the card), never a collective; compare "
                 "allgather vs ring and 1-block parity with 'closure'"),
        "results": results,
        "env": env_block(dev),
    }
    write_doc(doc, out_path)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true",
                    help="measure one layout (the first --devices count), "
                         "print JSON rows")
    ap.add_argument("--dataset", default="ENG-s")
    ap.add_argument("--n-q", type=int, default=128)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4],
                    help="block counts of the logical grids to sweep")
    add_common_args(ap, "sharded")
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.dataset, args.n_q, args.devices[0], args.device)
    else:
        sweep(args.dataset, args.n_q, args.devices, args.out,
              device=args.device)


if __name__ == "__main__":
    main()
