"""Warm restart vs cold rebuild (repro_torch.store), on the port (the
reference's ``benchmarks/bench_persistence.py``: same arguments,
assertions and keys, plus an ``env`` block).

The durable-store claim is tracked as a number, not prose: a serving
restart should pay page-in cost, not construction cost.  For each graph
size this sweep measures

* **cold** — build the HL-index from the in-memory hypergraph (what
  every restart used to cost),
* **warm** — ``load_index`` of a saved checkpoint (mmap + view setup),
* **warm+replay** — ``IndexStore.restore``: checkpoint load plus a
  K-record WAL suffix replayed through scoped maintenance (the
  crash-recovery path),

asserts the loaded labels byte-identical to the freshly built ones and
every answer equal to the independent ``mst-oracle``, and writes
``build/bench_torch/BENCH_persistence.json``.  Loads and restores land
on ``--device`` (the card by default), and the engines answer through the
``label_join_gather`` kernel there.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_persistence
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_persistence \\
      --quick --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

from .common import add_common_args, env_block, write_doc


def _update_stream(h, k, seed=11):
    """Deterministic K-batch update stream (valid at every step)."""
    rng = np.random.default_rng(seed)
    m = h.m
    batches = []
    for i in range(k):
        ins = [sorted(int(x) for x in rng.choice(h.n, 3, replace=False))]
        dels = [int(rng.integers(0, m))] if i % 3 == 2 else []
        m += len(ins) - len(dels)
        batches.append((ins, dels))
    return batches


def bench_size(n: int, m: int, wal_records: int, n_queries: int,
               seed: int = 0, *, device: DeviceLike = None) -> dict:
    from repro_torch.api import build_engine, random_hypergraph
    from repro_torch.core.baselines import MSTOracle
    from repro_torch.store import IndexStore, load_index, save_index

    dev = resolve_device(device)
    h = random_hypergraph(n, m, min_size=2, max_size=6, seed=seed)

    t0 = time.perf_counter()
    eng = build_engine(h, "hl-index", device=dev, use_kernels=True)
    cold_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ckpt.hlidx")
        t0 = time.perf_counter()
        save_index(path, eng)
        save_s = time.perf_counter() - t0
        index_bytes = os.path.getsize(path)

        t0 = time.perf_counter()
        warm = load_index(path, device=dev)
        warm.use_kernels = True          # a load keeps no such flag
        warm_s = time.perf_counter() - t0

        # the tentpole assertion: loaded labels byte-identical to built
        assert np.array_equal(eng.idx.rank, warm.idx.rank)
        assert np.array_equal(eng.idx.perm, warm.idx.perm)
        for u in range(h.n):
            for attr in ("labels_edge", "labels_rank", "labels_s"):
                a, b = getattr(eng.idx, attr)[u], getattr(warm.idx, attr)[u]
                assert a.dtype == b.dtype and np.array_equal(a, b), (n, u)

        rng = np.random.default_rng(1)
        us = rng.integers(0, h.n, n_queries)
        vs = rng.integers(0, h.n, n_queries)
        oracle = MSTOracle(h)
        want = np.array([oracle.mr(int(u), int(v)) for u, v in zip(us, vs)],
                        np.int64)
        np.testing.assert_array_equal(
            np.asarray(warm.mr_batch(us, vs)).astype(np.int64), want)

        # crash-recovery path: checkpoint + K journaled updates replayed
        store_dir = os.path.join(td, "store")
        store = IndexStore(store_dir)
        store.attach(eng)
        batches = _update_stream(h, wal_records)
        for ins, dels in batches:
            eng.update(inserts=ins, deletes=dels)
        store.close()
        t0 = time.perf_counter()
        replayed = IndexStore(store_dir).restore(attach=False, device=dev)
        replayed.use_kernels = True
        replay_s = time.perf_counter() - t0
        assert replayed.version == eng.version == wal_records
        oracle2 = MSTOracle(eng.h)
        us2 = rng.integers(0, eng.h.n, n_queries)
        vs2 = rng.integers(0, eng.h.n, n_queries)
        want2 = np.array([oracle2.mr(int(u), int(v))
                          for u, v in zip(us2, vs2)], np.int64)
        np.testing.assert_array_equal(
            np.asarray(replayed.mr_batch(us2, vs2)).astype(np.int64), want2)

    return {
        "n": int(n),
        "m": int(m),
        "wal_records": int(wal_records),
        "index_bytes": int(index_bytes),
        "cold_build_ms": cold_s * 1e3,
        "save_ms": save_s * 1e3,
        "warm_load_ms": warm_s * 1e3,
        "load_replay_ms": replay_s * 1e3,
        "warm_speedup": cold_s / max(warm_s, 1e-12),
        "answers_checked": 2 * n_queries,
    }


def sweep(sizes, wal_records: int, n_queries: int, out_path: str, *,
          device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    results = [bench_size(n, m, wal_records, n_queries, device=dev)
               for n, m in sizes]
    for row in results:
        print(f"persistence n={row['n']} m={row['m']}: cold build "
              f"{row['cold_build_ms']:.1f} ms vs warm load "
              f"{row['warm_load_ms']:.2f} ms -> {row['warm_speedup']:.0f}x "
              f"(load+{row['wal_records']}-record replay "
              f"{row['load_replay_ms']:.1f} ms, "
              f"{row['index_bytes'] / 1024:.0f} KiB on disk, "
              f"{row['answers_checked']} answers verified)")
    doc = {
        "wal_records": wal_records,
        "note": ("cold = build_engine(h, 'hl-index') from the in-memory "
                 "graph; warm = load_index of the saved checkpoint (mmap, "
                 "no construction); load_replay = IndexStore.restore with "
                 "a K-record WAL suffix replayed through scoped "
                 "maintenance.  Loaded labels asserted byte-identical to "
                 "freshly built ones and every answer asserted equal to "
                 "the mst-oracle."),
        "results": results,
        "env": env_block(dev),
    }
    write_doc(doc, out_path)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="tiny sizes for a smoke run")
    ap.add_argument("--wal-records", type=int, default=None)
    ap.add_argument("--n-queries", type=int, default=40)
    add_common_args(ap, "persistence")
    args = ap.parse_args(argv)
    if args.quick:
        sizes = [(120, 150), (300, 380)]
        wal_records = args.wal_records or 4
    else:
        sizes = [(300, 380), (900, 1100), (2000, 2600), (4000, 5200)]
        wal_records = args.wal_records or 8
    sweep(sizes, wal_records, args.n_queries, args.out, device=args.device)


if __name__ == "__main__":
    main()
