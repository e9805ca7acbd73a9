"""Scoped maintenance vs full rebuild across line-graph component counts,
on the port (the reference's ``benchmarks/bench_maintenance.py``: same
arguments, assertions and keys, plus an ``env`` block).

The scoped-maintenance claim (repro_torch.core.maintenance: construction
reruns only on the affected component) is tracked as a number, not
prose: for a graph of C disjoint chain components, each update touches
one component, so the ideal scoped/rebuild speedup is ~C.  This sweep
measures both paths on identical update sequences, asserts
answer-equality on every step, and writes
``build/bench_torch/BENCH_maintenance.json``.  The HL-index rows are host
construction (numpy); the ``sharded`` rows build and re-close on
``--device`` (a logical 1 x 1 grid on one card, block contractions
through the ``maxmin_matmul`` kernel there).

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_maintenance
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_maintenance \\
      --quick --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

from .common import add_common_args, env_block, write_doc


def _sample_queries(h, rng, q):
    us = rng.integers(0, h.n, q)
    vs = rng.integers(0, h.n, q)
    return us, vs


def bench_components(n_components: int, chain_len: int, reps: int,
                     n_queries: int, seed: int = 0) -> dict:
    """Time ``reps`` insert+delete update pairs, scoped vs full rebuild."""
    from repro_torch.core.hlindex import build_fast
    from repro_torch.core.hypergraph import planted_chain_hypergraph
    from repro_torch.core.maintenance import apply_updates
    from repro_torch.core.query import mr_query

    rng = np.random.default_rng(seed)
    h = planted_chain_hypergraph(n_components, chain_len, overlap=3,
                                 extra_size=2, seed=seed)
    idx = build_fast(h)
    m0 = h.m

    scoped_s = 0.0
    rebuild_s = 0.0
    scopes = []
    for r in range(reps):
        # insert a hyperedge into one chain (attach to that chain's head),
        # then delete it again — the graph returns to its start state, so
        # every rep measures the same-shaped update
        anchor = h.edge((r * chain_len) % h.m)
        ins = [int(anchor[0]), int(anchor[1]), h.n + r]

        t0 = time.perf_counter()
        h_ins, idx_ins, _ = apply_updates(h, idx, inserts=[ins])
        t1 = time.perf_counter()
        full_ins = build_fast(h_ins)
        t2 = time.perf_counter()
        scoped_s += t1 - t0
        rebuild_s += t2 - t1
        scopes.append(int(idx_ins.stats["maintenance_scope"]))

        us, vs = _sample_queries(h_ins, rng, n_queries)
        for u, v in zip(us, vs):
            a = mr_query(idx_ins, int(u), int(v))
            b = mr_query(full_ins, int(u), int(v))
            assert a == b, (n_components, r, int(u), int(v), a, b)

        t0 = time.perf_counter()
        h_del, idx_del, _ = apply_updates(h_ins, idx_ins,
                                          deletes=[h_ins.m - 1])
        t1 = time.perf_counter()
        full_del = build_fast(h_del)
        t2 = time.perf_counter()
        scoped_s += t1 - t0
        rebuild_s += t2 - t1
        scopes.append(int(idx_del.stats["maintenance_scope"]))

        us, vs = _sample_queries(h_del, rng, n_queries)
        for u, v in zip(us, vs):
            a = mr_query(idx_del, int(u), int(v))
            b = mr_query(full_del, int(u), int(v))
            assert a == b, (n_components, r, int(u), int(v), a, b)

    ops = 2 * reps
    return {
        "components": n_components,
        "m": int(m0),
        "n": int(h.n),
        "ops": ops,
        "mean_scope_edges": float(np.mean(scopes)),
        "scoped_ms_per_op": scoped_s / ops * 1e3,
        "rebuild_ms_per_op": rebuild_s / ops * 1e3,
        "speedup": rebuild_s / max(scoped_s, 1e-12),
        "answers_checked": ops * n_queries,
    }


def bench_sharded(n_components: int, chain_len: int, reps: int,
                  n_queries: int, *, labels: bool, seed: int = 0,
                  device: DeviceLike = None) -> dict:
    """Scoped ``ShardedEngine.update`` vs a fresh sharded build on the
    same edits, answers asserted against the MST oracle every step."""
    from repro_torch.api import build_engine
    from repro_torch.core.baselines import MSTOracle
    from repro_torch.core.hypergraph import (apply_edge_edits,
                                             planted_chain_hypergraph)

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    h = planted_chain_hypergraph(n_components, chain_len, overlap=3,
                                 extra_size=2, seed=seed)
    eng = build_engine(h, "sharded", build_labels=labels, device=dev,
                       use_kernels=True)
    eng.block_until_built()
    m0, cur = h.m, h

    def _check(engine, graph):
        us, vs = _sample_queries(graph, rng, n_queries)
        mst = MSTOracle(graph)
        got = np.asarray(engine.mr_batch(us, vs)).astype(np.int64)
        want = np.array([mst.mr(int(u), int(v)) for u, v in zip(us, vs)],
                        np.int64)
        assert np.array_equal(got, want), (n_components, labels)

    # one untimed insert+delete pair first: the first scoped patch's
    # one-off costs must not be billed to the steady state
    warm = [int(cur.edge(0)[0]), int(cur.edge(0)[1]), cur.n]
    eng.update(inserts=[warm])
    eng.update(deletes=[cur.m])

    scoped_s = rebuild_s = 0.0
    for r in range(reps):
        anchor = cur.edge((r * chain_len) % cur.m)
        ins = [int(anchor[0]), int(anchor[1]), cur.n + r]
        h_ins, _, _ = apply_edge_edits(cur, [ins], [])
        h_del, _, _ = apply_edge_edits(h_ins, [], [h_ins.m - 1])
        for inserts, deletes, graph in (([ins], [], h_ins),
                                        ([], [h_ins.m - 1], h_del)):
            t0 = time.perf_counter()
            eng.update(inserts=inserts, deletes=deletes)
            t1 = time.perf_counter()
            fresh = build_engine(graph, "sharded", build_labels=labels,
                                 device=dev, use_kernels=True)
            fresh.block_until_built()
            t2 = time.perf_counter()
            scoped_s += t1 - t0
            rebuild_s += t2 - t1
            _check(eng, graph)
            _check(fresh, graph)
        cur = h_del

    ops = 2 * reps
    return {
        "backend": "sharded[labels]" if labels else "sharded",
        "components": n_components,
        "m": int(m0),
        "n": int(h.n),
        "ops": ops,
        "scoped_ms_per_op": scoped_s / ops * 1e3,
        "rebuild_ms_per_op": rebuild_s / ops * 1e3,
        "speedup": rebuild_s / max(scoped_s, 1e-12),
        "answers_checked": 2 * ops * n_queries,
    }


def sweep(component_counts, chain_len: int, reps: int, n_queries: int,
          out_path: str, sharded_chain_len: int = 24, *,
          device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    results = [bench_components(c, chain_len, reps, n_queries)
               for c in component_counts]
    for row in results:
        print(f"maintenance C={row['components']} m={row['m']}: "
              f"scoped {row['scoped_ms_per_op']:.2f} ms/op vs rebuild "
              f"{row['rebuild_ms_per_op']:.2f} ms/op "
              f"-> {row['speedup']:.1f}x (scope ~{row['mean_scope_edges']:.0f} "
              f"edges, {row['answers_checked']} answers verified)")
    sharded_results = [bench_sharded(c, sharded_chain_len, reps, n_queries,
                                     labels=labels, device=dev)
                       for labels in (False, True)
                       for c in component_counts]
    for row in sharded_results:
        print(f"maintenance {row['backend']} C={row['components']} "
              f"m={row['m']}: scoped {row['scoped_ms_per_op']:.2f} ms/op "
              f"vs rebuild {row['rebuild_ms_per_op']:.2f} ms/op "
              f"-> {row['speedup']:.1f}x "
              f"({row['answers_checked']} answers verified)")
    doc = {
        "chain_len": chain_len,
        "sharded_chain_len": sharded_chain_len,
        "reps": reps,
        "note": ("scoped apply_updates vs build_fast on the full graph, "
                 "identical insert+delete sequences; answers asserted "
                 "equal on every step.  Ideal speedup ~= component count "
                 "(one component is touched per update)."),
        "sharded_note": ("scoped ShardedEngine.update (incremental closure "
                         "block / parallel component splice) vs a fresh "
                         "sharded build of the same regime; every "
                         "post-update answer asserted against the MST "
                         "oracle for both engines."),
        "results": results,
        "sharded_results": sharded_results,
        "env": env_block(dev),
    }
    write_doc(doc, out_path)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="tiny sizes for a smoke run")
    ap.add_argument("--components", type=int, nargs="+", default=None)
    ap.add_argument("--chain-len", type=int, default=None)
    ap.add_argument("--sharded-chain-len", type=int, default=None)
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--n-queries", type=int, default=40)
    add_common_args(ap, "maintenance")
    args = ap.parse_args(argv)
    if args.quick:
        components = args.components or [2, 4]
        chain_len = args.chain_len or 8
        sharded_chain_len = args.sharded_chain_len or 4
        reps = args.reps or 1
    else:
        components = args.components or [2, 4, 8, 16, 32]
        chain_len = args.chain_len or 40
        sharded_chain_len = args.sharded_chain_len or 24
        reps = args.reps or 3
    sweep(components, chain_len, reps, args.n_queries, args.out,
          sharded_chain_len=sharded_chain_len, device=args.device)


if __name__ == "__main__":
    main()
