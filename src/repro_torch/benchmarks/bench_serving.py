"""Request-based serving vs per-call queries, plus snapshot-refresh cost
after scoped updates, on the port.

Two claims, tracked as numbers in ``BENCH_serving.json`` (the reference's
``benchmarks/bench_serving.py``, same arguments, assertions and keys,
plus an ``env`` block):

1. **Admission micro-batching** — the same mixed query workload (MR +
   s-reach, mixed s) served request-by-request through ``eng.mr`` /
   ``eng.s_reach`` vs submitted to a ``ReachabilityService`` and
   coalesced into batches of one ``label_join_gather`` launch each on the
   card.  The headline row uses the ``sharded`` backend (every per-call
   query pays a device dispatch; >= 5x asserted in the full run); an
   ``hl-index`` row rides along (its host merge-join answers a single
   query in microseconds).  Every service answer is asserted equal to
   the independent ``mst-oracle``.
2. **Snapshot caching across updates** — after a scoped ``update()`` on
   a multi-component graph the service re-derives only the touched label
   rows (``ServiceStats.rows_rederived`` / ``rows_full``), and answers
   still match the oracle.

Timed passes run against warmed bucket shapes (steady-state serving).
``bench_published`` runs the same comparison on an engine built at a
published size, holding answers to its snapshot's tensor-op join (the
oracle's build is minutes there).

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving          # card
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving --quick
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving --quick \\
      --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

from .common import add_common_args, env_block, to_host, write_doc


def _mixed_workload(h, rng, q):
    from repro_torch.api import MRRequest, SReachRequest

    us = rng.integers(0, h.n, q)
    vs = rng.integers(0, h.n, q)
    is_mr = rng.random(q) < 0.5
    svals = rng.integers(1, 5, q)
    reqs = [MRRequest(int(u), int(v)) if k
            else SReachRequest(int(u), int(v), int(s))
            for u, v, k, s in zip(us, vs, is_mr, svals)]
    return reqs


def _oracle_answers(h, reqs):
    from repro_torch.core.baselines import MSTOracle

    oracle = MSTOracle(h)
    out = []
    for r in reqs:
        mr = oracle.mr(r.u, r.v)
        out.append(mr if r.kind == "mr" else mr >= r.s)
    return out


def _per_call_loop(eng, reqs) -> float:
    t0 = time.perf_counter()
    for r in reqs:
        if r.kind == "mr":
            eng.mr(r.u, r.v)
        else:
            eng.s_reach(r.u, r.v, r.s)
    return time.perf_counter() - t0


def _config():
    """Batches through the ``label_join_gather`` kernel."""
    from repro_torch.api import ServiceConfig

    return ServiceConfig(use_kernels=True)


def bench_backend(backend: str, h, reqs, want, per_call_sample: int, *,
                  device: DeviceLike = None, engine=None) -> dict:
    """Per-call loop vs micro-batched service on one backend (or on a
    built ``engine``); service answers asserted equal to ``want``."""
    from repro_torch.api import serve

    if engine is None:
        svc = serve(h, backend, config=_config(), start=False,
                    device=resolve_device(device))
    else:
        svc = serve(engine, config=_config(), start=False)
    eng = svc.engine
    eng.mr(0, 1)                                     # warm the scalar path

    sample = reqs[:per_call_sample] if per_call_sample else reqs
    per_call_s = _per_call_loop(eng, sample) * (len(reqs) / len(sample))

    futs = svc.submit_many(reqs)                     # warm bucket shapes
    svc.drain()
    [f.result(timeout=0) for f in futs]
    t0 = time.perf_counter()
    futs = svc.submit_many(reqs)
    svc.drain()
    got = [f.result(timeout=0) for f in futs]
    service_s = time.perf_counter() - t0

    for r, g, w in zip(reqs, got, want):
        assert g == w, (backend, r, g, w)

    st = svc.stats()
    q = len(reqs)
    return {
        "backend": backend,
        "queries": q,
        "per_call_s": per_call_s,
        "per_call_sampled": len(sample),
        "service_s": service_s,
        "service_qps": q / service_s,
        "speedup": per_call_s / service_s,
        "batches": st.batches - st.batches // 2,     # timed pass only
        "bucket_histogram": {str(k): v
                             for k, v in sorted(st.bucket_histogram.items())},
        "answers_verified": q,
    }


def bench_scoped_refresh(n_components: int, chain_len: int,
                         n_queries: int, *,
                         device: DeviceLike = None) -> dict:
    """Service snapshot refresh after a scoped update: rows re-derived
    must be a fraction of n, answers still equal to the oracle."""
    from repro_torch.api import planted_chain_hypergraph, serve
    from repro_torch.core.hypergraph import apply_edge_edits

    h = planted_chain_hypergraph(n_components, chain_len, overlap=3,
                                 extra_size=2, seed=0)
    svc = serve(h, "hl-index", config=_config(), start=False,
                device=resolve_device(device))
    rng = np.random.default_rng(0)
    futs = svc.submit_many(_mixed_workload(h, rng, 64))
    svc.drain()                                      # resident snapshot up
    [f.result(timeout=0) for f in futs]

    anchor = h.edge(0)
    ins = [[int(anchor[0]), int(anchor[1]), h.n]]
    t0 = time.perf_counter()
    svc.update(inserts=ins)
    h2, _, _ = apply_edge_edits(h, ins, [])
    reqs = _mixed_workload(h2, rng, n_queries)
    futs = svc.submit_many(reqs)
    svc.drain()
    got = [f.result(timeout=0) for f in futs]
    update_and_refresh_s = time.perf_counter() - t0

    want = _oracle_answers(h2, reqs)
    for r, g, w in zip(reqs, got, want):
        assert g == w, (r, g, w)
    st = svc.stats()
    rows_per_refresh = st.rows_rederived - h.n       # first refresh was full
    assert 0 < rows_per_refresh < h2.n, (rows_per_refresh, h2.n)
    return {
        "components": n_components,
        "n": int(h2.n),
        "m": int(h2.m),
        "rows_rederived_after_scoped_update": int(rows_per_refresh),
        "rows_full": int(h2.n),
        "row_fraction": rows_per_refresh / h2.n,
        "update_and_refresh_s": update_and_refresh_s,
        "answers_verified": len(reqs),
    }


def bench_published(engine, n_queries: int, per_call_sample: int, *,
                    reference=None,
                    reference_name: str = "the snapshot's tensor-op join "
                                          "(batched_mr)") -> dict:
    """The micro-batching comparison on a built ``engine`` (a published
    size, where the oracle's build takes minutes): mixed requests on its
    graph, answers held to ``reference(us, vs)`` — by default its
    snapshot's tensor-op join (``batched_mr``), which shares no code with
    the ``label_join_gather`` kernel the service runs."""
    h = engine.h
    rng = np.random.default_rng(1)
    reqs = _mixed_workload(h, rng, n_queries)
    us = np.array([r.u for r in reqs])
    vs = np.array([r.v for r in reqs])
    if reference is None:
        reference = engine.snapshot().mr
    mr = to_host(reference(us, vs)).astype(np.int64)
    want = [int(a) if r.kind == "mr" else bool(a >= r.s)
            for r, a in zip(reqs, mr)]
    row = bench_backend(engine.name, h, reqs, want, per_call_sample,
                        engine=engine)
    row.update(n=int(h.n), m=int(h.m), reference=reference_name)
    return row


def run(n: int, m: int, n_queries: int, per_call_sample: int,
        components: int, chain_len: int, out_path: str,
        enforce_speedup: bool = True, *, device: DeviceLike = None) -> dict:
    from repro_torch.api import random_hypergraph

    dev = resolve_device(device)
    # low vertex degree keeps the independent MSTOracle check over the
    # full workload tractable (its cost is deg_u * deg_v forest-BFS)
    h = random_hypergraph(n, m, seed=0)
    rng = np.random.default_rng(1)
    reqs = _mixed_workload(h, rng, n_queries)
    want = _oracle_answers(h, reqs)

    rows = [bench_backend("sharded", h, reqs, want, per_call_sample,
                          device=dev),
            bench_backend("hl-index", h, reqs, want, 0, device=dev)]
    for row in rows:
        print(f"serving {row['backend']}: per-call {row['per_call_s']:.2f}s "
              f"vs service {row['service_s']:.2f}s "
              f"({row['service_qps']:.0f} q/s) -> {row['speedup']:.1f}x "
              f"[{row['answers_verified']} answers verified]")
    headline = rows[0]
    if enforce_speedup:
        assert headline["speedup"] >= 5.0, (
            f"micro-batched serving must be >= 5x a per-call loop on the "
            f"device-resident backend; measured {headline['speedup']:.2f}x")
    elif headline["speedup"] < 5.0:
        # --quick: a subsampled per-call loop at tiny sizes; record the
        # miss loudly, don't fail the run
        print(f"WARNING: quick-mode speedup {headline['speedup']:.2f}x "
              f"< 5x (timing noise at tiny sizes; the full run enforces)")

    refresh = bench_scoped_refresh(components, chain_len,
                                   min(n_queries, 512), device=dev)
    print(f"scoped refresh: {refresh['rows_rederived_after_scoped_update']}"
          f"/{refresh['rows_full']} rows re-derived "
          f"({refresh['row_fraction']:.1%}) after update on "
          f"{refresh['components']} components")

    doc = {
        "workload": {"n": n, "m": m, "queries": n_queries,
                     "mix": "50% MRRequest / 50% SReachRequest, s in 1..4"},
        "headline_speedup": headline["speedup"],
        "note": ("Steady-state (bucket shapes warmed) service vs a "
                 "per-call eng.mr/eng.s_reach loop on the same engine; "
                 "every service answer asserted equal to the mst-oracle "
                 "reference.  The sharded row is the headline: per-call "
                 "queries on a device-resident snapshot pay one dispatch "
                 "each, micro-batching fuses them.  The hl-index row "
                 "documents the host merge-join floor a Python admission "
                 "queue cannot beat."),
        "backends": rows,
        "scoped_refresh": refresh,
        "env": env_block(dev),
    }
    write_doc(doc, out_path)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="tiny sizes for a smoke run")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--m", type=int, default=None)
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--per-call-sample", type=int, default=None,
                    help="subsample for the (slow) sharded per-call loop; "
                         "0 = run every query")
    add_common_args(ap, "serving")
    args = ap.parse_args(argv)
    if args.quick:
        n = args.n or 500
        m = args.m or 160
        queries = args.queries or 2000
        sample = 200 if args.per_call_sample is None else args.per_call_sample
        components, chain_len = 4, 8
    else:
        n = args.n or 2000
        m = args.m or 512
        queries = args.queries or 10_000
        sample = 500 if args.per_call_sample is None else args.per_call_sample
        components, chain_len = 16, 20
    run(n, m, queries, sample, components, chain_len, args.out,
        enforce_speedup=not args.quick, device=args.device)


if __name__ == "__main__":
    main()
