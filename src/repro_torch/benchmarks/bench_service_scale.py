"""Multi-tenant service at scale on the port: fairness, priorities,
replicas.

The saturation benchmark behind ``BENCH_service_scale.json`` (the
reference's ``benchmarks/bench_service_scale.py``: same arguments,
assertions and keys, plus an ``env`` block; the engine answers through
the ``label_join_gather`` kernel on the card): sweeps
tenants x replicas x priority mixes through the weighted-fair admission
queue and the replica fan-out path, reporting p99 tail latency and a
fairness metric, with **every answer asserted equal to the mst-oracle**.

Three claims, tracked as numbers:

1. **Adversarial fairness** — one greedy tenant floods the queue, a
   light tenant arrives behind the flood.  Under FIFO admission (the
   pre-multi-tenant behavior, emulated by tagging everything as one
   tenant) the light tenant's first answer waits behind the whole
   flood; under weighted-fair scheduling it rides the very next
   micro-batch.  Reported: per-tenant p99 latency both ways, the
   starvation factor (FIFO wait / WFQ wait in batches), and the
   fairness metric — max/min per-tenant weight-normalized throughput
   over the contended window (1.0 = perfectly proportional).
2. **Tenants x replicas x priority mixes** — the saturation grid.  Each
   cell submits one mixed MR/s-reach workload split across N weighted
   tenants and three priority classes, serves it through 1 or R
   mesh-resident snapshot replicas, and reports per-priority p99
   (strict bands: interactive p99 <= batch p99 under backlog),
   per-tenant fairness ratio, and throughput.
3. **Replica churn** — updates interleave with serving at each replica
   count; only dirty rows fan out (``rows_patched`` counted) and
   answers stay oracle-correct across versions.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_service_scale
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_service_scale \\
      --quick --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

from .common import add_common_args, env_block, write_doc

PRIORITY_MIXES = {
    "uniform": (("standard", 1.0),),
    "mixed": (("interactive", 0.1), ("standard", 0.6), ("batch", 0.3)),
    "bimodal": (("interactive", 0.5), ("batch", 0.5)),
}


def _query_pool(h, rng, q):
    """One reusable pool of (kind, u, v, s) tuples; metadata is layered
    on per scenario so the oracle pass is paid once."""
    us = rng.integers(0, h.n, q)
    vs = rng.integers(0, h.n, q)
    is_mr = rng.random(q) < 0.5
    svals = rng.integers(1, 5, q)
    return [("mr", int(u), int(v), 0) if k else
            ("s_reach", int(u), int(v), int(s))
            for u, v, k, s in zip(us, vs, is_mr, svals)]


def _oracle_table(h, pool):
    from repro_torch.core.baselines import MSTOracle

    oracle = MSTOracle(h)
    table = {}
    for kind, u, v, s in set(pool):
        mr = oracle.mr(u, v)
        table[(kind, u, v, s)] = mr if kind == "mr" else mr >= s
    return table


def _requests(pool, *, tenant="default", priority="standard", rng=None,
              tenants=None, mix=None):
    """Materialize the pool as typed requests; ``tenants`` round-robins
    the tenant field, ``mix`` draws priorities by the named weights."""
    from repro_torch.api import MRRequest, SReachRequest

    reqs = []
    if mix is not None:
        names = [name for name, _ in mix]
        probs = np.array([p for _, p in mix], float)
        draws = rng.choice(len(names), size=len(pool), p=probs / probs.sum())
    for i, (kind, u, v, s) in enumerate(pool):
        t = tenants[i % len(tenants)] if tenants else tenant
        p = names[draws[i]] if mix is not None else priority
        if kind == "mr":
            reqs.append(MRRequest(u, v, tenant=t, priority=p))
        else:
            reqs.append(SReachRequest(u, v, s, tenant=t, priority=p))
    return reqs


def _assert_oracle(pool, futs, table, where):
    for (kind, u, v, s), fut in zip(pool, futs):
        got = fut.result(timeout=0)
        want = table[(kind, u, v, s)]
        assert got == want, (where, kind, u, v, s, got, want)


def _serve_stepped(svc, reqs):
    """Submit everything, then step the service one micro-batch at a
    time, recording per-batch per-tenant completions and per-request
    resolution timestamps (queueing delay under saturation)."""
    done_at = {}
    futs = [svc.submit(r, on_result=lambda rq, f:
                       done_at.__setitem__(id(rq), time.perf_counter()))
            for r in reqs]
    steps = []
    prev = {}
    t0 = time.perf_counter()
    while True:
        pending_before = svc.backlog()
        if not pending_before:
            break
        svc.drain(max_batches=1)
        st = svc.stats()
        delta = {t: c - prev.get(t, 0)
                 for t, c in st.tenant_answered.items() if c - prev.get(t, 0)}
        prev = dict(st.tenant_answered)
        steps.append({"pending_before": pending_before,
                      "pending_after": svc.backlog(), "delta": delta})
    wall_s = time.perf_counter() - t0
    lat = {id(r): done_at[id(r)] - t0 for r in reqs}
    return futs, steps, lat, wall_s


def _fairness_ratio(steps, weights):
    """max/min weight-normalized per-tenant throughput over the batches
    where every tenant stayed backlogged for the whole batch (1.0 =
    proportional).  Batches where a queue drains mid-batch are excluded:
    the emptied tenant's surplus slots legitimately go to the others."""
    totals = {t: 0 for t in weights}
    contended = 0
    for step in steps:
        if any(step["pending_before"].get(t, 0) == 0
               or step["pending_after"].get(t, 0) == 0 for t in weights):
            continue
        contended += 1
        for t in weights:
            totals[t] += step["delta"].get(t, 0)
    if not contended or any(v == 0 for v in totals.values()):
        return None, contended
    normed = [totals[t] / weights[t] for t in weights]
    return max(normed) / min(normed), contended


def _p99(values):
    return float(np.percentile(np.asarray(values, float), 99)) \
        if values else None


def bench_adversarial(eng, pool, table, *, greedy_q, light_q,
                      max_batch) -> dict:
    """Greedy flood vs light tenant: weighted-fair vs FIFO emulation."""
    from repro_torch.api import ReachabilityService, ServiceConfig, TenantSpec

    greedy_pool, light_pool = pool[:greedy_q], pool[greedy_q:greedy_q + light_q]
    out = {}
    for policy in ("wfq", "fifo"):
        if policy == "wfq":
            cfg = ServiceConfig(max_batch=max_batch,
                                tenants=(TenantSpec("greedy", 1.0),
                                         TenantSpec("light", 1.0)))
            g_t, l_t = "greedy", "light"
        else:
            # FIFO emulation: one tenant queue preserves submission
            # order exactly — the pre-multi-tenant admission behavior
            cfg = ServiceConfig(max_batch=max_batch)
            g_t = l_t = "all"
        svc = ReachabilityService(eng, config=cfg, start=False)
        greedy_reqs = _requests(greedy_pool, tenant=g_t)
        light_reqs = _requests(light_pool, tenant=l_t)
        g_futs = svc.submit_many(greedy_reqs)     # flood lands first
        l_futs = svc.submit_many(light_reqs)
        light_ids = {id(r) for r in light_reqs}

        # step batches; note the first batch after which the light
        # tenant is fully answered
        light_done_batch = None
        steps = []
        prev = {}
        done_at = {}
        t0 = time.perf_counter()
        batch_no = 0
        while svc.pending():
            svc.drain(max_batches=1)
            batch_no += 1
            st = svc.stats()
            delta = {t: c - prev.get(t, 0)
                     for t, c in st.tenant_answered.items()}
            prev = dict(st.tenant_answered)
            steps.append({"pending_before": {}, "delta": delta})
            now = time.perf_counter()
            for r, f in zip(light_reqs + greedy_reqs, l_futs + g_futs):
                if f.done() and id(r) not in done_at:
                    done_at[id(r)] = now - t0
            if light_done_batch is None and all(f.done() for f in l_futs):
                light_done_batch = batch_no
        _assert_oracle(greedy_pool, g_futs, table, f"adversarial/{policy}")
        _assert_oracle(light_pool, l_futs, table, f"adversarial/{policy}")
        light_lat = [done_at[i] for i in light_ids]
        greedy_lat = [v for i, v in done_at.items() if i not in light_ids]
        out[policy] = {
            "greedy_queries": greedy_q,
            "light_queries": light_q,
            "batches": batch_no,
            "light_done_after_batches": light_done_batch,
            "light_p99_s": _p99(light_lat),
            "greedy_p99_s": _p99(greedy_lat),
            "answers_verified": greedy_q + light_q,
        }
    wfq, fifo = out["wfq"], out["fifo"]
    # the starvation bound: under WFQ the light tenant rides batch 1
    assert wfq["light_done_after_batches"] == 1, wfq
    assert fifo["light_done_after_batches"] > wfq["light_done_after_batches"]
    out["starvation_factor_batches"] = (fifo["light_done_after_batches"]
                                        / wfq["light_done_after_batches"])
    return out


def bench_grid_cell(eng, pool, table, *, n_tenants, replicas, mix_name,
                    max_batch) -> dict:
    """One saturation-grid cell: N weighted tenants x R replicas x one
    priority mix, everything submitted up front (saturated queue)."""
    from repro_torch.api import (ReachabilityService, ReplicaGroup,
                                 ServiceConfig, TenantSpec)

    rng = np.random.default_rng(hash((n_tenants, replicas, mix_name)) % 2**32)
    names = [f"t{i}" for i in range(n_tenants)]
    weights = {name: float(i + 1) for i, name in enumerate(names)}
    cfg = ServiceConfig(
        max_batch=max_batch, replicas=replicas,
        tenants=tuple(TenantSpec(n, w) for n, w in weights.items()))
    svc = (ReplicaGroup(eng, config=cfg, start=False) if replicas > 1
           else ReachabilityService(eng, config=cfg, start=False))
    reqs = _requests(pool, tenants=names, rng=rng,
                     mix=PRIORITY_MIXES[mix_name])
    futs, steps, lat, wall_s = _serve_stepped(svc, reqs)
    _assert_oracle(pool, futs, table,
                   f"grid/{n_tenants}x{replicas}x{mix_name}")
    fairness, contended = _fairness_ratio(steps, weights)
    by_prio = {}
    for r in reqs:
        by_prio.setdefault(r.priority, []).append(lat[id(r)])
    st = svc.stats()
    cell = {
        "tenants": n_tenants,
        "replicas": replicas,
        "priority_mix": mix_name,
        "queries": len(reqs),
        "wall_s": wall_s,
        "qps": len(reqs) / wall_s,
        "batches": st.batches,
        "fairness_ratio": fairness,
        "contended_batches": contended,
        "p99_s_by_priority": {p: _p99(v) for p, v in sorted(by_prio.items())},
        "tenant_weights": weights,
        "answers_verified": len(reqs),
    }
    if replicas > 1:
        rstats = svc.replica_stats()
        cell["replica_batches"] = [r["batches"] for r in rstats]
    # strict bands under a saturated queue: interactive tail never worse
    # than batch tail (equal only when everything fits in one batch)
    p99 = cell["p99_s_by_priority"]
    if "interactive" in p99 and "batch" in p99 and st.batches > 2:
        assert p99["interactive"] <= p99["batch"] * 1.05, p99
    # the DRR proportionality guarantee is per priority band, so the
    # aggregate ratio is only a tight bound on single-class mixes (on
    # multi-class cells the small interactive band is served equally
    # before weights matter, diluting the aggregate toward 1/weight)
    if fairness is not None and len(PRIORITY_MIXES[mix_name]) == 1:
        assert fairness <= 1.5, (fairness, "weighted shares off")
    return cell


def bench_replica_churn(replicas: int, n_chains: int, queries: int, *,
                        device: DeviceLike = None) -> dict:
    """Interleaved update/serve stream at one replica count: dirty-row
    fan-out counted, every answer oracle-checked at every version."""
    from repro_torch.api import (MRRequest, ReplicaGroup, ServiceConfig,
                                 build_engine, from_edge_lists)
    from repro_torch.core.baselines import MSTOracle

    edges = [[0, 1, 2], [1, 2, 3], [10, 11, 12], [11, 12, 13]]
    for i in range(n_chains):
        edges.append([20 + 2 * i, 21 + 2 * i, 22 + 2 * i, 23 + 2 * i])
    h = from_edge_lists(edges)
    eng = build_engine(h, "hl-index", device=resolve_device(device),
                       use_kernels=True)
    grp = ReplicaGroup(eng, replicas,
                       config=ServiceConfig(max_batch=128), start=False)
    rng = np.random.default_rng(0)
    edits = [[[0, 1, 2, 3]], [[10, 11, 12, 13]], [[0, 2, 3]]]
    verified = 0
    t0 = time.perf_counter()
    for ins in edits:
        cur = grp.engine.h
        oracle = MSTOracle(cur)
        us = rng.integers(0, cur.n, queries)
        vs = rng.integers(0, cur.n, queries)
        futs = grp.submit_many([MRRequest(int(u), int(v))
                                for u, v in zip(us, vs)])
        grp.drain()
        for u, v, f in zip(us, vs, futs):
            assert f.result(timeout=0) == oracle.mr(int(u), int(v))
        verified += queries
        grp.update(inserts=ins)
    wall_s = time.perf_counter() - t0
    st = grp.stats()
    rstats = grp.replica_stats()
    assert all(r["full_relands"] == 1 for r in rstats), rstats
    return {
        "replicas": replicas,
        "versions_served": len(edits),
        "queries_per_version": queries,
        "wall_s": wall_s,
        "rows_patched_total": st.mesh_rows_patched,
        "full_relands_per_replica": [r["full_relands"] for r in rstats],
        "answers_verified": verified,
    }


def run(n, m, queries, greedy_q, light_q, max_batch, tenant_counts,
        replica_counts, mixes, out_path, *,
        device: DeviceLike = None) -> dict:
    from repro_torch.api import build_engine, random_hypergraph

    dev = resolve_device(device)
    h = random_hypergraph(n, m, seed=0)
    rng = np.random.default_rng(1)
    pool = _query_pool(h, rng, queries)
    table = _oracle_table(h, pool)
    eng = build_engine(h, "hl-index", device=dev, use_kernels=True)
    eng.snapshot()                                   # warm the shared engine

    adversarial = bench_adversarial(
        eng, pool[:greedy_q + light_q], table,
        greedy_q=greedy_q, light_q=light_q, max_batch=max_batch)
    print(f"adversarial: light tenant done after "
          f"{adversarial['wfq']['light_done_after_batches']} batch(es) "
          f"under WFQ vs {adversarial['fifo']['light_done_after_batches']} "
          f"under FIFO ({adversarial['starvation_factor_batches']:.0f}x "
          f"starvation factor)")

    grid = []
    for n_tenants in tenant_counts:
        for replicas in replica_counts:
            for mix_name in mixes:
                cell = bench_grid_cell(eng, pool, table,
                                       n_tenants=n_tenants,
                                       replicas=replicas, mix_name=mix_name,
                                       max_batch=max_batch)
                grid.append(cell)
                fr = cell["fairness_ratio"]
                print(f"grid {n_tenants}t x {replicas}r x {mix_name}: "
                      f"{cell['qps']:.0f} q/s, fairness "
                      f"{fr if fr is None else round(fr, 3)}, p99 "
                      f"{ {p: None if v is None else round(v * 1e3, 2) for p, v in cell['p99_s_by_priority'].items()} } ms")

    churn = [bench_replica_churn(r, n_chains=10, queries=min(queries, 256),
                                 device=dev)
             for r in replica_counts]
    for row in churn:
        print(f"churn {row['replicas']}r: {row['versions_served']} versions, "
              f"{row['rows_patched_total']} rows patched, "
              f"{row['answers_verified']} answers verified")

    doc = {
        "workload": {"n": n, "m": m, "queries": queries,
                     "mix": "50% MRRequest / 50% SReachRequest, s in 1..4",
                     "max_batch": max_batch},
        "note": ("Saturated-queue serving (everything submitted before "
                 "draining, stepped one micro-batch at a time); latency = "
                 "queueing delay to each request's resolution; fairness "
                 "ratio = max/min weight-normalized per-tenant throughput "
                 "over contended batches (1.0 = proportional); every "
                 "answer asserted equal to the mst-oracle reference."),
        "adversarial": adversarial,
        "grid": grid,
        "replica_churn": churn,
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
    add_common_args(ap, "service_scale")
    args = ap.parse_args(argv)
    if args.quick:
        run(n=args.n or 300, m=args.m or 100,
            queries=args.queries or 768, greedy_q=512, light_q=16,
            max_batch=128, tenant_counts=(2,), replica_counts=(1, 2),
            mixes=("uniform", "mixed"), out_path=args.out,
            device=args.device)
    else:
        run(n=args.n or 1500, m=args.m or 420,
            queries=args.queries or 6144, greedy_q=4096, light_q=32,
            max_batch=256, tenant_counts=(2, 4), replica_counts=(1, 2),
            mixes=("uniform", "mixed", "bimodal"), out_path=args.out,
            device=args.device)


if __name__ == "__main__":
    main()
