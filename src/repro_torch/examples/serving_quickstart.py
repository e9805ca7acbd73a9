"""Serving quickstart on the port (the reference's
``examples/serving_quickstart.py``): requests in, futures out — the
admission loop coalesces whatever is pending into batches of one
``label_join_gather`` launch each on the card, and a scoped update swaps
the resident snapshot between micro-batches, re-deriving only the
touched label rows.

Also demonstrates the multi-tenant surface: weighted-fair scheduling
across tenants, strict priority bands, deadlines, streaming delivery,
and replicated serving (`ServiceConfig(replicas=N)`).

  PYTHONPATH=src python -m repro_torch.examples.serving_quickstart
  PYTHONPATH=src python -m repro_torch.examples.serving_quickstart \\
      --device cpu

``main`` returns the answers it printed (the tests hold them to the
reference's).
"""
import argparse
import time

import numpy as np

from repro_torch.api import (DeadlineExceeded, MRRequest, ServiceConfig,
                             SReachRequest, TenantSpec,
                             planted_chain_hypergraph, random_hypergraph,
                             serve)


def main(device: str = "cuda", requests: int = 10_000) -> dict:
    out = {}
    kernels = ServiceConfig(use_kernels=True)
    # --- submit typed requests, read futures ------------------------------
    h = random_hypergraph(2000, 512, seed=0)
    with serve(h, backend="sharded", config=kernels,
               device=device) as svc:               # background admission
        f_mr = svc.mr(4, 8)                         # Future[int]
        f_sr = svc.submit(SReachRequest(4, 8, s=2))  # Future[bool]
        out["mr_4_8"] = f_mr.result(timeout=60)
        out["sreach_4_8_2"] = f_sr.result(timeout=60)
        print(f"MR(4, 8) = {out['mr_4_8']}   4 ~2~> 8 ? "
              f"{out['sreach_4_8_2']}")

        # a burst of mixed requests (MR + s-reach, mixed s values)
        # coalesces into a handful of power-of-two batches
        rng = np.random.default_rng(0)
        reqs = [MRRequest(int(u), int(v)) if rng.random() < 0.5
                else SReachRequest(int(u), int(v), int(rng.integers(1, 5)))
                for u, v in zip(rng.integers(0, h.n, requests),
                                rng.integers(0, h.n, requests))]
        futs = svc.submit_many(reqs)
        _ = [f.result(timeout=60) for f in futs]    # warm the bucket shapes
        t0 = time.perf_counter()
        futs = svc.submit_many(reqs)
        answers = [f.result(timeout=60) for f in futs]
        dt = time.perf_counter() - t0
        st = svc.stats()
        out["burst_max"] = max(answers)
        out["burst_sum"] = int(sum(int(a) for a in answers))
        print(f"{len(answers):,} mixed requests in {dt*1e3:.0f} ms "
              f"({len(answers)/dt:.0f} q/s) across "
              f"{len(st.bucket_histogram)} bucket shapes "
              f"{sorted(st.bucket_histogram)}; max MR = {out['burst_max']}")

    # --- live updates: snapshot swapped between micro-batches -------------
    hc = planted_chain_hypergraph(16, 20, overlap=3, extra_size=2, seed=0)
    svc = serve(hc, backend="hl-index", config=kernels, start=False,
                device=device)                      # synchronous mode
    svc.mr(0, 1)
    svc.drain()                                     # resident snapshot up
    anchor = [int(v) for v in hc.edge(0)[:2]]
    svc.update(inserts=[anchor + [hc.n]])           # scoped maintenance
    f = svc.mr(anchor[0], hc.n)
    svc.drain()                                     # swap + refresh here
    st = svc.stats()
    out["after_update"] = f.result(timeout=0)
    out["refresh_rows"] = (svc.engine.last_snapshot_refresh_rows,
                           svc.engine.h.n)
    print(f"after a scoped update on a 16-component graph: "
          f"MR(anchor, new vertex) = {out['after_update']}; snapshot "
          f"refresh re-derived {out['refresh_rows'][0]}/"
          f"{out['refresh_rows'][1]} label rows ({st.snapshot_refreshes} "
          f"refreshes total)")

    # --- multi-tenant: weighted-fair shares, priorities, deadlines --------
    h2 = random_hypergraph(500, 160, seed=1)
    cfg = ServiceConfig(max_batch=64, use_kernels=True,
                        tenants=(TenantSpec("analytics", weight=1.0),
                                 TenantSpec("dashboard", weight=3.0)))
    svc = serve(h2, "hl-index", config=cfg, start=False, device=device)
    rng = np.random.default_rng(1)
    for tenant in ("analytics", "dashboard"):
        svc.submit_many([
            MRRequest(int(u), int(v), tenant=tenant)
            for u, v in zip(rng.integers(0, h2.n, 200),
                            rng.integers(0, h2.n, 200))])
    svc.drain(max_batches=1)                    # one 64-slot micro-batch
    st = svc.stats()
    out["shares"] = dict(sorted(st.tenant_answered.items()))
    print(f"one contended batch, weights 1:3 -> shares {out['shares']}")

    # an expired deadline fails fast with a typed error, never batched
    doomed = svc.submit(MRRequest(0, 1, priority="interactive",
                                  deadline_ms=0.5))
    time.sleep(0.002)
    svc.drain()
    try:
        doomed.result(timeout=0)
    except DeadlineExceeded as err:
        out["deadline"] = True
        print(f"deadline path: {err}")
    svc.close()

    # --- replicated serving: N device-resident copies, one writer ---------
    grp = serve(h2, "hl-index",
                config=ServiceConfig(replicas=2, use_kernels=True),
                start=False, device=device)
    for req, fut in grp.submit_stream(
            [MRRequest(int(u), int(v))
             for u, v in zip(rng.integers(0, h2.n, 32),
                             rng.integers(0, h2.n, 32))]):
        pass                                    # answers in completion order
    out["replica_batches"] = [r["batches"] for r in grp.replica_stats()]
    print(f"replica group: {out['replica_batches']} "
          f"batches served round-robin across 2 replicas")
    grp.close()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
