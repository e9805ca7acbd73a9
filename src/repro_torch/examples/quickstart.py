"""Quickstart: one API surface for every reachability backend, on the
port (the reference's ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart              # card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``main`` returns the answers it printed (the tests hold them to the
reference's).
"""
import argparse
import time

import numpy as np

from repro_torch.api import (available_backends, build_engine, compact,
                             paper_figure1, plan_backend,
                             planted_chain_hypergraph, random_hypergraph)


def main(device: str = "cuda", n: int = 3000, m: int = 4500,
         chains: int = 16, chain_len: int = 40) -> dict:
    out = {}
    # --- the paper's running example (Figure 1) ---------------------------
    h = paper_figure1()
    eng = build_engine(h, backend="hl-index", device=device)
    out["figure1"] = (eng.mr(4, 8), eng.mr(0, 11), eng.s_reach(0, 9, 2))
    print("Figure-1 hypergraph:", h.stats())
    print("MR(v5, v9)  =", out["figure1"][0], " (paper Example 1: 2)")
    print("MR(v1, v12) =", out["figure1"][1], "(paper Example 4: 2)")
    print("v1 ~2~> v10 ?", out["figure1"][2], "(paper Example 3: True)")

    # --- a bigger graph: build once, serve through the same surface -------
    h = random_hypergraph(n, m, min_size=2, max_size=8, seed=0)
    h, _ = compact(h)
    t0 = time.perf_counter()
    eng = build_engine(h, backend="hl-index", device=device,
                       use_kernels=True)
    t_build = time.perf_counter() - t0
    out["planned"] = plan_backend(h, batch_hint=10_000)
    print(f"\nn={h.n} m={h.m}: hl-index build {t_build:.2f}s "
          f"({eng.nbytes()} bytes); planner would pick "
          f"{out['planned']!r} for this shape")

    rng = np.random.default_rng(0)
    us, vs = rng.integers(0, h.n, 10000), rng.integers(0, h.n, 10000)

    # online (index-free) vs hl-index on a few queries — same protocol
    online = build_engine(h, backend="online", device=device)
    t0 = time.perf_counter()
    online_ans = [online.mr(int(u), int(v)) for u, v in zip(us[:20], vs[:20])]
    t_online = (time.perf_counter() - t0) / 20
    t0 = time.perf_counter()
    idx_ans = [eng.mr(int(u), int(v)) for u, v in zip(us[:20], vs[:20])]
    t_idx = (time.perf_counter() - t0) / 20
    assert online_ans == idx_ans
    out["first20"] = idx_ans
    print(f"per-query: online {t_online*1e3:.2f} ms  vs  "
          f"hl-index {t_idx*1e6:.1f} us  ({t_online/t_idx:.0f}x)")

    # the batch: 10k queries in one label_join_gather launch on the card
    # (the reference fuses them into one XLA program)
    ans = eng.mr_batch(us, vs)                      # warm
    t0 = time.perf_counter()
    ans = eng.mr_batch(us, vs)
    t_batch = time.perf_counter() - t0
    out["batch_max"] = int(ans.max())
    out["batch_sum"] = int(ans.astype(np.int64).sum())
    print(f"device snapshot: 10,000 queries in {t_batch*1e3:.1f} ms "
          f"({t_batch/len(us)*1e9:.0f} ns/query); "
          f"max MR in batch = {out['batch_max']}")
    out["backends"] = available_backends()
    print("registered backends:", ", ".join(out["backends"]))

    # --- live updates: scoped maintenance through the same engine ---------
    # construction reruns only on the affected line-graph component, so
    # on a multi-component graph updates cost ~1/C of a rebuild
    # (repro_torch.benchmarks.bench_maintenance tracks this)
    hc = planted_chain_hypergraph(chains, chain_len, overlap=3,
                                  extra_size=2, seed=0)
    t0 = time.perf_counter()
    ec = build_engine(hc, backend="hl-index", device=device)
    t_build_c = time.perf_counter() - t0
    snap_c = ec.snapshot()
    anchor = [int(v) for v in hc.edge(0)[:2]]
    t0 = time.perf_counter()
    ec.update(inserts=[anchor + [hc.n]], deletes=[hc.m - 1])
    t_upd = time.perf_counter() - t0
    out["version"] = (snap_c.version, ec.version)
    print(f"\nupdate on {hc.m}-edge, {chains}-component graph "
          f"(1 insert + 1 delete): {t_upd*1e3:.1f} ms scoped vs "
          f"{t_build_c*1e3:.0f} ms full build "
          f"({t_build_c/t_upd:.0f}x); engine version -> {ec.version} "
          f"(old snapshots are stale: {snap_c.version} != {ec.version})")
    assert ec.snapshot() is not snap_c    # re-derived, serves new answers
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
