"""Distributed reachability on the port (the reference's
``examples/distributed_reachability.py``): 2-D block-partitioned
semiring closures on a logical mesh.

The reference simulates an 8-device slice (``XLA_FLAGS``) and runs its
rounds under ``shard_map`` with collectives.  Here the 2 x 2 and
(2, 2, 2) grids come from ``api.make_mesh``: blocks of one tensor on one
device, each contraction one float32 ``maxmin_matmul`` launch (and each
threshold round one ``threshold_step`` launch per pod slice) on the card.

  PYTHONPATH=src python -m repro_torch.examples.distributed_reachability
  PYTHONPATH=src python -m repro_torch.examples.distributed_reachability \\
      --device cpu

``main`` returns the answers it printed (the tests hold them to the
reference's).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import (build_engine, make_mesh, plan_backend,
                             random_hypergraph)
from repro_torch.core.distributed import (pad_for_mesh,
                                          sharded_maxmin_closure,
                                          sharded_maxmin_round,
                                          sharded_threshold_closure_mr)
from repro_torch.core.semiring import distinct_thresholds
from repro_torch.kernels import maxmin_matmul as mm


def main(device: str = "cuda", n: int = 400, m: int = 600) -> dict:
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), device=device)
    print("blocks:", int(mesh.devices.size), "on", mesh.device,
          "| pod grid:", int(mesh3.devices.size))

    h = random_hypergraph(n, m, min_size=2, max_size=6, seed=1)
    w = h.line_graph(np.int32).astype(np.float32)
    print(f"hypergraph: n={h.n} m={h.m}; line graph {w.shape}")

    # the facade's closure backend is the single-device reference: its W*
    # is exactly what the sharded closures must reproduce
    closure_eng = build_engine(h, backend="closure", device=device)
    dense = closure_eng.w_star.astype(np.float32)

    out["closure_correct"] = {}
    for sched in ("allgather", "ring"):
        t0 = time.perf_counter()
        got = sharded_maxmin_closure(w, mesh, schedule=sched,
                                     use_kernels=True).cpu().numpy()
        dt = time.perf_counter() - t0
        ok = np.array_equal(got, dense)
        out["closure_correct"][sched] = ok
        print(f"maxmin closure [{sched:9s}] on 2x2 mesh: {dt:.2f}s  "
              f"correct={ok}")

    thr = distinct_thresholds(w)
    t0 = time.perf_counter()
    got = sharded_threshold_closure_mr(w, thr, mesh3).cpu().numpy()
    dt = time.perf_counter() - t0
    out["threshold_correct"] = np.array_equal(got, dense)
    print(f"threshold closure (S={thr.size} over pod axis) on 2x2x2: "
          f"{dt:.2f}s  correct={out['threshold_correct']}")

    # the "sharded" backend: the same closures behind the unified engine
    # API — computed once at build, served off a mesh-landed snapshot
    rng = np.random.default_rng(0)
    us, vs = rng.integers(0, h.n, 256), rng.integers(0, h.n, 256)
    hl = build_engine(h, backend="hl-index", device=device)
    want = hl.mr_batch(us, vs).astype(np.int64)
    out["engine_correct"] = {}
    for sched in ("allgather", "ring"):
        eng = build_engine(h, backend="sharded", mesh=mesh, schedule=sched,
                           use_kernels=True)
        ok = np.array_equal(np.asarray(eng.mr_batch(us, vs)).astype(np.int64),
                            want)
        out["engine_correct"][sched] = ok
        print(f"sharded engine [{sched:9s}] == hl-index on 256 vertex "
              f"queries: {ok}")
    # the planner routes to "sharded" when a multi-block mesh is passed
    # and the closure exceeds the per-device budget
    out["planned"] = plan_backend(h, mesh=mesh, device_budget_bytes=0)
    print("auto planner with mesh + tight budget picks:", out["planned"])

    # The reference ends with the bytes each device sends per round,
    # parsed from the collectives of the lowered HLO.  Here a round lowers
    # to no program and moves nothing between devices (the blocks share
    # one), so there is no byte count to read; what a round costs is its
    # block contractions, counted as maxmin_matmul launches (on the card;
    # on the host the wrapper runs its plain version and launches none).
    wp = pad_for_mesh(torch.from_numpy(w).to(mesh.device), mesh)
    out["round_launches"] = {}
    for sched in ("allgather", "ring"):
        round_fn = sharded_maxmin_round(mesh, schedule=sched,
                                        use_kernels=True)
        before = mm.LAUNCHES
        round_fn(wp)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        out["round_launches"][sched] = mm.LAUNCHES - before
    print("per-round block-contraction launches (maxmin_matmul):",
          out["round_launches"])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
