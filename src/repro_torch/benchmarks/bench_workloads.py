"""Workload ops vs their brute-force references across graph sizes, on
the port (the reference's ``benchmarks/bench_workloads.py``: same
arguments, assertions and keys, plus an ``env`` block).

Every family in the workload subsystem (repro_torch.workloads) is timed
against the independent brute-force reference that defines it — and
every answer is asserted on the spot, so the numbers can't drift from
correctness: witness walks verify and realize exactly the brute-force
MR, hop-bounded and set answers are byte-identical, and the landmark
oracle's bounds respect the certified contract (zero iff zero,
bound >= exact).  The engines join through the ``label_join_gather``
kernel on the card; the set-to-set family is additionally timed on that
kernel path vs the snapshot's tensor-op join (same answers asserted).
Writes ``build/bench_torch/BENCH_workloads.json``.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_workloads
  PYTHONPATH=src python -m repro_torch.benchmarks.bench_workloads --quick \\
      --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

from .common import add_common_args, env_block, write_doc


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def bench_size(n: int, m: int, n_queries: int, seed: int = 0, *,
               device: DeviceLike = None) -> dict:
    from repro_torch.api import build_engine, random_hypergraph, verify_witness
    from repro_torch.core import (brute_force_mr_set, brute_force_s_distance,
                                  brute_force_s_reach_k, brute_force_top_s,
                                  brute_force_witness)

    h = random_hypergraph(n, m, seed=seed)
    eng = build_engine(h, "hl-index", device=resolve_device(device),
                       use_kernels=True)
    rng = np.random.default_rng(seed + 1)
    pairs = [(int(u), int(v)) for u, v in rng.integers(0, h.n,
                                                       (n_queries, 2))]
    checked = 0
    row = {"n": int(h.n), "m": int(h.m), "queries": n_queries}

    # witness: engine walk == brute-force strength, both walks verify
    eng_s = brute_s = 0.0
    for u, v in pairs:
        w, dt = _timed(eng.mr_witness, u, v)
        eng_s += dt
        (bk, bwalk), dt = _timed(brute_force_witness, h, u, v)
        brute_s += dt
        assert w.s == bk and verify_witness(h, w), (u, v, w, bk)
        checked += 1
    row["witness"] = {"engine_ms": eng_s / n_queries * 1e3,
                      "brute_ms": brute_s / n_queries * 1e3}

    # hop-bounded s-reach: byte-identical booleans
    eng_s = brute_s = 0.0
    for u, v in pairs:
        for s, k in ((1, 2), (2, 3)):
            a, dt = _timed(eng.s_reach_k, u, v, s, k)
            eng_s += dt
            b, dt = _timed(brute_force_s_reach_k, h, u, v, s, k)
            brute_s += dt
            assert a == b, (u, v, s, k, a, b)
            checked += 1
    q2 = n_queries * 2
    row["s_reach_k"] = {"engine_ms": eng_s / q2 * 1e3,
                        "brute_ms": brute_s / q2 * 1e3}

    # set-to-set MR: identical ints (one batched join vs the pair loop)
    eng_s = brute_s = 0.0
    set_reps = max(n_queries // 4, 1)
    for r in range(set_reps):
        us = rng.integers(0, h.n, 8)
        vs = rng.integers(0, h.n, 8)
        a, dt = _timed(eng.mr_set, us, vs)
        eng_s += dt
        b, dt = _timed(brute_force_mr_set, h, us, vs)
        brute_s += dt
        assert int(a) == int(b), (r, a, b)
        checked += 1
    row["mr_set"] = {"engine_ms": eng_s / set_reps * 1e3,
                     "brute_ms": brute_s / set_reps * 1e3}

    # top-k ranking: identical (vertex, mr) arrays
    eng_s = brute_s = 0.0
    for u, _ in pairs:
        (verts, vals), dt = _timed(eng.top_s, u, 10)
        eng_s += dt
        (bv, bs), dt = _timed(brute_force_top_s, h, u, 10)
        brute_s += dt
        assert (np.array_equal(np.asarray(verts), bv)
                and np.array_equal(np.asarray(vals), bs)), u
        checked += 1
    row["top_s"] = {"engine_ms": eng_s / n_queries * 1e3,
                    "brute_ms": brute_s / n_queries * 1e3}

    # landmark s-distance: certified contract (zero iff zero, bound >=
    # exact); oracle build cost reported separately from query cost
    _, build_s = _timed(eng.distance_oracle, 2)
    eng_s = brute_s = 0.0
    for u, v in pairs:
        bound, dt = _timed(eng.s_distance, u, v, 2)
        eng_s += dt
        exact, dt = _timed(brute_force_s_distance, h, u, v, 2)
        brute_s += dt
        assert (bound == 0) == (exact == 0) and bound >= exact, \
            (u, v, bound, exact)
        checked += 1
    row["s_distance"] = {"engine_ms": eng_s / n_queries * 1e3,
                         "brute_ms": brute_s / n_queries * 1e3,
                         "oracle_build_ms": build_s * 1e3}
    row["answers_checked"] = checked
    return row


def bench_mr_set_kernel(n: int, m: int, reps: int, seed: int = 0, *,
                        device: DeviceLike = None) -> dict:
    """Set-to-set MR through the ``label_join_gather`` kernel path vs the
    snapshot's tensor-op join — identical answers asserted on every
    rep."""
    from repro_torch.api import build_engine, random_hypergraph

    dev = resolve_device(device)
    h = random_hypergraph(n, m, seed=seed)
    host = build_engine(h, "hl-index", device=dev)
    kern = build_engine(h, "hl-index", use_kernels=True, device=dev)
    rng = np.random.default_rng(seed)
    sets = [(rng.integers(0, h.n, 16), rng.integers(0, h.n, 16))
            for _ in range(reps)]
    kern.mr_set(*sets[0])                    # compile outside the clock
    host_s = kern_s = 0.0
    for us, vs in sets:
        a, dt = _timed(host.mr_set, us, vs)
        host_s += dt
        b, dt = _timed(kern.mr_set, us, vs)
        kern_s += dt
        assert int(a) == int(b), (a, b)
    return {"n": int(h.n), "m": int(h.m), "reps": reps,
            "host_ms": host_s / reps * 1e3,
            "kernel_ms": kern_s / reps * 1e3,
            "answers_checked": reps}


def sweep(sizes, n_queries: int, kernel_reps: int, out_path: str, *,
          device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    results = [bench_size(n, m, n_queries, device=dev) for n, m in sizes]
    for row in results:
        ops = {op: row[op] for op in ("witness", "s_reach_k", "mr_set",
                                      "top_s", "s_distance")}
        summary = ", ".join(
            f"{op} {v['engine_ms']:.2f}/{v['brute_ms']:.2f}"
            for op, v in ops.items())
        print(f"workloads n={row['n']} m={row['m']}: engine/brute ms — "
              f"{summary} ({row['answers_checked']} answers verified)")
    kn, km = sizes[-1]
    kernel = bench_mr_set_kernel(kn, km, kernel_reps, device=dev)
    print(f"mr_set kernel vs host at n={kernel['n']} m={kernel['m']}: "
          f"{kernel['kernel_ms']:.2f} ms vs {kernel['host_ms']:.2f} ms "
          f"({kernel['answers_checked']} answers verified)")
    doc = {
        "note": ("each workload op vs its brute-force reference; every "
                 "answer asserted (byte-identical where exact, certified "
                 "bound contract for s_distance).  mr_set additionally "
                 "timed on the label_join_gather kernel path "
                 "(kernel_ms) vs the snapshot's tensor-op join "
                 "(host_ms)."),
        "results": results,
        "mr_set_kernel_vs_host": kernel,
        "env": env_block(dev),
    }
    write_doc(doc, out_path)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="tiny sizes for a smoke run")
    ap.add_argument("--n-queries", type=int, default=None)
    ap.add_argument("--kernel-reps", type=int, default=None)
    add_common_args(ap, "workloads")
    args = ap.parse_args(argv)
    if args.quick:
        sizes = [(20, 30), (30, 45), (40, 60)]
        n_queries = args.n_queries or 6
        kernel_reps = args.kernel_reps or 2
    else:
        sizes = [(60, 90), (120, 180), (240, 360)]
        n_queries = args.n_queries or 20
        kernel_reps = args.kernel_reps or 5
    sweep(sizes, n_queries, kernel_reps, args.out, device=args.device)


if __name__ == "__main__":
    main()
