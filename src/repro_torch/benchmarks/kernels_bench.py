"""Kernel-layer benchmarks of the port.

Two jobs:

1. ``closure_bench`` — the closure-layer rows for ``benchmarks.run``
   (name,value,unit CSV; the reference's row names).
2. ``main`` / ``BENCH_kernels.json`` — each hand-written kernel beside its
   plain PyTorch version and, where one computes the same function, the
   library call: ``label_join_gather`` (the batched merge-join by vertex
   id) against the per-call host merge-join loop and the snapshot's
   tensor-op join, ``maxmin_matmul``, ``overlap`` (``torch.matmul``) and
   ``threshold_step`` (``torch.bmm``), each with the least time the card
   could take for it (``benchmarks.roofline``).

On the card every time is CUDA events around calls back to back after a
warm-up; on the host (``--device cpu``) it is the host clock around the
plain versions the wrappers run there, the JSON says ``"device": "cpu"``
and gives no bound and no roofline fraction (the rates are the card's).
Every label-join answer is held equal to the tensor-op join and to the
host merge-join, and spot-checked against the independent mst-oracle;
every dense kernel answer is held equal to its plain version.

  PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench          # card
  PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench --quick
  PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench --quick \\
      --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hypergraph import Hypergraph, random_hypergraph
from repro_torch.core.semiring import (device_line_graph, distinct_thresholds,
                                       maxmin_closure, maxmin_matmul,
                                       threshold_closure_mr)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import label_join as lj
from repro_torch.kernels import overlap as ov
from repro_torch.kernels import threshold_closure as tc
from repro_torch.kernels.maxmin_matmul import maxmin_matmul_ref

from . import roofline
from .common import add_common_args, env_block, to_host, write_doc

__all__ = ["closure_bench", "label_join_bench", "maxmin_bench",
           "overlap_bench", "threshold_bench", "run", "main"]


def _ms(fn: Callable, device: torch.device, reps: int = 3,
        warmup: int = 1) -> float:
    """Milliseconds of one call of ``fn``: on the card CUDA events around
    ``reps`` calls back to back after ``warmup`` calls; on the host the
    host clock."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _bound(device: torch.device, bound_fn: Callable) -> dict:
    """The bound of a kernel row on the card (the int32 min/max rate read
    from it first); nothing on the host."""
    if device.type != "cuda":
        return {"bound_ms": None, "bound_by": None}
    if "int32_minmax" not in roofline.RATES:
        roofline.fill_rates()
    out = bound_fn()
    return {"bound_ms": out[0], "bound_by": out[1]}


def _with_fraction(row: dict) -> dict:
    if row["bound_ms"] is not None:
        row["roofline"] = {"fraction_of_bound":
                           row["bound_ms"] / row["kernel_ms"]}
    return row


def closure_bench(m: int = 512, *, device: DeviceLike = None,
                  h: Optional[Hypergraph] = None,
                  reps: int = 3) -> List[Tuple[str, float, str]]:
    """The closure-layer rows: the (max, min) closure (⌈log2 m⌉ launches of
    ``maxmin_matmul`` on the card), the threshold closure (as many of
    ``threshold_step``), and one (max, min) product, on the line graph of
    ``h`` (default: ``random_hypergraph(m // 2, m, ...)``, the
    reference's), float32 as in the reference."""
    dev = resolve_device(device)
    if h is None:
        h = random_hypergraph(m // 2, m, min_size=2, max_size=6, seed=0)
    w = device_line_graph(h, device=dev).to(torch.float32)
    mm = w.shape[0]
    rounds = int(np.ceil(np.log2(mm)))
    thr = distinct_thresholds(w)
    s = thr.size
    rows = []

    t1 = _ms(lambda: maxmin_closure(w, max_rounds=rounds), dev, reps)
    # maxmin closure: rounds × m³ compare+select ops (2 ops/elem)
    ops1 = rounds * 2 * mm ** 3
    rows.append((f"kernel.maxmin-closure.m{mm}", t1 * 1e3, "us-per-call"))
    rows.append((f"kernel.maxmin-closure.m{mm}.Gop", ops1 / 1e9, "Gops"))

    t2 = _ms(lambda: threshold_closure_mr(w, thr, rounds=rounds), dev, reps)
    # threshold closure: rounds × S × 2m³ multiply-adds (tensor cores)
    ops2 = rounds * s * 2 * mm ** 3
    rows.append((f"kernel.threshold-closure.m{mm}.S{s}", t2 * 1e3,
                 "us-per-call"))
    rows.append((f"kernel.threshold-closure.m{mm}.Gop", ops2 / 1e9, "Gops"))

    # the single (max,min) matmul building block
    t3 = _ms(lambda: maxmin_matmul(w, w), dev, reps)
    rows.append((f"kernel.maxmin-matmul.m{mm}", t3 * 1e3, "us-per-call"))
    return rows


# ---------------------------------------------------------------------------
# each kernel beside its plain version (and a library call where one exists)
# ---------------------------------------------------------------------------

def _plain_gather(ranks, svals, us, vs):
    """The gather entry point's plain version in id chunks, so its
    [Q, L, L] cube stays bounded."""
    l = ranks.shape[1]
    if us.numel() == 0 or l == 0:
        return lj.label_join_gather_ref(ranks, svals, us, vs)
    step = max(1, 2**25 // (l * l))
    return torch.cat([lj.label_join_gather_ref(ranks, svals, us[i:i + step],
                                               vs[i:i + step])
                      for i in range(0, us.numel(), step)])


def label_join_bench(n: int, m: int, q: int, sample: int, *,
                     device: DeviceLike = None, engine=None,
                     oracle_sample: Optional[int] = None) -> dict:
    """Batched MR on one snapshot: the per-call host merge-join, the
    snapshot's tensor-op join (``batched_mr``), and the
    ``label_join_gather`` kernel (its plain version on the host), answers
    held equal all ways; the first ``oracle_sample`` (default ``sample``)
    pairs also against the mst-oracle.  ``engine``: a built ``hl-index``
    engine to use instead of one on ``random_hypergraph(n, m, seed=0)``
    (at a published size, where the oracle's build is skipped with
    ``oracle_sample=0``)."""
    from repro_torch.api import build_engine
    from repro_torch.core.baselines import MSTOracle
    from repro_torch.core.query import KernelSnapshot

    dev = resolve_device(device)
    if engine is None:
        h = random_hypergraph(n, m, seed=0)
        engine = build_engine(h, "hl-index", device=dev)
    h = engine.h
    snap = engine.snapshot()
    kern = KernelSnapshot(snap)
    rng = np.random.default_rng(1)
    us = rng.integers(0, h.n, q)
    vs = rng.integers(0, h.n, q)
    du = torch.from_numpy(us).to(dev)
    dv = torch.from_numpy(vs).to(dev)

    sample = min(sample, q)
    t0 = time.perf_counter()
    host = [engine.mr(int(u), int(v))
            for u, v in zip(us[:sample], vs[:sample])]
    host_per_call = (time.perf_counter() - t0) / sample if sample else 0.0

    before = lj.GATHER_LAUNCHES
    kern_out = to_host(kern.mr(du, dv)).astype(np.int64)
    launched = lj.GATHER_LAUNCHES - before
    ops_out = to_host(snap.mr(du, dv)).astype(np.int64)
    plain_out = to_host(_plain_gather(snap.ranks, snap.svals, du,
                                      dv)).astype(np.int64)
    np.testing.assert_array_equal(kern_out, ops_out)
    np.testing.assert_array_equal(kern_out, plain_out)
    assert host == list(kern_out[:sample])
    oracle_sample = sample if oracle_sample is None else min(oracle_sample,
                                                             sample)
    if oracle_sample:
        oracle = MSTOracle(h)
        for u, v, got in zip(us[:oracle_sample], vs[:oracle_sample],
                             kern_out[:oracle_sample]):
            assert got == oracle.mr(int(u), int(v)), (u, v)

    kern_ms = _ms(lambda: kern.mr(du, dv), dev, 10)
    ops_ms = _ms(lambda: snap.mr(du, dv), dev, 10)
    plain_ms = _ms(lambda: _plain_gather(snap.ranks, snap.svals, du, dv),
                   dev, 1)
    row = {
        "graph": {"n": h.n, "m": h.m, "label_width_L": snap.lmax},
        "batch_q": q,
        "device": dev.type,
        "host_merge_join_per_call_us": host_per_call * 1e6,
        "host_merge_join_batch_us": host_per_call * q * 1e6,
        "torch_ops_snapshot_batch_us": ops_ms * 1e3,
        "kernel_label_join_gather_batch_us": kern_ms * 1e3,
        "kernel_ms": kern_ms,
        "plain_ms": plain_ms,
        "library_ms": None,      # no single PyTorch call gathers and joins
        "kernel_launches": launched if dev.type == "cuda" else 0,
        "answers_verified": int(q),
        "oracle_checked": int(oracle_sample),
    }
    row.update(_bound(dev, lambda: roofline.label_join_gather_bound(
        snap.svals, du, dv)[:2]))
    return _with_fraction(row)


def maxmin_bench(mm: int, *, device: DeviceLike = None) -> dict:
    """One (max,min) product of an [mm, mm] int32 operand with itself:
    the ``maxmin_matmul`` kernel against its plain version (no library
    call computes it)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(0, 100, (mm, mm)).astype(np.int32)) \
        .to(dev)
    # the plain version's [mm, block, mm] broadcast held to 2^28 values
    block = max(1, min(512, 2**28 // max(mm * mm, 1)))
    got, want = maxmin_matmul(a, a), maxmin_matmul_ref(a, a, block=block)
    if not torch.equal(got, want):
        raise AssertionError("maxmin_matmul disagrees with its plain version")
    row = {"m": mm, "device": dev.type,
           "kernel_ms": _ms(lambda: maxmin_matmul(a, a), dev),
           "plain_ms": _ms(lambda: maxmin_matmul_ref(a, a, block=block), dev,
                           1),
           "library_ms": None, "max_abs_err": 0}
    row.update(_bound(dev, lambda: roofline.maxmin_bound(mm, mm, mm)))
    return _with_fraction(row)


def overlap_bench(h: Hypergraph, *, device: DeviceLike = None) -> dict:
    """W = B·Bᵀ of ``h``'s incidence in bf16: the ``overlap`` kernel
    against its plain version and ``torch.matmul`` (bf16)."""
    dev = resolve_device(device)
    b32 = torch.from_numpy(h.to_incidence(np.float32)).to(dev)
    b16 = b32.to(torch.bfloat16)
    got, want = ov.overlap(b16), ov.overlap_ref(b32)
    if not torch.equal(got, want):
        raise AssertionError("overlap disagrees with its plain version")
    m, n = b16.shape
    row = {"shape": [m, n], "dtype": "bfloat16", "device": dev.type,
           "kernel_ms": _ms(lambda: ov.overlap(b16), dev, 10),
           "plain_ms": _ms(lambda: ov.overlap_ref(b32), dev, 10),
           "library_ms": _ms(lambda: torch.matmul(b16, b16.T), dev, 10),
           "max_abs_err": 0}
    row.update(_bound(dev, lambda: roofline.overlap_bound(m, n, 2)))
    return _with_fraction(row)


def threshold_bench(h: Hypergraph, *, device: DeviceLike = None) -> dict:
    """One threshold-closure round ``R @ R > 0`` over the [S, m, m] 0/1
    threshold adjacency of ``h``'s line graph (bf16): the
    ``threshold_step`` kernel against its plain version and ``torch.bmm``
    (bf16)."""
    dev = resolve_device(device)
    w = device_line_graph(h, device=dev)
    t = torch.as_tensor(distinct_thresholds(w)).to(dev)
    r = tc.threshold_adjacency(w, t, dtype=torch.bfloat16)
    del w
    got, want = tc.threshold_step(r), tc.threshold_step_ref(r)
    if not torch.equal(got, want):
        raise AssertionError("threshold_step disagrees with its plain version")
    del got, want
    s, m = r.shape[0], r.shape[1]
    row = {"shape": [s, m, m], "dtype": "bfloat16", "device": dev.type,
           "kernel_ms": _ms(lambda: tc.threshold_step(r), dev),
           "plain_ms": _ms(lambda: tc.threshold_step_ref(r), dev),
           "library_ms": _ms(lambda: torch.bmm(r, r), dev),
           "max_abs_err": 0}
    row.update(_bound(dev, lambda: roofline.threshold_bound(s, m, 2)))
    return _with_fraction(row)


def run(n: int, m: int, q: int, sample: int, mm: int, out_path: str, *,
        device: DeviceLike = None) -> dict:
    """All four kernels: ``label_join_gather`` on the ``hl-index``
    snapshot of ``random_hypergraph(n, m, seed=0)``, ``maxmin_matmul`` at
    ``[mm]^3``, ``overlap`` and ``threshold_step`` on the line graph of
    ``closure_bench``'s graph at ``mm``."""
    dev = resolve_device(device)
    closure_h = random_hypergraph(mm // 2, mm, min_size=2, max_size=6,
                                  seed=0)
    ljr = label_join_bench(n, m, q, sample, device=dev)
    mx = maxmin_bench(mm, device=dev)
    ovr = overlap_bench(closure_h, device=dev)
    thr = threshold_bench(closure_h, device=dev)
    print(f"label_join_gather: host {ljr['host_merge_join_batch_us']:.0f}us "
          f"(per-call x{q}) | tensor-op batch "
          f"{ljr['torch_ops_snapshot_batch_us']:.0f}us | kernel "
          f"{ljr['kernel_label_join_gather_batch_us']:.0f}us "
          f"(device={dev.type})")
    for name, row in (("maxmin_matmul", mx), ("overlap", ovr),
                      ("threshold_step", thr)):
        print(f"{name}: kernel {row['kernel_ms']:.3f} ms | plain "
              f"{row['plain_ms']:.3f} ms | library {row['library_ms']} ms "
              f"| bound {row['bound_ms']} ms")
    doc = {
        "note": ("Hand-written kernels beside their plain PyTorch versions "
                 "and the library call where one computes the same "
                 "function.  device=cuda: CUDA events, bounds from "
                 "repro_torch.benchmarks.roofline (H100 rates).  "
                 "device=cpu: the wrappers ran their plain versions on "
                 "the host, timed on the host clock; no bound and no "
                 "roofline fraction are given.  Every label-join answer "
                 "is held equal to the tensor-op join and the host "
                 "merge-join and spot-checked against the mst-oracle; "
                 "every dense answer equals its plain version."),
        "device": dev.type,
        "env": env_block(dev),
        "label_join": ljr,
        "maxmin_matmul": mx,
        "overlap": ovr,
        "threshold_step": thr,
    }
    write_doc(doc, out_path)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="tiny sizes for a smoke run")
    add_common_args(ap, "kernels")
    args = ap.parse_args(argv)
    if args.quick:
        run(n=200, m=160, q=512, sample=128, mm=128, out_path=args.out,
            device=args.device)
    else:
        run(n=1000, m=800, q=2048, sample=256, mm=512, out_path=args.out,
            device=args.device)


if __name__ == "__main__":
    main()
