"""One benchmark per paper table/figure, on the port.

Exp-1 (Fig. 2): total MR query time — Base, Base*, ETE-reach, VTE-reach,
               Min-reach, TCI (HypED-analog), the batched snapshot join
               (tensor ops and the ``label_join_gather`` kernel), the
               sparse frontier.
Exp-2 (Tab. IV time): indexing time — Construct-Base / Construct /
               Construct* (+ the exact-necessity variant).
Exp-3 (Tab. IV space): |H|, |L|, |L*|, full adjacency N, peak
               neighbor-index M̂.
Exp-4 (Fig. 3): scalability — 20..100% hyperedge subsets.
Exp-5 (Fig. 4): epidemic case study on a co-location hypergraph.

Row names are the reference's (``benchmarks/paper_tables.py``), but for
its ``exp1.<ds>.Min-batched-jax`` row (the fused XLA batch), which has two
counterparts here, named by route: ``Min-batched-torch-ops`` (the
snapshot's tensor-op join, ``use_kernels=False``) and
``Min-batched-kernel`` (the ``label_join_gather`` kernel,
``use_kernels=True``).  Every function takes ``device`` (``None`` means
``"cuda"``; ``"cpu"`` runs on the host), and every backend that can join
or contract through a kernel is built with ``use_kernels=True``.
"""
from __future__ import annotations

import time
from typing import Callable, List, Tuple

import numpy as np

from repro_torch.api import available_backends, build_engine
from repro_torch.core.hlindex import build_basic, build_fast
from repro_torch.core.hypergraph import Hypergraph, from_edge_lists
from repro_torch.core.minimal import exact_minimize, minimize
from repro_torch.core.online import precompute_neighbors
from repro_torch.core.query import KernelSnapshot
from repro_torch.device import DeviceLike, resolve_device

from .common import to_host
from .datasets import make_dataset

__all__ = ["exp1_query_time", "exp2_indexing_time", "exp3_space",
           "exp4_scalability", "exp5_case_study", "engine_suite",
           "sharded_suite", "KERNEL_BACKENDS", "BATCHED_ROUTES"]

# backends whose build takes use_kernels (a label_join_gather or
# maxmin_matmul route); the closure backend launches its kernels on the
# card always
KERNEL_BACKENDS = frozenset({"hl-index", "hl-index-basic", "ete", "sharded"})
# the reference's exp1 Min-batched-jax row -> its counterparts here
BATCHED_ROUTES = ("Min-batched-torch-ops", "Min-batched-kernel")


def _timeit(fn: Callable, *, reps: int = 1) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def _query_pairs(h: Hypergraph, k: int = 1000, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, h.n, k), rng.integers(0, h.n, k)


def _opts(backend: str) -> dict:
    return {"use_kernels": True} if backend in KERNEL_BACKENDS else {}


def _batched_rows(tag: str, mn, us, vs, n_q: int):
    """The Min-reach engine's snapshot joined by tensor ops and by the
    ``label_join_gather`` kernel (one launch a call on the card): the
    answers of both held equal, each timed over 5 calls after a warm-up."""
    snap = mn.snapshot()
    kern = KernelSnapshot(snap)
    rows, outs = [], []
    for route, view in zip(BATCHED_ROUTES, (snap, kern)):
        out = to_host(view.mr(us, vs))          # warm
        t = _timeit(lambda v=view: to_host(v.mr(us, vs)), reps=5)
        rows.append((f"{tag}.{route}", t / n_q * 1e6, "per-query-us"))
        outs.append(out)
    if not np.array_equal(outs[0], outs[1]):
        raise AssertionError(
            f"{tag}: kernel join disagrees with the tensor-op join "
            f"({int((outs[0] != outs[1]).sum())}/{n_q} mismatches)")
    return rows


def exp1_query_time(dataset: str = "BK-s", n_q: int = 1000,
                    include_online: bool = True, *,
                    device: DeviceLike = None,
                    engine=None) -> List[Tuple[str, float, str]]:
    """Total time for n_q MR queries per method (paper Fig. 2).

    Every method is built and queried through the ``repro_torch.api``
    facade — the paper's method names map onto registry backends:
    Base/Base* -> "online", ETE-reach -> "ete", TCI -> "threshold",
    VTE-reach -> "hl-index" (unminimized), Min-reach -> "hl-index",
    Min-batched-* -> its device snapshot, Sparse-frontier -> "frontier".

    ``engine``: a built (minimized) ``hl-index`` engine to time instead of
    building one on ``make_dataset(dataset)`` — at a published size,
    where the other methods' builds take minutes; only its rows
    (Min-reach, Min-batched-*) are given then, named by ``dataset``.
    """
    tag = f"exp1.{dataset}"
    if engine is not None:
        h = engine.h
        us, vs = _query_pairs(h, n_q)
        t = _timeit(lambda: [engine.mr(int(u), int(v))
                             for u, v in zip(us, vs)])
        rows = [(f"{tag}.Min-reach", t / n_q * 1e6, "per-query-us")]
        return rows + _batched_rows(tag, engine, us, vs, n_q)

    dev = resolve_device(device)
    h = make_dataset(dataset)
    us, vs = _query_pairs(h, n_q)
    rows = []

    vte = build_engine(h, "hl-index", minimize_labels=False, device=dev)
    mn = build_engine(h, "hl-index", index=vte.idx, device=dev)
    ete = build_engine(h, "ete", device=dev)
    tci = build_engine(h, "threshold", device=dev)

    if include_online:
        sub = min(n_q, 50)              # online is orders slower; extrapolate
        base = build_engine(h, "online", precompute=False, device=dev)
        base_star = build_engine(h, "online", device=dev)
        t = _timeit(lambda: [base.mr(int(u), int(v))
                             for u, v in zip(us[:sub], vs[:sub])])
        rows.append((f"{tag}.Base", t / sub * 1e6, "per-query-us"))
        t = _timeit(lambda: [base_star.mr(int(u), int(v))
                             for u, v in zip(us[:sub], vs[:sub])])
        rows.append((f"{tag}.Base*", t / sub * 1e6, "per-query-us"))

    t = _timeit(lambda: [ete.mr(int(u), int(v)) for u, v in zip(us, vs)])
    rows.append((f"{tag}.ETE-reach", t / n_q * 1e6, "per-query-us"))
    t = _timeit(lambda: [tci.mr(int(u), int(v)) for u, v in zip(us, vs)])
    rows.append((f"{tag}.TCI(HypED-like)", t / n_q * 1e6, "per-query-us"))
    t = _timeit(lambda: [vte.mr(int(u), int(v)) for u, v in zip(us, vs)])
    rows.append((f"{tag}.VTE-reach", t / n_q * 1e6, "per-query-us"))
    t = _timeit(lambda: [mn.mr(int(u), int(v)) for u, v in zip(us, vs)])
    rows.append((f"{tag}.Min-reach", t / n_q * 1e6, "per-query-us"))

    rows += _batched_rows(tag, mn, us, vs, n_q)

    # index-free sparse frontier engine (for graphs beyond dense scale)
    fr = build_engine(h, "frontier", rounds=min(h.m, 64), device=dev)
    sub = min(n_q, 100)
    _ = fr.mr_batch(us[:4], vs[:4])                          # warm
    t = _timeit(lambda: fr.mr_batch(us[:sub], vs[:sub]))
    rows.append((f"{tag}.Sparse-frontier", t / sub * 1e6, "per-query-us"))
    return rows


def _bench_backend(prefix: str, builder: Callable, us, vs,
                   want: np.ndarray) -> List[Tuple[str, float, str]]:
    """Build, warm, time, and cross-validate one engine: emits
    ``{prefix}.build`` (total-us), ``{prefix}.batch-query``
    (per-query-us), ``{prefix}.agrees-with-oracle`` (bool; raises on
    disagreement).  The build clock stops after ``block_until_built()``
    (the engine-protocol hook for backends that build on the card) and
    the batch clock after the answers are on the host."""
    n_q = len(want)
    t0 = time.perf_counter()
    eng = builder()
    getattr(eng, "block_until_built", lambda: None)()
    t_build = time.perf_counter() - t0
    _ = eng.mr_batch(us, vs)          # warm at the timed shape
    t0 = time.perf_counter()
    got = to_host(eng.mr_batch(us, vs))
    t_q = time.perf_counter() - t0
    agrees = np.array_equal(got.astype(np.int64), want)
    if not agrees:
        raise AssertionError(
            f"{prefix} disagrees with mst-oracle "
            f"({int((got.astype(np.int64) != want).sum())}/{n_q} mismatches)")
    return [(f"{prefix}.build", t_build * 1e6, "total-us"),
            (f"{prefix}.batch-query", t_q / n_q * 1e6, "per-query-us"),
            (f"{prefix}.agrees-with-oracle", float(agrees), "bool")]


def engine_suite(dataset: str = "ENG-s", n_q: int = 128, *,
                 device: DeviceLike = None) -> List[Tuple[str, float, str]]:
    """Every registered backend through the one facade: build time, batched
    query time, and a cross-validation bit against the "mst-oracle"
    reference answers (1.0 = identical on all n_q pairs)."""
    dev = resolve_device(device)
    h = make_dataset(dataset)
    us, vs = _query_pairs(h, n_q, seed=13)
    want = build_engine(h, "mst-oracle", device=dev).mr_batch(
        us, vs).astype(np.int64)
    rows: List[Tuple[str, float, str]] = []
    for backend in available_backends():
        # no rounds cap for frontier: the agreement assert needs exactness
        rows += _bench_backend(
            f"engine.{dataset}.{backend}",
            lambda b=backend: build_engine(h, b, device=dev,
                                           **_opts(b)),
            us, vs, want)
    return rows


def sharded_suite(dataset: str = "ENG-s", n_q: int = 128,
                  mesh=None, *,
                  device: DeviceLike = None) -> List[Tuple[str, float, str]]:
    """The ``sharded`` backend vs the single-device ``closure`` backend:
    build (= closure) time and batched query time for both schedules
    (allgather, ring), each cross-validated against the ``mst-oracle``
    reference.  ``mesh=None`` uses ``default_line_graph_mesh`` of
    ``device`` (1 x 1 on one card); a larger logical grid comes from
    ``make_mesh`` (``bench_sharded`` runs 1 x 1, 1 x 2 and 2 x 2).  The
    grid is logical: its blocks are views of one tensor on one device, so
    a row measures block contractions, never a collective."""
    from repro_torch.core.mesh import default_line_graph_mesh

    if mesh is None:
        mesh = default_line_graph_mesh(device=device)
    dev = mesh.device
    h = make_dataset(dataset)
    us, vs = _query_pairs(h, n_q, seed=13)
    want = build_engine(h, "mst-oracle", device=dev).mr_batch(
        us, vs).astype(np.int64)
    ndev = int(mesh.devices.size)
    rows: List[Tuple[str, float, str]] = [
        (f"sharded.{dataset}.devices", float(ndev), "count")]
    rows += _bench_backend(f"sharded.{dataset}.closure-1dev",
                           lambda: build_engine(h, "closure", device=dev),
                           us, vs, want)
    for sched in ("allgather", "ring"):
        rows += _bench_backend(
            f"sharded.{dataset}.sharded-{sched}-{ndev}dev",
            lambda s=sched: build_engine(h, "sharded", mesh=mesh, schedule=s,
                                         use_kernels=True),
            us, vs, want)
    return rows


def exp2_indexing_time(dataset: str = "NC-s",
                       include_basic: bool = True) -> List[Tuple[str, float, str]]:
    """Construction on the host (numpy), as in the reference."""
    h = make_dataset(dataset)
    rows = []
    if include_basic:
        t = _timeit(lambda: build_basic(h))
        rows.append((f"exp2.{dataset}.Construct-Base", t * 1e6, "total-us"))
    t = _timeit(lambda: build_fast(h))
    rows.append((f"exp2.{dataset}.Construct", t * 1e6, "total-us"))
    idx = build_fast(h)
    t2 = _timeit(lambda: minimize(idx))
    rows.append((f"exp2.{dataset}.Construct*", (t + t2) * 1e6, "total-us"))
    t3 = _timeit(lambda: exact_minimize(idx))
    rows.append((f"exp2.{dataset}.Construct-exactmin", (t + t3) * 1e6,
                 "total-us"))
    return rows


def exp3_space(dataset: str = "BK-s") -> List[Tuple[str, float, str]]:
    h = make_dataset(dataset)
    idx = build_fast(h)
    mn = minimize(idx)
    nc = precompute_neighbors(h)
    rows = [
        (f"exp3.{dataset}.H-bytes", h.e_idx.nbytes + h.v_idx.nbytes, "bytes"),
        (f"exp3.{dataset}.L-bytes", idx.nbytes(), "bytes"),
        (f"exp3.{dataset}.Lmin-bytes", mn.nbytes(), "bytes"),
        (f"exp3.{dataset}.N-adjacency-bytes", nc.nbytes(), "bytes"),
        (f"exp3.{dataset}.M-peak-bytes",
         idx.stats.get("m_peak_entries", 0) * 12, "bytes"),
        (f"exp3.{dataset}.labels", idx.num_labels, "count"),
        (f"exp3.{dataset}.labels-min", mn.num_labels, "count"),
    ]
    return rows


def exp4_scalability(dataset: str = "WA-s") -> List[Tuple[str, float, str]]:
    h = make_dataset(dataset)
    rng = np.random.default_rng(0)
    rows = []
    for frac in (0.2, 0.4, 0.6, 0.8, 1.0):
        k = max(int(h.m * frac), 1)
        keep = rng.choice(h.m, size=k, replace=False)
        sub = from_edge_lists([h.edge(int(e)) for e in keep], n=h.n)
        t = _timeit(lambda: build_fast(sub))
        idx = build_fast(sub)
        t2 = _timeit(lambda: minimize(idx))
        rows.append((f"exp4.{dataset}.{int(frac*100)}pct.construct",
                     t * 1e6, "total-us"))
        rows.append((f"exp4.{dataset}.{int(frac*100)}pct.construct*",
                     (t + t2) * 1e6, "total-us"))
        rows.append((f"exp4.{dataset}.{int(frac*100)}pct.index-labels",
                     idx.num_labels, "count"))
    return rows


def exp5_case_study(*, device: DeviceLike = None
                    ) -> List[Tuple[str, float, str]]:
    h = make_dataset("COLO")
    eng = build_engine(h, "hl-index", device=resolve_device(device),
                       use_kernels=True)
    patient_zero = int(np.argmax(h.vertex_degrees))
    others = np.arange(h.n)
    risk = to_host(eng.mr_batch(np.full(h.n, patient_zero), others))
    rows = [
        ("exp5.colo.n-people", h.n, "count"),
        ("exp5.colo.n-groups", h.m, "count"),
        ("exp5.colo.max-risk", int(risk[others != patient_zero].max()
                                   if h.n > 1 else 0), "MR"),
        ("exp5.colo.at-risk>=2", int((risk >= 2).sum()), "count"),
        ("exp5.colo.at-risk>=3", int((risk >= 3).sum()), "count"),
    ]
    return rows
