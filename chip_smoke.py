#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port: `python3 chip_smoke.py`.

Needs one NVIDIA GPU (built for Hopper, sm_90a) and `nvcc`; takes no
arguments.  It builds every hand-written kernel from the sources in this
checkout, holds each against its plain PyTorch version on the card, drives
the port's main path — batched max-reachability through
`repro_torch.api.build_engine(h, "hl-index", use_kernels=True)` — at full
size, and checks the answers.  Any failed phase raises: the script then
exits non-zero and prints no result line.  Without a CUDA device it exits
non-zero at once.

Output, one JSON object per line: `env`, `kernel_checks`, `main_path`,
`wide_labels`, then `{"kernels": [...]}` (per kernel: launches on the main
path, error against the plain version, times and the roofline bound), the
card's name and power limit as `nvidia-smi` prints them, and last
`{"ok": true, "device": {...}}`.

Times: a kernel's time is CUDA events around single launches on resident
operands, median after warm-up (operands up to a few tens of MB stay in
the 50 MB L2 between launches; the larger shapes do not).  A batch's time
is the host clock around `mr_batch`, host<->device copies included.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
# Integer compare/min/max run on the CUDA cores.  The data sheet's 67 TFLOP/s
# of float32 outside the tensor cores counts a fused multiply-add as two, so
# one simple 32-bit operation per lane and cycle is half of it.
INT32_OPS_PER_S = 67e12 / 2

LABEL_JOIN_CORPUS = [          # (q, l, seed): the reference's adversarial shapes
    (5, 7, 0), (130, 33, 1), (1, 1, 2), (64, 300, 3), (31, 129, 4),
    (0, 5, 5), (3, 0, 6),
]
MAIN_PATH_SHAPES = [(1024, 15), (4096, 121), (2**20, 15), (65536, 256)]
INT32_MAX = int(np.iinfo(np.int32).max)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` on the host clock; ``fn`` must end with
    its result on the host (so the device work is inside the window)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- operands -----------------------------------------------------------------

def corpus_rows(rng, q, l, high, max_rank):
    """Random padded label rows as the reference's differential harness makes
    them: ragged true lengths (all-pad rows included), ascending int32
    ranks, s values in [1, 9)."""
    ranks = np.full((q, l), INT32_MAX, np.int32)
    svals = np.zeros((q, l), np.int32)
    for i in range(q):
        li = int(rng.integers(0, l + 1))
        r = np.unique(rng.integers(0, max(high, 1), li)).astype(np.int64)
        ranks[i, :r.size] = np.minimum(r, max_rank)
        svals[i, :r.size] = rng.integers(1, 9, r.size)
    return ranks, svals


def random_rows(gen, q, l, high, device):
    """[q, l] padded label rows made on the card from a seeded generator:
    strictly ascending ranks below ``high + l``, ragged lengths in [0, l],
    s values in [1, 9), sentinel padding."""
    r = torch.randint(0, high, (q, l), generator=gen, device=device,
                      dtype=torch.int32)
    r = torch.sort(r, dim=1).values + torch.arange(l, device=device,
                                                   dtype=torch.int32)
    s = torch.randint(1, 9, (q, l), generator=gen, device=device,
                      dtype=torch.int32)
    length = torch.randint(0, l + 1, (q, 1), generator=gen, device=device)
    pad = torch.arange(l, device=device)[None, :] >= length
    return (r.masked_fill(pad, INT32_MAX).contiguous(),
            s.masked_fill(pad, 0).contiguous())


def plain_chunked(ref, ru, su, rv, sv):
    """The plain version in row chunks, so its [Q, L, L] cube fits."""
    q, l = ru.shape
    if q == 0 or l == 0:
        return ref(ru, su, rv, sv)
    step = max(1, 2**25 // (l * l))
    return torch.cat([ref(ru[i:i + step], su[i:i + step], rv[i:i + step],
                          sv[i:i + step]) for i in range(0, q, step)])


def label_join_bound(su, q, l):
    """Least time the card could take for this join, in ms, and what binds
    it.  Bytes: four [Q, L] int32 operands read once, [Q] int32 written
    once.  Operations, counted from this run's data: every real u label
    (s > 0) needs a lower-bound search of the v row (ceil(log2(L + 1))
    compares) plus one min and one max."""
    nbytes = 16 * q * l + 4 * q
    real = int((su > 0).sum())
    ops = real * (math.ceil(math.log2(l + 1)) + 2) if l else 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phases -------------------------------------------------------------------

def phase_env(build_mod):
    t0 = time.perf_counter()
    build_mod.build_libraries(["label_join"])
    seconds = time.perf_counter() - t0
    ptxas = [ln for ln in build_mod.BUILD_LOG.get("label_join", "").splitlines()
             if "registers" in ln or "error" in ln.lower()]
    env = {"phase": "env", "python": sys.version.split()[0],
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "card": nvidia_smi_line(),
           "kernel_build_seconds": round(seconds, 3), "ptxas": ptxas}
    emit(env)
    return env


def check_equal(name, got, want):
    """Exact equality (tolerance 0: integers), returns max |got - want|."""
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(max abs err {err})")
    return err


def time_shape(lj, join_ops, ru, su, rv, sv):
    """Kernel / plain / tensor-op times and the bound for one operand set."""
    q, l = ru.shape
    big = q * l * l > 2**28
    bound_ms, bound_by = label_join_bound(su, q, l)
    return {
        "ms": cuda_ms(lambda: lj.label_join(ru, su, rv, sv), reps=30),
        "plain_ms": cuda_ms(lambda: plain_chunked(lj.label_join_ref, ru, su,
                                                  rv, sv),
                            reps=3 if big else 10, warmup=1),
        "torch_ops_ms": cuda_ms(lambda: join_ops(ru, su, rv, sv), reps=20),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def phase_kernel_checks(lj, join_ops, device):
    """label_join on the card against its plain version: the reference's
    corpus, its two sentinel cases, and the main path's shapes (timed)."""
    max_err = 0
    rows = []

    def compare(tag, ru, su, rv, sv):
        nonlocal max_err
        ru, su, rv, sv = (torch.as_tensor(t, dtype=torch.int32).to(device)
                          .contiguous() for t in (ru, su, rv, sv))
        got = lj.label_join(ru, su, rv, sv)
        want = plain_chunked(lj.label_join_ref, ru, su, rv, sv)
        max_err = max(max_err, check_equal(tag, got, want))
        if not torch.equal(got, join_ops(ru, su, rv, sv)):
            raise AssertionError(f"{tag}: kernel and searchsorted join differ")
        return ru, su, rv, sv, got

    for q, l, seed in LABEL_JOIN_CORPUS:
        rng = np.random.default_rng(seed)
        u = corpus_rows(rng, q, l, 200, lj.MAX_RANK)
        v = corpus_rows(rng, q, l, 200, lj.MAX_RANK)
        compare(f"corpus[{q},{l}]", u[0], u[1], v[0], v[1])
        rows.append({"shape": [q, l], "case": "corpus", "equal": True})

    # MAX_RANK itself is a legal rank and must join
    *_, got = compare("sentinel-bound", [[0, lj.MAX_RANK]], [[3, 5]],
                      [[lj.MAX_RANK, INT32_MAX]], [[4, 0]])
    if got.tolist() != [4]:
        raise AssertionError(f"sentinel-bound case answered {got.tolist()}")
    rows.append({"shape": [1, 2], "case": "sentinel-bound", "equal": True})
    # all-pad rows never match
    pad_r = np.full((3, 4), INT32_MAX, np.int32)
    pad_s = np.zeros((3, 4), np.int32)
    *_, got = compare("all-pad", pad_r, pad_s, pad_r, pad_s)
    if got.tolist() != [0, 0, 0]:
        raise AssertionError(f"all-pad case answered {got.tolist()}")
    rows.append({"shape": [3, 4], "case": "all-pad", "equal": True})

    gen = torch.Generator(device=device)
    for q, l in MAIN_PATH_SHAPES:
        gen.manual_seed(q * 1000 + l)
        ru, su = random_rows(gen, q, l, 4 * l, device)
        rv, sv = random_rows(gen, q, l, 4 * l, device)
        ru, su, rv, sv, got = compare(f"main[{q},{l}]", ru, su, rv, sv)
        row = {"shape": [q, l], "case": "main-path shape", "equal": True,
               "share_nonzero": float((got > 0).float().mean())}
        row.update(time_shape(lj, join_ops, ru, su, rv, sv))
        rows.append(row)
    emit({"phase": "kernel_checks", "kernel": "label_join",
          "tolerance": 0, "max_abs_err": max_err, "cases": rows})
    return max_err


def drive_batches(eng, batches, s):
    """One ``mr_batch`` and one ``s_reach_batch`` per batch."""
    return [(eng.mr_batch(us, vs), eng.s_reach_batch(us, vs, s))
            for us, vs in batches]


def check_answers(tag, answers, plain_answers, s):
    for (mr, sr), (mr0, sr0) in zip(answers, plain_answers):
        if mr.dtype != np.int32 or sr.dtype != np.bool_:
            raise AssertionError(f"{tag}: dtypes {mr.dtype}, {sr.dtype}")
        if mr.shape != mr0.shape or not np.array_equal(mr, mr0):
            raise AssertionError(f"{tag}: kernel path and batched_mr differ")
        if not np.array_equal(sr, sr0) or not np.array_equal(sr, mr >= s):
            raise AssertionError(f"{tag}: s_reach answers differ")
        if not np.isfinite(mr).all() or (mr < 0).any():
            raise AssertionError(f"{tag}: answers out of range")


def phase_main_path(api, engine_mod, lj, join_ops, device):
    """The full-size main path: 89,000 vertices, 70,000 hyperedges."""
    s = 2
    t0 = time.perf_counter()
    h = api.random_hypergraph(89_000, 70_000, min_size=2, max_size=8, seed=6)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = api.build_engine(h, "hl-index", use_kernels=True)
    build_s = time.perf_counter() - t0
    snap = eng.snapshot()
    if snap.ranks.device.type != "cuda":
        raise AssertionError("snapshot did not land on the card")
    plain_eng = engine_mod.HLIndexEngine(h, eng.idx, device=device)

    rng = np.random.default_rng(11)
    sizes = [1000, 4096, 2**20]
    batches = [(rng.integers(0, h.n, q), rng.integers(0, h.n, q))
               for q in sizes]

    # the counted run: every count to 0, drive, read
    lj.LAUNCHES = 0
    answers = drive_batches(eng, batches, s)
    torch.cuda.synchronize()
    launches = lj.LAUNCHES
    if launches != 2 * len(batches):
        raise AssertionError(f"expected one label_join launch per batch "
                             f"({2 * len(batches)}), counted {launches}")

    lj.LAUNCHES = 0
    plain_answers = drive_batches(plain_eng, batches, s)
    if lj.LAUNCHES != 0:
        raise AssertionError("use_kernels=False went through the kernel")
    check_answers("main_path", answers, plain_answers, s)

    us, vs = batches[0]
    mr1000 = answers[0][0]
    scalar = np.array([eng.mr(int(u), int(v)) for u, v in zip(us, vs)])
    if not np.array_equal(scalar, mr1000):
        raise AssertionError("main_path: batch differs from host merge-join")
    t0 = time.perf_counter()
    oracle = api.build_engine(h, "mst-oracle")
    want = [oracle.mr(int(u), int(v)) for u, v in zip(us[:32], vs[:32])]
    oracle_s = time.perf_counter() - t0
    if want != mr1000[:32].tolist():
        raise AssertionError("main_path: batch differs from the MST oracle")

    # the kernel on the rows this path gave it (largest batch), vs plain
    bu = torch.from_numpy(batches[-1][0]).to(device)
    bv = torch.from_numpy(batches[-1][1]).to(device)
    ru, su, rv, sv = snap.ranks[bu], snap.svals[bu], snap.ranks[bv], snap.svals[bv]
    got = lj.label_join(ru, su, rv, sv)
    err = check_equal("main_path rows", got,
                      plain_chunked(lj.label_join_ref, ru, su, rv, sv))
    if not np.array_equal(got.cpu().numpy(), answers[-1][0]):
        raise AssertionError("main_path: engine answer differs from wrapper")
    kernel_times = time_shape(lj, join_ops, ru, su, rv, sv)
    kernel_times["shape"] = list(ru.shape)

    # where one batch's time goes, step by step, for the largest batch
    hus, hvs = batches[-1]
    checked = engine_mod.validate_batch(hus, hvs, h.n)
    stacked = torch.from_numpy(np.stack(checked))
    breakdown = {
        "queries": sizes[-1],
        "host_validate_ms": host_ms(
            lambda: np.stack(engine_mod.validate_batch(hus, hvs, h.n)), 5),
        "ids_to_device_ms": host_ms(
            lambda: (stacked.to(device), torch.cuda.synchronize()), 5),
        "gather_ms": cuda_ms(
            lambda: (snap.ranks[bu], snap.svals[bu], snap.ranks[bv],
                     snap.svals[bv]), reps=20),
        "label_join_ms": kernel_times["ms"],
        "answers_to_host_ms": host_ms(lambda: got.cpu().numpy(), 5),
    }

    rates = []
    for (bus, bvs), q in zip(batches, sizes):
        reps = 5 if q > 100_000 else 20
        k_ms = host_ms(lambda: eng.mr_batch(bus, bvs), reps)
        p_ms = host_ms(lambda: plain_eng.mr_batch(bus, bvs), reps)
        rates.append({"queries": q, "kernel_batch_ms": k_ms,
                      "kernel_queries_per_s": q / k_ms * 1e3,
                      "batched_mr_batch_ms": p_ms,
                      "batched_mr_queries_per_s": q / p_ms * 1e3})
    emit({"phase": "main_path", "n": h.n, "m": h.m, "nnz": h.nnz,
          "labels": eng.idx.num_labels, "lmax": snap.lmax,
          "snapshot_bytes": snap.nbytes(),
          "generate_seconds": round(gen_s, 3),
          "build_seconds": round(build_s, 3),
          "oracle_pairs": 32, "oracle_seconds": round(oracle_s, 3),
          "merge_join_pairs": 1000, "s": s,
          "label_join_launches": launches,
          "share_nonzero": [float((a[0] > 0).mean()) for a in answers],
          "batch_times_include": "host->device ids, gather, join, "
                                 "device->host answers",
          "batches": rates, "largest_batch_breakdown": breakdown})
    return launches, err, kernel_times


def phase_wide_labels(api, engine_mod, lj, device):
    """Wide label rows (Lmax about 52) through the same path and checks."""
    s = 3
    h = api.random_hypergraph(400, 4000, min_size=2, max_size=6, seed=5)
    t0 = time.perf_counter()
    eng = api.build_engine(h, "hl-index", use_kernels=True)
    build_s = time.perf_counter() - t0
    plain_eng = engine_mod.HLIndexEngine(h, eng.idx, device=device)
    rng = np.random.default_rng(12)
    batches = [(rng.integers(0, h.n, q), rng.integers(0, h.n, q))
               for q in (200, 4096)]
    before = lj.LAUNCHES
    answers = drive_batches(eng, batches, s)
    launches = lj.LAUNCHES - before
    if launches != 2 * len(batches):
        raise AssertionError(f"wide_labels: {launches} launches for "
                             f"{2 * len(batches)} batches")
    check_answers("wide_labels", answers,
                  drive_batches(plain_eng, batches, s), s)
    us, vs = batches[0]
    mr200 = answers[0][0]
    scalar = np.array([eng.mr(int(u), int(v)) for u, v in zip(us, vs)])
    if not np.array_equal(scalar, mr200):
        raise AssertionError("wide_labels: batch differs from host merge-join")
    # the oracle walks the spanning forest once per hyperedge pair, seconds
    # per query at this density, so it checks the first pairs only
    n_oracle = 16
    t0 = time.perf_counter()
    oracle = api.build_engine(h, "mst-oracle")
    want = [oracle.mr(int(u), int(v))
            for u, v in zip(us[:n_oracle], vs[:n_oracle])]
    oracle_s = time.perf_counter() - t0
    if want != mr200[:n_oracle].tolist():
        raise AssertionError("wide_labels: batch differs from the MST oracle")
    emit({"phase": "wide_labels", "n": h.n, "m": h.m, "nnz": h.nnz,
          "labels": eng.idx.num_labels, "lmax": eng.snapshot().lmax,
          "build_seconds": round(build_s, 3), "merge_join_pairs": 200,
          "oracle_pairs": n_oracle, "oracle_seconds": round(oracle_s, 3),
          "s": s, "label_join_launches": launches,
          "answer_histogram": np.bincount(answers[1][0]).tolist()})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import api
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.query import searchsorted_join
    from repro_torch.kernels import build as build_mod
    from repro_torch.kernels import label_join as lj

    device = torch.device("cuda")
    phase_env(build_mod)
    err_checks = phase_kernel_checks(lj, searchsorted_join, device)
    launches, err_main, times = phase_main_path(api, engine_mod, lj,
                                                searchsorted_join, device)
    phase_wide_labels(api, engine_mod, lj, device)
    torch.cuda.synchronize()

    emit({"kernels": [{
        "name": "label_join", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/label_join.cu",
        "replaces": "src/repro/kernels/label_join.py:106",
        "launches": launches, "max_abs_err": max(err_checks, err_main),
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": None,    # no single PyTorch call computes this join
        "torch_ops_ms": times["torch_ops_ms"], "shape": times["shape"],
    }]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
