#!/usr/bin/env python3
"""A/B of variants of the port's tensor-core product on an NVIDIA Hopper GPU.

    PYTHONPATH=src python3 tools/tc_variants.py [--rounds 7] [--reps 5]

Each variant is ``src/repro_torch/kernels/csrc/tc_gemm.cuh`` with a few
exact text edits (each must match the header once; the script stops if one
does not).  Every variant's ``threshold_step`` and ``overlap`` libraries are
compiled from a copy of the sources into ``build/tc_variants/<variant>/``,
all ``nvcc`` processes started together, and launched through ``ctypes`` on
the operands of the closure path: primary-school at its published size
(242 vertices, 12,704 hyperedges, edge sizes 2-5, seed 4), i.e. the first
threshold round ``R [S, 12,704, 12,704]`` bf16 and the incidence
``B [12,704, 248]`` bf16 (242 columns padded to 248).

Checks: each variant's answer equals the committed kernel's bit for bit,
and the committed kernel equals its plain version (``no_stores`` writes
nothing and is only timed).  Times: CUDA events around single launches,
in interleaved rounds (every variant, then the bf16 library call and the
plain version, once per round, in order), median per round; printed per
variant beside its ratio to the committed kernel in the same round.  Then
each of ``committed``, ``one_group_in_flight`` and ``torch.bmm`` runs back
to back for about two seconds while ``nvidia-smi`` samples the SM clock
and the power draw.

Output: the card's name and power limit, then one JSON object per line.
Exits non-zero without a CUDA device or ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
GRAPH = dict(n=242, m=12_704, min_size=2, max_size=5, seed=4)

_RASTER = "constexpr int GROUP_PAIRS = 8;"
_IN_FLIGHT = "constexpr int MMA_IN_FLIGHT = 2;"


def _raster(pairs):
    return (_RASTER, _RASTER.replace("8", str(pairs)))


# variant -> (edits of the header, whether its answer is checked)
VARIANTS = {
    "committed": ([], True),
    # one wgmma group pending per warpgroup: a stage is released one k step
    # after it was read, not two
    "one_group_in_flight": ([(_IN_FLIGHT, _IN_FLIGHT.replace("2", "1"))],
                            True),
    # raster groups of other sizes (row-tile pairs walked per column tile)
    "raster_2": ([_raster(2)], True),
    "raster_4": ([_raster(4)], True),
    "raster_32": ([_raster(32)], True),
    # the epilogue's vector stores skipped (a condition no 0/1 sum meets):
    # what the tile's stores cost on top of its main loop
    "no_stores": ([("if (r < M && c < N) {",
                    "if (r < M && c < N && acc[4 * j] < 0.0f) {")], False),
}
SOURCES = ("threshold_step", "overlap")
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_void_p]


def build_variants(csrc: Path, out_dir: Path, nvcc: str, flags) -> dict:
    """variant -> {source: CDLL}, compiled in parallel."""
    header = (csrc / "tc_gemm.cuh").read_text()
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        text = header
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: edit does not match the "
                                   f"header once: {old!r}")
            text = text.replace(old, new)
        vdir = out_dir / name
        shutil.rmtree(vdir, ignore_errors=True)
        vdir.mkdir(parents=True)
        for f in csrc.glob("*.cuh"):
            shutil.copy(f, vdir / f.name)
        (vdir / "tc_gemm.cuh").write_text(text)
        for src in SOURCES:
            shutil.copy(csrc / f"{src}.cu", vdir / f"{src}.cu")
            procs[name, src] = subprocess.Popen(
                [nvcc, *flags, "-o", str(vdir / f"{src}.so"),
                 str(vdir / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for (name, src), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} {src}.cu: nvcc failed\n{log}")
        logs.setdefault(name, {})[src] = [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "warning" in ln]
        lib = ctypes.CDLL(str(out_dir / name / f"{src}.so"))
        fn = getattr(lib, "threshold_step_launch" if src == "threshold_step"
                     else "overlap_bf16_launch")
        fn.argtypes, fn.restype = _ARGS, ctypes.c_int
        libs.setdefault(name, {})[src] = fn
    return libs, logs


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of one call of ``fn`` (CUDA events)."""
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


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def sustained(fn, seconds: float) -> dict:
    """``fn`` back to back for ``seconds`` while another thread samples the
    SM clock (MHz) and the power draw (W); medians of the samples."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60).stdout.strip().split(",")
            samples.append((float(out[0]), float(out[1])))
    fn()
    torch.cuda.synchronize()
    thread = threading.Thread(target=sample)
    thread.start()
    t0, calls = time.perf_counter(), 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    while time.perf_counter() - t0 < seconds:
        fn()
        calls += 1
        if calls % 8 == 0:
            torch.cuda.synchronize()
    end.record()
    end.synchronize()
    stop.set()
    thread.join()
    return {"calls": calls, "ms_per_call": start.elapsed_time(end) / calls,
            "sm_clock_mhz": statistics.median(s[0] for s in samples),
            "power_w": statistics.median(s[1] for s in samples),
            "samples": len(samples)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=7)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tc_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import random_hypergraph
    from repro_torch.core import semiring
    from repro_torch.device import find_nvcc
    from repro_torch.kernels import build
    from repro_torch.kernels import overlap as ov
    from repro_torch.kernels import threshold_closure as tc
    nvcc = find_nvcc()
    if nvcc is None:
        print("tc_variants: nvcc not found", file=sys.stderr)
        return 1
    print(smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    libs, logs = build_variants(build.CSRC_DIR, ROOT / "build" / "tc_variants",
                                nvcc, build.NVCC_FLAGS)
    print(json.dumps({"build_seconds": time.perf_counter() - t0,
                      "ptxas": logs}), flush=True)

    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    h = random_hypergraph(GRAPH["n"], GRAPH["m"], min_size=GRAPH["min_size"],
                          max_size=GRAPH["max_size"], seed=GRAPH["seed"])
    b16 = ov.pad_columns(torch.from_numpy(h.to_incidence(np.float32))
                         .to(dev).to(torch.bfloat16))
    w = semiring.device_line_graph(h)
    thresholds = semiring.distinct_thresholds(w)
    r = tc.threshold_adjacency(w, torch.as_tensor(thresholds),
                               dtype=torch.bfloat16)
    del w
    s, m, _ = r.shape
    n = b16.shape[1]
    want_t = tc.threshold_step(r)
    if not torch.equal(want_t, tc.threshold_step_ref(r)):
        raise AssertionError("committed threshold_step != its plain version")
    want_o = ov.overlap(b16)
    out_t, out_o = torch.empty_like(r), torch.empty_like(want_o)

    def run(name, src):
        if src == "threshold_step":
            args_ = (r.data_ptr(), out_t.data_ptr(), s, m)
        else:
            args_ = (b16.data_ptr(), out_o.data_ptr(), b16.shape[0], n)
        err = libs[name][src](*args_, stream())
        if err:
            raise RuntimeError(f"{name} {src}: launch failed, CUDA error {err}")

    for name, (_, checked) in VARIANTS.items():
        if not checked:
            continue
        for src, out, want in (("threshold_step", out_t, want_t),
                               ("overlap", out_o, want_o)):
            out.zero_()
            run(name, src)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"variant {name} {src}: answer differs")
    print(json.dumps({"checked": [v for v, (_, c) in VARIANTS.items() if c],
                      "tolerance": 0, "shape_threshold": [s, m, m],
                      "shape_overlap": list(b16.shape)}), flush=True)

    others = {
        "threshold_step": {"library_bf16": lambda: torch.bmm(r, r),
                           "plain": lambda: tc.threshold_step_ref(r)},
        "overlap": {"library_bf16": lambda: torch.matmul(b16, b16.T),
                    "plain": lambda: ov.overlap_ref(b16.float())},
    }
    for src in SOURCES:
        per_round = {name: [] for name in [*VARIANTS, *others[src]]}
        for _ in range(args.rounds):
            for name in VARIANTS:
                per_round[name].append(
                    cuda_ms(lambda: run(name, src), reps=args.reps))
            for name, fn in others[src].items():
                per_round[name].append(cuda_ms(fn, reps=args.reps))
        base = per_round["committed"]
        for name, times in per_round.items():
            ratio = [t / b for t, b in zip(times, base)]
            print(json.dumps({
                "kernel": src, "variant": name,
                "ms_median": statistics.median(times),
                "ratio_to_committed_median": statistics.median(ratio),
                "ratio_min": min(ratio), "ratio_max": max(ratio),
                "ms_per_round": times}), flush=True)

    for name, fn in (("committed", lambda: run("committed", "threshold_step")),
                     ("one_group_in_flight",
                      lambda: run("one_group_in_flight", "threshold_step")),
                     ("library_bf16", lambda: torch.bmm(r, r))):
        print(json.dumps({"kernel": "threshold_step", "sustained": name,
                          **sustained(fn, 2.0)}), flush=True)
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
