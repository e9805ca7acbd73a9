#!/usr/bin/env python3
"""A/B of variants of the port's ``label_join`` kernel on an NVIDIA Hopper GPU.

    PYTHONPATH=src python3 tools/label_join_variants.py [--parent DIR]
        [--rounds 7] [--reps 20]

Each variant is ``src/repro_torch/kernels/csrc/label_join.cu`` with a few
exact text edits (each must match the source once; the script stops if one
does not).  ``--parent DIR`` adds one more, ``parent``: the
``label_join.cu`` of another checkout of this repository (for example an
earlier commit unpacked with ``git archive``), which may lack the gather
entry point.  Every variant is compiled into
``build/label_join_variants/<variant>/`` with the port's ``nvcc`` flags,
all ``nvcc`` processes started together, and launched through ``ctypes``.

Operands: the main path's own snapshot (``hl-index`` on a seeded
89,000-vertex, 70,000-hyperedge ``random_hypergraph``, sizes 2-8, seed 6:
``[89,000, 15]``) with 2^20 random id pairs for the gather entry point,
and for ``label_join_launch`` the rows those ids gather plus seeded random
rows at ``[4096, 121]`` and ``[65536, 256]`` (as ``chip_smoke.py`` makes
them).  Beside the variants, each round times the two-step route (PyTorch's
row gather, then the committed kernel on the gathered rows).

Checks: every variant's answer equals the committed kernel's bit for bit
on every operand set, and the committed kernel equals its plain version.
Times: CUDA events around single launches, in interleaved rounds (every
variant once per round, in order), median per round; printed per variant
beside its ratio to the committed kernel in the same round (median and
range); and cold, each launch alone after a 256 MB scratch tensor is
written, which also keeps the card busy while the host enqueues it, so a
launch shorter than its host cost is timed without that cost.

Output: the card's name and power limit, then one JSON object per line.
Exits non-zero without a CUDA device or ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
GRAPH = dict(n=89_000, m=70_000, min_size=2, max_size=8, seed=6)
ROW_SHAPES = [(4096, 121), (65536, 256)]
QUERIES = 2**20

_BLOCK = "constexpr int SHORT_BLOCK = 128;"
_QPG = "constexpr int QUERIES_PER_GROUP = 2;"
_DUP = "if (__any_sync(FULL, r_next == r_v && s_next > s_v)) {"


def _edit(line, old, new):
    return (line, line.replace(old, new))


# variant -> edits of label_join.cu
VARIANTS = {
    "committed": [],
    # queries per lane group of the short-row route (reads in flight per
    # lane)
    "queries_per_group_1": [_edit(_QPG, "2", "1")],
    "queries_per_group_3": [_edit(_QPG, "2", "3")],
    # other block sizes of the short-row route
    "short_block_64": [_edit(_BLOCK, "128", "64")],
    "short_block_256": [_edit(_BLOCK, "128", "256")],
    # the repeated-rank test skipped (the compiler then drops its two
    # shuffles too): what the test costs on well-formed rows
    "no_duplicate_vote": [(_DUP, "if (false) {")],
}
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]
_GATHER_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_longlong]


def build_variants(csrc: Path, parent: Path, out_dir: Path, nvcc: str, flags):
    """variant -> (label_join_launch, label_join_gather_launch or None),
    compiled in parallel; and each variant's ptxas report."""
    source = (csrc / "label_join.cu").read_text()
    texts = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: edit does not match the "
                                   f"source once: {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    if parent is not None:
        texts["parent"] = (parent / "src" / "repro_torch" / "kernels" / "csrc"
                           / "label_join.cu").read_text()
    procs = {}
    for name, text in texts.items():
        vdir = out_dir / name
        shutil.rmtree(vdir, ignore_errors=True)
        vdir.mkdir(parents=True)
        (vdir / "label_join.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-o", str(vdir / "label_join.so"),
             str(vdir / "label_join.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, logs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
        logs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "warning" in ln]
        lib = ctypes.CDLL(str(out_dir / name / "label_join.so"))
        direct = lib.label_join_launch
        direct.argtypes, direct.restype = _ARGS + [ctypes.c_void_p], ctypes.c_int
        gather = getattr(lib, "label_join_gather_launch", None)
        if gather is not None:
            gather.argtypes = _GATHER_ARGS + [ctypes.c_void_p]
            gather.restype = ctypes.c_int
        fns[name] = (direct, gather)
    return fns, logs


def call(fn, *args):
    out_t = args[4]
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out_t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("label_join_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.device import find_nvcc
    from repro_torch.kernels import build as build_mod
    from repro_torch.kernels import label_join as lj

    print(cs.nvidia_smi_line(), flush=True)
    nvcc = find_nvcc()
    if nvcc is None:
        print("label_join_variants: nvcc not found", file=sys.stderr)
        return 1
    fns, logs = build_variants(build_mod.CSRC_DIR, args.parent,
                               ROOT / "build" / "label_join_variants", nvcc,
                               build_mod.NVCC_FLAGS)
    cs.emit({"ptxas": logs})

    device = torch.device("cuda")
    h = api.random_hypergraph(GRAPH["n"], GRAPH["m"],
                              min_size=GRAPH["min_size"],
                              max_size=GRAPH["max_size"], seed=GRAPH["seed"])
    snap = api.build_engine(h, "hl-index", use_kernels=True).snapshot()
    ranks, svals = snap.ranks, snap.svals
    n, lmax = ranks.shape
    rng = np.random.default_rng(11)
    us = torch.from_numpy(rng.integers(0, n, QUERIES)).to(device)
    vs = torch.from_numpy(rng.integers(0, n, QUERIES)).to(device)
    sets = {f"rows[{QUERIES},{lmax}]": (ranks[us], svals[us], ranks[vs],
                                        svals[vs])}
    gen = torch.Generator(device=device)
    for q, l in ROW_SHAPES:
        gen.manual_seed(q * 1000 + l)
        sets[f"rows[{q},{l}]"] = (*cs.random_rows(gen, q, l, 4 * l, device),
                                  *cs.random_rows(gen, q, l, 4 * l, device))
    out = torch.empty(max(QUERIES, *(q for q, _ in ROW_SHAPES)),
                      dtype=torch.int32, device=device)

    # every case: name -> {variant: zero-argument launch}
    cases = {}
    for tag, ops in sets.items():
        q, l = ops[0].shape
        o = out[:q]
        cases[tag] = {name: (lambda f=fns[name][0], o=o, ops=ops, q=q, l=l:
                             call(f, *ops, o, q, l))
                      for name in fns}
        want = cs.plain_chunked(lj.label_join_ref, *ops)
        for name, launch in cases[tag].items():
            if not torch.equal(launch().clone(), want):
                raise AssertionError(f"{tag}: variant {name} differs")
    by_id = f"by_id[{QUERIES},{lmax}]"
    o = out[:QUERIES]
    cases[by_id] = {name: (lambda f=fns[name][1], o=o:
                           call(f, ranks, svals, us, vs, o, QUERIES, lmax, n))
                    for name in fns if fns[name][1] is not None}
    committed_direct = fns["committed"][0]
    cases[by_id]["two_step"] = lambda o=o: call(
        committed_direct, ranks[us], svals[us], ranks[vs], svals[vs], o,
        QUERIES, lmax)
    want = cs.plain_gather_chunked(lj.label_join_gather_ref, ranks, svals,
                                   us, vs)
    for name, launch in cases[by_id].items():
        if not torch.equal(launch().clone(), want):
            raise AssertionError(f"{by_id}: variant {name} differs")

    scratch = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                          device=device)
    for tag, launches in cases.items():
        times = {name: [] for name in launches}
        cold = {name: [] for name in launches}
        for _ in range(args.rounds):
            for name, launch in launches.items():
                times[name].append(cs.cuda_ms(launch, reps=args.reps))
                cold[name].append(cs.cuda_ms_cold(launch, scratch, reps=5))
        rows = {}
        for name in launches:
            ratios = [t / c for t, c in zip(times[name], times["committed"])]
            rows[name] = {"ms": statistics.median(times[name]),
                          "ratio": statistics.median(ratios),
                          "ratio_range": [min(ratios), max(ratios)]}
            if cold[name]:
                rows[name]["cold_ms"] = statistics.median(cold[name])
        cs.emit({"case": tag, "rounds": args.rounds, "reps": args.reps,
                 "variants": rows})
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
