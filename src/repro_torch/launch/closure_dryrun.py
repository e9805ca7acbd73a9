"""Paper-core dry-run: one squaring round of the reachability closure at
production scale (m = 65,536) on the production mesh, priced for H100s,
and run on one card.

Counterpart of ``repro/launch/closure_dryrun.py``: the same eight cells
(``main``), file tags and record keys.  Cells (one squaring round each;
a full closure is ⌈log2 m⌉ rounds):

* maxmin-closure     m = 65,536, float32, 2-D blocks over (data, model),
  allgather and ring schedules: the (max, min) semiring, CUDA-core bound;
* threshold-closure  m = 65,536 x S = 32 thresholds, a boolean product;
  S splits over ``pod`` on the multi-pod mesh;
* bisection ladder   log2(S) + 1 = 6 effective thresholds.

What each record holds, against the reference's:

* ``kind``, ``m``, ``S``, ``multi_pod``, ``schedule``, ``dtype``,
  ``n_devices``, ``flops_analytic`` and ``hbm_bytes`` are the reference's
  formulas, equal to its records.
* ``collective_executed`` (``bytes``, ``counts``, ``total_bytes`` per
  collective kind, per device and round) is counted where the reference
  parses its compiled HLO.  For maxmin it comes from the reads of
  ``core/distributed.py::sharded_maxmin_round`` itself, the round the
  card runs (its ``on_read`` hook, walked on ``meta`` tensors so no
  memory is touched).  The boolean cells run whole slabs on the card, so
  their count is the closed form of the reference's ``round_body``: every
  device all-gathers its row panel R[p, i, :] over ``model`` and its
  column panel R[p, :, j] over ``data``.  A panel counts whole (the
  block's own part included) at 4 bytes a value: float32 for maxmin, and
  for the boolean cells float32 too, because the reference's compiled
  round converts a bfloat16 block to float32 before it gathers it, so
  its executed panels are 4 bytes a value in either dtype.
* ``lower_s``, ``compile_s`` and ``hlo_flops_per_dev`` are kept as keys
  with value ``None``: the port runs eagerly, so nothing is lowered or
  compiled, and there is no HLO to read a cost analysis from.
* ``t_compute_s``, ``t_memory_s``, ``t_collective_s``, ``dominant`` and
  ``mfu_bound`` use the reference's formulas at H100 rates
  (``benchmarks/roofline.py``; the reference's are a TPU v5e's).  The
  maxmin cells run on the CUDA cores (``maxmin_matmul``), priced at the
  int32 min/max rate; the boolean cells run their 0/1 operands in bf16
  on the tensor cores (``threshold_step``) whatever the cell's dtype,
  and are priced at the bf16 rate (``rate_of`` says which).  The
  collective term is an estimate at ``INTER_NODE_BYTES_PER_S`` (a 16-wide
  axis spans two nodes of 8 cards), not a measurement: one card has no
  link to time.

With ``run=True`` (the default) each distinct device computation runs
once on ``device`` at the cell's m, on the line graph W of a seeded
``random_hypergraph`` of walmart-trips' shape (89,000 vertices, sizes
2-8, seed 6; m cut from 70,000 to the cell's m, n scaled with m below
65,536), formed by the ``overlap`` kernel from an incidence built on the
device and kept in float32.  Four computations:

* maxmin, allgather — ``sharded_maxmin_round`` on the 16 x 16 logical
  grid with ``use_kernels=True``: 256 float32 ``maxmin_matmul`` launches
  of ``[m/16, m] x [m, m/16]``;
* maxmin, ring — the same round on the ring schedule: 4,096 launches of
  ``[m/16]^3``;
* threshold — ``threshold_step`` on ``[1, m, m]`` bf16, one threshold
  slice at a time, S slices (t = 1 .. S);
* bisection — the same for the ladder t = 1, 2, 4, .., S (S_eff slices).

The cells that run the same computation (single- and multi-pod, float32
and bf16 threshold cells) share one run; ``run_of`` names the tag that
made it.  Each run adds ``run_s`` (CUDA events, synchronised; ``None``
off the card; the boolean runs also give each slice's ``slice_s``), ``run_bound_s`` (``max(ops / rate, bytes / HBM)`` for
one card, at the record's rate; every input read once, every output
written once), ``peak_bytes`` (``torch.cuda.max_memory_allocated`` over
the run; ``None`` off the card), the kernel ``launches`` it made, and
``max_abs_err``: 64 seeded rows x 64 seeded columns of the output held
to the plain version on the same W (``max(W, maxmin_matmul_ref(W[rows],
W[:, cols]))``; ``R[rows] @ R[:, cols] > 0`` in float32), where any
mismatch raises.  On the CPU (``device="cpu"``) the kernels' wrappers run
their plain versions, so a small m checks the round itself.

  python -m repro_torch.launch.closure_dryrun --out build/dryrun_core
  python -m repro_torch.launch.closure_dryrun --m 256 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..benchmarks.roofline import (BF16_TENSOR_OPS_PER_S, HBM_BYTES_PER_S,
                                   INTER_NODE_BYTES_PER_S, minmax_rate)
from ..core.distributed import sharded_maxmin_round
from ..core.hypergraph import Hypergraph, random_hypergraph
from ..core.mesh import LogicalMesh
from ..device import DeviceLike, resolve_device
from ..kernels import maxmin_matmul as _mm
from ..kernels import overlap as _ov
from ..kernels import threshold_closure as _tc
from .mesh import make_production_mesh

__all__ = ["CELLS", "COLLECTIVE_KINDS", "cell_tag", "thresholds_of",
           "dryrun_graph_params", "incidence", "dryrun_line_graph",
           "maxmin_round_reads",
           "threshold_round_reads", "maxmin_round", "threshold_slice",
           "ClosureRuns", "lower_closure_cell", "main"]

# (kind, multi_pod, schedule, dtype), in the reference's order
CELLS: Tuple[Tuple[str, bool, str, str], ...] = (
    ("maxmin", False, "allgather", "float32"),
    ("maxmin", False, "ring", "float32"),
    ("threshold", False, "allgather", "float32"),
    ("threshold", True, "allgather", "float32"),
    ("threshold", False, "allgather", "bfloat16"),
    ("bisection", False, "allgather", "float32"),
    ("bisection", False, "allgather", "bfloat16"),
    ("bisection", True, "allgather", "bfloat16"),
)

# the reference's collective kinds (``launch/hlo_analysis.py``), in order
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
_PANEL_BYTES = 4                 # bytes a panel value moves (module doc)
_AXES = ("data", "model")
# walmart-trips (89,000 / 70,000, sizes 2-8, seed 6) at the production m
_PRODUCTION_M = 65_536
_GRAPH = dict(n=89_000, min_size=2, max_size=8, seed=6)
_SAMPLE = 64                     # rows and columns held to the plain version
_SAMPLE_SEED = 0


def cell_tag(kind: str, multi_pod: bool, schedule: str, dtype: str) -> str:
    """The record's file name without ``.json``, as the reference's."""
    return f"{kind}__{'mp' if multi_pod else 'sp'}__{schedule}__{dtype}"


def _s_eff(kind: str, s_thresholds: int) -> int:
    return (int(np.ceil(np.log2(s_thresholds))) + 1 if kind == "bisection"
            else s_thresholds)


def thresholds_of(kind: str, s_thresholds: int) -> List[int]:
    """The thresholds a boolean cell runs: 1 .. S for ``threshold``; the
    bisection ladder 1, 2, 4, .., S (S_eff of them) for ``bisection``."""
    if kind == "threshold":
        return list(range(1, s_thresholds + 1))
    return [min(2 ** k, s_thresholds)
            for k in range(_s_eff(kind, s_thresholds))]


def dryrun_graph_params(m: int) -> Dict[str, int]:
    """``random_hypergraph`` arguments of the dry-run's data at ``m``:
    walmart-trips' shape with m cut to ``m`` (n kept at 89,000 from
    65,536 up, scaled with m below)."""
    n = _GRAPH["n"] if m >= _PRODUCTION_M else max(
        2, _GRAPH["n"] * m // _PRODUCTION_M)
    return dict(_GRAPH, n=n, m=m)


def incidence(h: Hypergraph, device: torch.device) -> torch.Tensor:
    """The 0/1 incidence B [m, n] in bf16 (exact for 0/1), built on
    ``device`` from the CSR arrays: nothing dense crosses from the host."""
    sizes = torch.from_numpy(np.diff(h.e_ptr)).to(device)
    rows = torch.repeat_interleave(
        torch.arange(h.m, device=device), sizes)
    cols = torch.from_numpy(h.e_idx).to(device)
    b = torch.zeros((h.m, h.n), dtype=torch.bfloat16, device=device)
    b[rows, cols] = 1
    return b


def dryrun_line_graph(m: int, *, device: DeviceLike = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """W = B·Bᵀ [m, m] float32 on ``device`` through the ``overlap``
    wrapper (the kernel on the card), and a description of the data."""
    dev = resolve_device(device)
    params = dryrun_graph_params(m)
    h = random_hypergraph(**params)
    b = incidence(h, dev)
    w, seconds = _timed(lambda: _ov.overlap(b), dev)
    del b
    data = dict(params, nnz=int(h.e_idx.size),
                source="walmart-trips (89,000 vertices / 70,000 "
                       "hyperedges, sizes 2-8), seeded random_hypergraph",
                overlap_s=seconds)
    reduced = [f"m: 70,000 hyperedges cut to {m:,}"]
    if params["n"] != _GRAPH["n"]:
        reduced.append(f"n: 89,000 vertices scaled to {params['n']:,}")
    data["reduced"] = reduced
    return w, data


def _per_device(reads: List[Tuple[str, int]], blocks: int) -> Dict:
    """Per-device collective bytes and counts from every block's reads
    (each block reads alike on these schedules)."""
    nbytes = {k: 0 for k in COLLECTIVE_KINDS}
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, size in reads:
        nbytes[kind] += size
        counts[kind] += 1
    for kind in COLLECTIVE_KINDS:
        if nbytes[kind] % blocks or counts[kind] % blocks:
            raise AssertionError(f"{kind}: blocks read unevenly")
        nbytes[kind] //= blocks
        counts[kind] //= blocks
    return {"bytes": nbytes, "counts": counts,
            "total_bytes": int(sum(nbytes.values()))}


def _meta_mesh(mesh: LogicalMesh) -> LogicalMesh:
    return LogicalMesh(mesh.dims, mesh.axis_names, torch.device("meta"))


def _meta_contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.new_empty(a.shape[:-1] + b.shape[-1:])


def maxmin_round_reads(m: int, mesh: LogicalMesh,
                       schedule: str = "allgather") -> Dict:
    """``collective_executed`` of one maxmin round: the panels each block
    of ``sharded_maxmin_round`` reads, walked on ``meta`` tensors."""
    reads: List[Tuple[str, int]] = []
    round_fn = sharded_maxmin_round(
        _meta_mesh(mesh), schedule=schedule, axes=_AXES,
        on_read=lambda kind, p: reads.append(
            (kind, p.numel() * _PANEL_BYTES)),
        contract=_meta_contract)
    round_fn(torch.empty((m, m), dtype=torch.float32, device="meta"))
    return _per_device(reads, mesh.shape[_AXES[0]] * mesh.shape[_AXES[1]])


def threshold_round_reads(m: int, s_eff: int, mesh: LogicalMesh,
                          multi_pod: bool) -> Dict:
    """``collective_executed`` of one boolean round over ``s_eff``
    thresholds, in closed form (module docstring): each device gathers a
    row panel of (s_eff / pods) x (m / data) x m values and a column
    panel of (s_eff / pods) x m x (m / model)."""
    n_pod = mesh.shape["pod"] if multi_pod else 1
    s = s_eff // n_pod
    row = s * (m // mesh.shape[_AXES[0]]) * m
    col = s * m * (m // mesh.shape[_AXES[1]])
    return _per_device([("all-gather", row * _PANEL_BYTES),
                        ("all-gather", col * _PANEL_BYTES)], 1)


def _timed(fn: Callable, device: torch.device):
    """(fn(), seconds on the card by CUDA events, synchronised), or
    (fn(), None) off the card: a host clock is no device time."""
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def maxmin_round(w: torch.Tensor, schedule: str = "allgather",
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """max(W, W∘W) by ``sharded_maxmin_round`` on the 16 x 16 production
    grid of ``w``'s device, one ``maxmin_matmul`` call per contraction
    (the kernel on the card, its plain version on the CPU)."""
    mesh = make_production_mesh(device=w.device)
    round_fn = sharded_maxmin_round(mesh, schedule=schedule, axes=_AXES,
                                    use_kernels=True)
    return round_fn(w, out=out)


def threshold_slice(w: torch.Tensor, t: float) -> torch.Tensor:
    """The one-threshold operand R = [W >= t] with self-loops, [1, m, m]
    bf16 (exact for 0/1), the input of one ``threshold_step`` launch."""
    return _tc.threshold_adjacency(
        w, torch.tensor([t], dtype=torch.float32), dtype=torch.bfloat16)


def _sample(m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(_SAMPLE_SEED)
    k = min(_SAMPLE, m)
    rows = np.sort(rng.choice(m, k, replace=False))
    cols = np.sort(rng.choice(m, k, replace=False))
    return torch.from_numpy(rows), torch.from_numpy(cols)


def _held(tag: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0
    if err != 0.0:
        raise AssertionError(f"{tag}: sampled entries differ from the "
                             f"plain version (max abs err {err})")
    return err


def _launch_counts() -> Dict[str, int]:
    return {"maxmin_matmul": _mm.LAUNCHES, "overlap": _ov.LAUNCHES,
            "threshold_step": _tc.LAUNCHES}


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launch_counts().items()
            if v != before[k]}


class ClosureRuns:
    """The dry-run's device side: W of the seeded data on one device, made
    once, and each distinct computation's round run once and shared by
    the cells that price it (``run_of``).  ``close()`` frees W."""

    def __init__(self, m: int, *, device: DeviceLike = None):
        self.m = int(m)
        self.device = resolve_device(device)
        self._w: Optional[torch.Tensor] = None
        self.data: Optional[Dict] = None
        self._done: Dict[Tuple, Dict] = {}

    def line_graph(self) -> torch.Tensor:
        if self._w is None:
            before = _launch_counts()
            self._w, self.data = dryrun_line_graph(self.m,
                                                   device=self.device)
            self.data["launches"] = _launches_since(before)
        return self._w

    def close(self) -> None:
        self._w = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def run(self, key: Tuple, tag: str) -> Dict:
        """The run of computation ``key`` (``("maxmin", schedule)`` or
        ``("threshold", thresholds)``), made on first use under ``tag``."""
        if key not in self._done:
            w = self.line_graph()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            before = _launch_counts()
            if key[0] == "maxmin":
                res = self._maxmin(w, key[1], tag)
            else:
                res = self._threshold(w, key[1], tag)
            res["launches"] = _launches_since(before)
            res["peak_bytes"] = (
                int(torch.cuda.max_memory_allocated(self.device))
                if self.device.type == "cuda" else None)
            res["run_of"] = tag
            res["data"] = self.data
            self._done[key] = res
        return dict(self._done[key])

    def _maxmin(self, w: torch.Tensor, schedule: str, tag: str) -> Dict:
        out = torch.empty_like(w)
        _, seconds = _timed(lambda: maxmin_round(w, schedule, out=out),
                            self.device)
        rows, cols = (x.to(self.device) for x in _sample(self.m))
        w_rows = w[rows]
        want = torch.maximum(w_rows[:, cols], _mm.maxmin_matmul_ref(
            w_rows, w[:, cols].contiguous(), block=128))
        err = _held(tag, out[rows][:, cols], want)
        del out
        m = self.m
        ops, nbytes = 2.0 * m ** 3, 2 * 4 * m * m
        return dict(run_s=seconds, run_bound_s=max(
            ops / minmax_rate(), nbytes / HBM_BYTES_PER_S),
            max_abs_err=err, sample=[int(rows.numel()), int(cols.numel())])

    def _threshold(self, w: torch.Tensor, thresholds: Sequence[int],
                   tag: str) -> Dict:
        rows, cols = (x.to(self.device) for x in _sample(self.m))
        times, err = [], 0.0
        for t in thresholds:
            r = threshold_slice(w, float(t))
            out, seconds = _timed(lambda: _tc.threshold_step(r),
                                  self.device)
            times.append(seconds)
            want = (r[0][rows].float() @ r[0][:, cols].float() > 0)
            err = max(err, _held(f"{tag} t={t}", out[0][rows][:, cols],
                                 want))
            del r, out
        m, s = self.m, len(thresholds)
        ops, nbytes = 2.0 * s * m ** 3, 2 * 2 * s * m * m
        return dict(run_s=None if None in times else sum(times),
                    slice_s=times,
                    run_bound_s=max(ops / BF16_TENSOR_OPS_PER_S,
                                    nbytes / HBM_BYTES_PER_S),
                    max_abs_err=err,
                    sample=[int(rows.numel()), int(cols.numel())])


def lower_closure_cell(kind: str, m: int = 65536, s_thresholds: int = 32,
                       *, multi_pod: bool = False,
                       schedule: str = "allgather", dtype: str = "float32",
                       device: DeviceLike = None, run: bool = True,
                       runs: Optional[ClosureRuns] = None) -> dict:
    """One cell's record (module docstring): the reference's analytic
    fields, its collective count from the round's block reads, H100
    pricing, and with ``run=True`` the round run on ``device`` (through
    ``runs``, shared between cells, else a ``ClosureRuns`` of this cell
    alone)."""
    if kind not in ("maxmin", "threshold", "bisection"):
        raise ValueError(f"unknown closure cell kind {kind!r}")
    if schedule not in ("allgather", "ring"):
        raise ValueError(f"unknown schedule {schedule!r}")
    dev = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    n_dev = int(mesh.devices.size)
    if m % 16:
        raise ValueError(f"m={m} does not split over the 16 x 16 grid")
    rec = dict(kind=kind, m=m, S=s_thresholds, multi_pod=multi_pod,
               schedule=schedule, dtype=dtype, n_devices=n_dev)
    dbytes = _DTYPE_BYTES[dtype]
    if kind == "maxmin":
        # one round of maxmin: 2·m³ compare/select ops on the CUDA cores
        flops = 2.0 * m ** 3
        hbm = 3 * m * m * dbytes
        coll = maxmin_round_reads(m, mesh, schedule)
        peak = minmax_rate()
        rate_of = ("float32 min/max on the CUDA cores (maxmin_matmul), "
                   "priced at the int32 min/max rate")
    else:
        s_eff = _s_eff(kind, s_thresholds)
        flops = 2.0 * s_eff * m ** 3          # tensor-core MACs
        hbm = 3 * s_eff * m * m * dbytes
        coll = threshold_round_reads(m, s_eff, mesh, multi_pod)
        peak = BF16_TENSOR_OPS_PER_S
        rate_of = ("bf16 tensor cores (threshold_step): the 0/1 operands "
                   "run in bf16 whatever the cell's dtype")
    t_comp = flops / (n_dev * peak)
    t_mem = hbm / (n_dev * HBM_BYTES_PER_S)
    t_coll = coll["total_bytes"] / INTER_NODE_BYTES_PER_S
    terms = dict(compute=t_comp, memory=t_mem, collective=t_coll)
    # nothing is lowered or compiled: the port runs eagerly
    rec.update(status="ok", lower_s=None, compile_s=None,
               flops_analytic=flops, hbm_bytes=hbm, hlo_flops_per_dev=None,
               collective_executed=coll,
               t_compute_s=t_comp, t_memory_s=t_mem, t_collective_s=t_coll,
               dominant=max(terms, key=terms.get),
               mfu_bound=(t_comp / max(terms.values())) if kind != "maxmin"
               else 0.0,
               rate_ops_per_s=peak, rate_of=rate_of,
               link_bytes_per_s=INTER_NODE_BYTES_PER_S,
               device=str(dev))
    if run:
        own = runs is None
        if own:
            runs = ClosureRuns(m, device=dev)
        try:
            key = (("maxmin", schedule) if kind == "maxmin" else
                   ("threshold", tuple(thresholds_of(kind, s_thresholds))))
            rec.update(runs.run(key, cell_tag(kind, multi_pod, schedule,
                                              dtype)))
        finally:
            if own:
                runs.close()
    return rec


def _line(tag: str, rec: dict) -> str:
    if rec["status"] != "ok":
        return f"[error] {tag}: {rec['error']}"
    text = (f"[ok   ] {tag:34s} comp={rec['t_compute_s']:.4f}s "
            f"mem={rec['t_memory_s']:.4f}s "
            f"coll={rec['t_collective_s']:.4f}s "
            f"dominant={rec['dominant']}")
    if "run_of" in rec:
        if rec["run_s"] is None:          # off the card: no device time
            text += " run=not-measured"
        else:
            text += (f" run={rec['run_s']:.4f}s "
                     f"ratio={rec['run_s'] / rec['run_bound_s']:.4f}"
                     f" peak={rec['peak_bytes']}")
        text += (f" bound={rec['run_bound_s']:.4f}s "
                 f"err={rec['max_abs_err']} run_of={rec['run_of']}")
    return text


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Writes one record per cell into ``--out`` and returns them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun_core")
    ap.add_argument("--m", type=int, default=65536)
    ap.add_argument("--S", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--no-run", action="store_true",
                    help="the analytic fields only")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    run = not args.no_run
    runs = ClosureRuns(args.m, device=args.device) if run else None
    records = []
    try:
        for kind, mp, sched, dtype in CELLS:
            tag = cell_tag(kind, mp, sched, dtype)
            try:
                rec = lower_closure_cell(kind, args.m, args.S, multi_pod=mp,
                                         schedule=sched, dtype=dtype,
                                         device=args.device, run=run,
                                         runs=runs)
            except Exception as e:  # a cell's failure is its record
                rec = dict(kind=kind, multi_pod=mp, schedule=sched,
                           dtype=dtype, status="error",
                           error=f"{type(e).__name__}: {e}",
                           tb=traceback.format_exc()[-1500:])
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            print(_line(tag, rec), flush=True)
            records.append(rec)
    finally:
        if runs is not None:
            runs.close()
    return records


if __name__ == "__main__":
    sys.exit(0 if all(r["status"] == "ok" for r in main()) else 1)
