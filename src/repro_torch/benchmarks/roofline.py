"""The H100's peak rates, the least time each kernel of the port could
take (one source for ``chip_smoke.py`` and ``kernels_bench``), and the
LM roofline at those rates.

A bound is the larger of two times: the bytes a function must move (each
input read once, each output written once) over the card's memory rate,
and the operations it does on those inputs over the card's peak rate for
their type.  Where the work depends on the data (a join whose rows are
ragged, a sweep that stops at its fixpoint), the helpers count what the
given inputs need, not the most they could.

The rates (NVIDIA H100 SXM):

* ``HBM_BYTES_PER_S`` — device memory, 3.35e12 B/s (NVIDIA H100 data
  sheet);
* ``INT8_TENSOR_OPS_PER_S`` — dense int8 tensor cores, 1.979e15 ops/s
  (data sheet): the narrowest type that holds a 0/1 product exactly, so
  the least time of ``overlap`` and ``threshold_step``;
* ``BF16_TENSOR_OPS_PER_S`` — dense bf16 tensor cores, 0.989e15 ops/s
  (data sheet): the type those two kernels run in; the ceiling of their
  route (``bf16_ceiling_ms``), never their bound;
* 32-bit integer min/max (and compare): 64 results per clock per SM on
  compute capability 9.0 (CUDA C++ Programming Guide, "Arithmetic
  Instructions" throughput table), times the SM count and the maximum SM
  clock, both read from the card at run time (``fill_rates``) into
  ``RATES["int32_minmax"]``.  Float32 min/max is priced at this rate too.
  Where no card is there to read (``--device cpu`` pricing), the data
  sheet's 132 SMs at 1,980 MHz stand in (``minmax_rate``).
* ``INTER_NODE_BYTES_PER_S`` — one card's link out of its node, 50e9 B/s:
  a DGX H100 gives each GPU one 400 Gb/s NDR InfiniBand port (DGX H100
  user guide).  A logical 16-wide mesh axis spans two nodes of 8 cards,
  so a closure round's panels cross this link;
* ``NVLINK_BYTES_PER_S`` — NVLink 4 inside a node, 450e9 B/s each way of
  the data sheet's 900 GB/s; beside the other for comparison.

Counterpart of the reference's ``benchmarks/roofline.py``, whose
constants are a TPU v5e's (and of the TPU rates in the reference's
``launch/closure_dryrun.py``, which the port's dry-run takes from here).

The module has two halves.  The kernel bounds above are the port's own.
The LM half below is the reference's three-term roofline per (arch x
shape x mesh) cell, with its formulas verbatim (``_attn_flops_fwd``,
``analytic_cell_model``, ``roofline_row``, ``roofline_table``,
``format_table``, ``main``), reading ``repro_torch.configs`` and
``repro_torch.launch.shapes``, at H100 rates:

    compute term    = FLOPs_executed / (chips x PEAK_FLOPS)
    memory term     = HBM_bytes      / (chips x HBM_BW)
    collective term = coll_bytes_per_device / LINK_BW

with ``PEAK_FLOPS = BF16_TENSOR_OPS_PER_S`` (dense bf16),
``HBM_BW = HBM_BYTES_PER_S`` and ``LINK_BW = INTER_NODE_BYTES_PER_S``
(a 16-wide mesh axis spans two nodes of 8 cards, as the closure dry-run
prices it).  FLOPs and HBM bytes are analytic, per executed step and
global; the collective bytes are the dry-run record's
(``launch/dryrun.py``: a closed form of what the specs must move, where
the reference parses its compiled HLO).  ``mfu_bound`` is
``[MODEL_FLOPS / (chips x PEAK_FLOPS)] / max(terms)``.

  python -m repro_torch.benchmarks.roofline --dir build/dryrun --mesh sp
"""
from __future__ import annotations

import glob
import json
import math
import os
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

from ..configs import get_config
from ..launch.shapes import SHAPES
from ..models.common import ArchConfig

__all__ = ["HBM_BYTES_PER_S", "INT8_TENSOR_OPS_PER_S",
           "BF16_TENSOR_OPS_PER_S", "INT32_MINMAX_PER_CLOCK_PER_SM",
           "INTER_NODE_BYTES_PER_S", "NVLINK_BYTES_PER_S", "H100_SMS",
           "H100_MAX_SM_CLOCK_MHZ", "RATES", "int32_minmax_rate",
           "minmax_rate", "fill_rates", "bound", "label_join_bound",
           "label_join_gather_bound", "maxmin_bound", "overlap_bound",
           "threshold_bound", "bf16_ceiling_ms", "sweep_bound_bytes",
           "analytic_cell_model", "roofline_row", "roofline_table",
           "format_table", "PEAK_FLOPS", "HBM_BW", "LINK_BW"]

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
INT8_TENSOR_OPS_PER_S = 1.979e15
BF16_TENSOR_OPS_PER_S = 0.989e15
INT32_MINMAX_PER_CLOCK_PER_SM = 64
H100_SMS = 132                 # H100 SXM (data sheet)
H100_MAX_SM_CLOCK_MHZ = 1980   # H100 SXM boost clock (data sheet)
INTER_NODE_BYTES_PER_S = 50e9  # 400 Gb/s NDR InfiniBand, one port a GPU
NVLINK_BYTES_PER_S = 450e9     # NVLink 4, each way (data sheet: 900 GB/s)
RATES: Dict[str, float] = {}   # {"int32_minmax": ops/s}, see fill_rates
# the LM roofline's three rates, per card (module docstring)
PEAK_FLOPS = BF16_TENSOR_OPS_PER_S
HBM_BW = HBM_BYTES_PER_S
LINK_BW = INTER_NODE_BYTES_PER_S


def int32_minmax_rate(sms: int, max_sm_clock_mhz: float) -> float:
    """32-bit min/max results per second of a card with ``sms`` SMs at
    ``max_sm_clock_mhz``."""
    return sms * INT32_MINMAX_PER_CLOCK_PER_SM * max_sm_clock_mhz * 1e6


def minmax_rate() -> float:
    """32-bit min/max results per second: the card's (``RATES``, filled by
    ``fill_rates``) where it was read, else the data sheet's H100 SXM."""
    return RATES.get("int32_minmax") or int32_minmax_rate(
        H100_SMS, H100_MAX_SM_CLOCK_MHZ)


def fill_rates(sms: Optional[int] = None,
               max_sm_clock_mhz: Optional[float] = None) -> Dict[str, float]:
    """Fills ``RATES`` from the card (``torch`` for the SM count,
    ``nvidia-smi`` for the maximum SM clock) unless both are given, and
    returns the SM count and clock it used with the rate."""
    if sms is None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
    if max_sm_clock_mhz is None:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            check=True, capture_output=True, text=True, timeout=60).stdout
        max_sm_clock_mhz = float(out.strip().splitlines()[0])
    RATES["int32_minmax"] = int32_minmax_rate(sms, max_sm_clock_mhz)
    return {"sms": sms, "max_sm_clock_mhz": max_sm_clock_mhz,
            "int32_minmax_ops_per_s": RATES["int32_minmax"]}


def bound(nbytes, ops, ops_per_s) -> Tuple[float, str]:
    """(least ms, what binds): the larger of bytes over the memory rate and
    operations over the given peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def label_join_gather_bound(svals, us, vs):
    """Least time the card could take for the gather entry point, in ms,
    and what binds it.  Bytes: the two int64 id vectors read once, the [Q]
    int32 answers written once, and each distinct snapshot row that the
    batch touches read once (4 bytes of rank and 4 of s per label slot).
    Operations as in ``label_join_bound``, on the u rows of this batch."""
    q, l = us.numel(), svals.shape[1]
    distinct = int(torch.unique(torch.cat([us, vs])).numel())
    nbytes = 16 * q + 4 * q + 8 * l * distinct
    real = int((svals > 0).sum(dim=1)[us].sum()) if q else 0
    ops = real * (math.ceil(math.log2(l + 1)) + 2) if l else 0
    out = bound(nbytes, ops, RATES["int32_minmax"])
    return out[0], out[1], {"bytes": nbytes, "distinct_rows": distinct}


def label_join_bound(su, q, l):
    """Least time the card could take for this join, in ms, and what binds
    it.  Bytes: four [Q, L] int32 operands read once, [Q] int32 written
    once.  Operations, counted from this run's data: every real u label
    (s > 0) needs a lower-bound search of the v row (ceil(log2(L + 1))
    compares) plus one min and one max."""
    nbytes = 16 * q * l + 4 * q
    real = int((su > 0).sum())
    ops = real * (math.ceil(math.log2(l + 1)) + 2) if l else 0
    return bound(nbytes, ops, RATES["int32_minmax"])


def maxmin_bound(m, k, n):
    """Least ms for a (max, min) product: A, B read once, C written once
    (4-byte values); one min and one max per (i, j, k) on the CUDA cores at
    the int32 min/max rate."""
    return bound(4 * (m * k + k * n + m * n), 2 * m * k * n,
                 RATES["int32_minmax"])


def overlap_bound(m, n, in_bytes):
    """Least ms for W = B·Bᵀ: B [m, n] read once at ``in_bytes`` a value,
    W [m, m] float32 written once; 2 operations per multiply-add at the
    int8 tensor-core rate (the narrowest type that holds a 0/1 product
    exactly)."""
    return bound(in_bytes * m * n + 4 * m * m, 2 * m * m * n,
                 INT8_TENSOR_OPS_PER_S)


def threshold_bound(s, m, value_bytes):
    """Least ms for one threshold_step round: R [S, m, m] read once and the
    result written once, ``value_bytes`` a value each; 2 operations per
    multiply-add at the int8 tensor-core rate."""
    return bound(2 * value_bytes * s * m * m, 2 * s * m ** 3,
                 INT8_TENSOR_OPS_PER_S)


def bf16_ceiling_ms(ops):
    """The same operations at the data sheet's bf16 tensor-core rate: the
    least time of the route the kernels take (computed, not measured)."""
    return ops / BF16_TENSOR_OPS_PER_S * 1e3


def sweep_bound_bytes(rec, m):
    """Bytes one frontier sweep must move at least: every round run reads
    the alive edges' ``src`` / ``dst`` / ``od`` once (12 bytes an edge) and
    the ``[m, Qc]`` uint8 frontier once in and once out."""
    q, width, nbytes = rec["queries"], rec["chunk_queries"], 0
    for i, rounds in enumerate(rec["rounds"]):
        qc = min(width, q - i * width)
        nbytes += rounds * (rec["alive_edges"] * 12 + 2 * qc * m)
    return nbytes


# ---------------------------------------------------------------------------
# the LM half: the reference's per-cell model, verbatim
# ---------------------------------------------------------------------------

def _attn_flops_fwd(cfg: ArchConfig, b: int, s: int) -> float:
    """Self-attention score+value contractions, causal (x1/2)."""
    if cfg.family == "ssm":
        # selective scan: ~6 flops per (token, d_inner, d_state) + conv
        return b * s * cfg.d_inner * cfg.ssm_state * 6.0 * cfg.n_layers
    w = min(cfg.window, s) if cfg.window else s
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if pat[i % len(pat)] == "attn")
        n_rec = cfg.n_layers - n_attn
        attn = 4 * n_attn * b * s * w * cfg.n_heads * cfg.hd * 0.5
        rec = n_rec * b * s * cfg.drnn * 12.0       # gates + scan
        return attn + rec
    layers = cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)
    causal = 0.5 if cfg.family != "encdec" else 0.75   # enc is bidirectional
    return 4 * layers * b * s * w * cfg.n_heads * cfg.hd * causal


def analytic_cell_model(cfg: ArchConfig, shape) -> Dict[str, float]:
    """Per executed step, global (all chips)."""
    n_act = cfg.n_active_params()
    n_emb_in = cfg.vocab * cfg.d_model        # input embedding (gather, ~0 flop)
    n_mat = max(n_act - n_emb_in, 1)          # matmul-visible params
    b, s = shape.global_batch, shape.seq_len
    kv_bytes_tok = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2
                    if cfg.family not in ("ssm", "hybrid") else
                    4 * cfg.d_inner * (cfg.ssm_state + cfg.d_conv)
                    if cfg.family == "ssm" else 4 * cfg.drnn * 8)

    if shape.kind == "train":
        t = b * s
        fwd = 2 * n_mat * t + _attn_flops_fwd(cfg, b, s)
        factor = 4.0 if cfg.remat else 3.0     # fwd+bwd(2x)+refwd(1x)
        flops = factor * fwd
        model_flops = 6.0 * n_mat * t
        # HBM: weights re-read per pass per microbatch (bf16) + optimizer
        # f32 m/v read+write + activation boundary traffic
        p_bytes = cfg.n_params() * 2
        passes = 3 * cfg.microbatch
        act = 12 * t * cfg.d_model * cfg.n_layers * 2
        hbm = passes * p_bytes + 16 * cfg.n_params() + act
    elif shape.kind == "prefill":
        t = b * s
        flops = 2 * n_mat * t + _attn_flops_fwd(cfg, b, s)
        model_flops = 2.0 * n_mat * t
        hbm = cfg.n_params() * 2 + 10 * t * cfg.d_model * cfg.n_layers * 2
    else:  # decode: one token against an s-long cache
        w = min(cfg.window, s) if cfg.window else s
        if cfg.family == "ssm":
            attn_read = b * 4 * cfg.d_inner * cfg.ssm_state
            attn_flops = b * cfg.d_inner * cfg.ssm_state * 6.0 * cfg.n_layers
        elif cfg.family == "hybrid":
            attn_read = b * 9 * kv_bytes_tok
            attn_flops = 4 * b * w * cfg.n_heads * cfg.hd * (cfg.n_layers // 3)
        else:
            attn_read = b * s * kv_bytes_tok
            attn_flops = 4 * cfg.n_layers * b * s * cfg.n_kv_heads * cfg.hd
        flops = 2 * n_mat * b + attn_flops
        model_flops = 2.0 * n_mat * b
        hbm = cfg.n_params() * 2 + attn_read
    return dict(flops=flops, hbm_bytes=hbm, model_flops=model_flops)


def roofline_row(rec: Dict) -> Optional[Dict]:
    """The three terms of one dry-run record at the module's rates (read
    when called), its dominant term and its MFU bound; ``None`` for a
    record that is not ``ok``."""
    if rec.get("status") != "ok":
        return None
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    chips = rec["n_devices"]
    a = analytic_cell_model(cfg, shape)
    t_compute = a["flops"] / (chips * PEAK_FLOPS)
    t_memory = a["hbm_bytes"] / (chips * HBM_BW)
    coll_dev = rec.get("collective_executed", rec["collective"])["total_bytes"]
    t_coll = coll_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_bound = max(terms.values())
    mfu_bound = (a["model_flops"] / (chips * PEAK_FLOPS)) / t_bound \
        if t_bound > 0 else 0.0
    return dict(
        arch=rec["arch"], shape=rec["shape"],
        mesh="2x16x16" if rec["multi_pod"] else "16x16", chips=chips,
        t_compute_s=t_compute, t_memory_s=t_memory, t_collective_s=t_coll,
        dominant=dominant, model_flops=a["model_flops"],
        exec_flops=a["flops"],
        useful_ratio=a["model_flops"] / a["flops"],
        mfu_bound=mfu_bound,
        hlo_flops_per_dev=rec.get("flops", 0.0),
        coll_bytes_per_dev=coll_dev,
    )


def roofline_table(records_dir: str = "results/dryrun",
                   mesh: str = "sp") -> List[Dict]:
    """``roofline_row`` of every untagged ``*__{mesh}.json`` record in
    ``records_dir`` that is ``ok``, in file-name order."""
    rows = []
    for fn in sorted(glob.glob(os.path.join(records_dir, f"*__{mesh}.json"))):
        with open(fn) as f:
            rec = json.load(f)
        row = roofline_row(rec)
        if row:
            rows.append(row)
    return rows


def format_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':<24}{'shape':<13}{'comp(s)':>10}{'mem(s)':>10}"
           f"{'coll(s)':>10}{'dominant':>11}{'useful':>8}{'MFU≤':>7}")
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        out.append(f"{r['arch']:<24}{r['shape']:<13}"
                   f"{r['t_compute_s']:>10.4f}{r['t_memory_s']:>10.4f}"
                   f"{r['t_collective_s']:>10.4f}{r['dominant']:>11}"
                   f"{r['useful_ratio']:>8.2f}{r['mfu_bound']:>7.1%}")
    return "\n".join(out)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="sp", choices=["sp", "mp"])
    args = ap.parse_args(argv)
    rows = roofline_table(args.dir, args.mesh)
    print(format_table(rows))
    out = os.path.join(args.dir, f"roofline_{args.mesh}.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
