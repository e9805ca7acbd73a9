"""The H100's peak rates and the least time each kernel of the port could
take: one source for ``chip_smoke.py`` and ``kernels_bench``.

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

Counterpart of the reference's ``benchmarks/roofline.py``, whose
constants are a TPU v5e's.  Its other half (the LM cell model over
``repro.configs`` and ``launch/shapes``) reads modules the port has not
got; it is not ported here.
"""
from __future__ import annotations

import math
import subprocess
from typing import Dict, Optional, Tuple

import torch

__all__ = ["HBM_BYTES_PER_S", "INT8_TENSOR_OPS_PER_S",
           "BF16_TENSOR_OPS_PER_S", "INT32_MINMAX_PER_CLOCK_PER_SM", "RATES",
           "int32_minmax_rate", "fill_rates", "bound", "label_join_bound",
           "label_join_gather_bound", "maxmin_bound", "overlap_bound",
           "threshold_bound", "bf16_ceiling_ms", "sweep_bound_bytes"]

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
INT8_TENSOR_OPS_PER_S = 1.979e15
BF16_TENSOR_OPS_PER_S = 0.989e15
INT32_MINMAX_PER_CLOCK_PER_SM = 64
RATES: Dict[str, float] = {}   # {"int32_minmax": ops/s}, see fill_rates


def int32_minmax_rate(sms: int, max_sm_clock_mhz: float) -> float:
    """32-bit min/max results per second of a card with ``sms`` SMs at
    ``max_sm_clock_mhz``."""
    return sms * INT32_MINMAX_PER_CLOCK_PER_SM * max_sm_clock_mhz * 1e6


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
