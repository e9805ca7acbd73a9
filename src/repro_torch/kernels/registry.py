"""Registry of every hand-written kernel in the package.

Single source of truth for "what kernels exist and what validates them".
It holds one entry per kernel of the reference's ``KERNEL_REGISTRY``, all
four ported (asserted in ``tests/test_torch_label_join.py``, which also
checks that ``PERF.md`` has a "ported in PR" row for each).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .label_join import label_join, label_join_ref
from .maxmin_matmul import maxmin_matmul, maxmin_matmul_ref
from .overlap import overlap, overlap_ref
from .threshold_closure import threshold_step, threshold_step_ref

__all__ = ["KERNEL_REGISTRY", "KernelSpec"]


@dataclass(frozen=True)
class KernelSpec:
    kernel: Callable          # the wrapper that launches the CUDA kernel
    reference: Callable       # its plain PyTorch version
    unit: str                 # Hopper unit the kernel runs on
    consumer: str             # production call-site served by the kernel
    source: str               # kernel source, relative to the package


KERNEL_REGISTRY: dict[str, KernelSpec] = {
    "label_join": KernelSpec(
        kernel=label_join, reference=label_join_ref, unit="CUDA cores",
        consumer="KernelSnapshot.mr — serving-path batched merge-join, "
                 "through the gather entry point label_join_gather",
        source="kernels/csrc/label_join.cu"),
    "maxmin_matmul": KernelSpec(
        kernel=maxmin_matmul, reference=maxmin_matmul_ref, unit="CUDA cores",
        consumer="maxmin_closure — closure backend W* by (max, min) squaring",
        source="kernels/csrc/maxmin_matmul.cu"),
    "overlap": KernelSpec(
        kernel=overlap, reference=overlap_ref, unit="tensor cores",
        consumer="device_line_graph — line graph W = B·Bᵀ of the closure "
                 "backend",
        source="kernels/csrc/overlap.cu"),
    "threshold_step": KernelSpec(
        kernel=threshold_step, reference=threshold_step_ref,
        unit="tensor cores",
        consumer="threshold_closure_mr / threshold_mr_kernel boolean-closure "
                 "squaring round",
        source="kernels/csrc/threshold_step.cu"),
}
