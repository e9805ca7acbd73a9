"""Registry of every hand-written kernel in the package.

Single source of truth for "what kernels exist and what validates them";
it grows by one entry per ported kernel and stays a subset of the
reference's ``KERNEL_REGISTRY`` until the port is complete (asserted in
``tests/test_torch_label_join.py``, which also checks that ``PERF.md``
names the kernels still to be ported).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .label_join import label_join, label_join_ref

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
        consumer="KernelSnapshot.mr — serving-path batched merge-join",
        source="kernels/csrc/label_join.cu"),
}
