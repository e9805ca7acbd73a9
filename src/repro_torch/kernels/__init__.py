"""Hand-written Hopper kernels for the port's hot spots, each beside its
plain PyTorch version.  Importing this package builds nothing: a kernel is
compiled at its first launch (``build.py``).

``kernels.label_join``, ``kernels.maxmin_matmul``, ``kernels.overlap`` and
``kernels.threshold_closure`` are the modules (wrapper, plain version,
``LAUNCHES`` count); the wrappers themselves are e.g.
``kernels.label_join.label_join`` or ``kernels.ops.overlap`` and are
deliberately not re-exported here under their modules' names.
"""
from . import label_join, maxmin_matmul, ops, overlap, ref, threshold_closure
from .label_join import MAX_RANK, label_join_ref, validate_ranks
from .maxmin_matmul import maxmin_matmul_ref
from .ops import maxmin_closure_kernel, threshold_mr_kernel
from .overlap import overlap_ref
from .registry import KERNEL_REGISTRY, KernelSpec
from .threshold_closure import threshold_step_ref

__all__ = ["ref", "ops", "label_join", "maxmin_matmul", "overlap",
           "threshold_closure", "label_join_ref", "maxmin_matmul_ref",
           "overlap_ref", "threshold_step_ref", "validate_ranks", "MAX_RANK",
           "maxmin_closure_kernel", "threshold_mr_kernel",
           "KERNEL_REGISTRY", "KernelSpec"]
