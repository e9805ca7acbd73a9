"""Plain PyTorch versions of the ported kernels, under the reference's
module layout (``kernels.ref``).  Each lives beside its kernel's wrapper;
this module re-exports them."""
from .label_join import label_join_ref
from .maxmin_matmul import maxmin_matmul_ref
from .overlap import overlap_ref
from .threshold_closure import threshold_step_ref

__all__ = ["maxmin_matmul_ref", "overlap_ref", "threshold_step_ref",
           "label_join_ref"]
