"""Plain PyTorch versions of the ported kernels, under the reference's
module layout (``kernels.ref``).  Each lives beside its kernel's wrapper;
this module re-exports them."""
from .label_join import label_join_ref

__all__ = ["label_join_ref"]
