"""Hand-written Hopper kernels for the port's hot spots, each beside its
plain PyTorch version.  Importing this package builds nothing: a kernel is
compiled at its first launch (``build.py``).

``kernels.label_join`` is the module (wrapper, plain version, ``LAUNCHES``
count); the wrapper itself is ``kernels.label_join.label_join`` and is
deliberately not re-exported here under the module's name.
"""
from . import label_join, ref
from .label_join import MAX_RANK, label_join_ref, validate_ranks
from .registry import KERNEL_REGISTRY, KernelSpec

__all__ = ["ref", "label_join", "label_join_ref", "validate_ranks",
           "MAX_RANK", "KERNEL_REGISTRY", "KernelSpec"]
