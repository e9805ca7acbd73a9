"""Drivers over the hand-written kernels — counterpart of
``repro/kernels/ops.py``.

``maxmin_matmul``, ``overlap``, ``threshold_step`` and ``label_join`` are
the kernels' wrappers, which choose by the operands' device: the plain
PyTorch version for CPU tensors, the CUDA kernel (or an error) for CUDA
tensors.  The closure drivers below run their rounds through them.

What the reference has and this module does not:

* ``REPRO_FORCE_REF`` (the switch that bypasses Pallas for the pure-jnp
  versions).  A switch that sends CUDA tensors to the plain versions would
  be the silent fallback this package forbids; the plain versions stay
  callable by name (``kernels.ref``).
* ``use_interpret`` / ``interpret_available``: a CUDA kernel has no
  interpreter.  ``repro_torch.device.gpu_probe`` says whether the host can
  build and run the kernels.
* the block-size keywords (``bm``, ``bn``, ``bk``, ``bq``): each CUDA
  kernel fixes its own tiles.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .label_join import label_join
from .maxmin_matmul import maxmin_matmul
from .overlap import overlap
from .threshold_closure import (largest_threshold, threshold_adjacency,
                                threshold_step)

__all__ = ["maxmin_matmul", "overlap", "threshold_step", "label_join",
           "maxmin_closure_kernel", "threshold_mr_kernel", "default_rounds"]


def default_rounds(m: int) -> int:
    """Squaring rounds that close any ``m``-node graph: ⌈log2 m⌉, at
    least 1."""
    return max(1, int(np.ceil(np.log2(max(m, 2)))))


def maxmin_closure_kernel(w: torch.Tensor, *,
                          rounds: Optional[int] = None) -> torch.Tensor:
    """Bottleneck closure via the (max, min) kernel."""
    n_rounds = rounds if rounds is not None else default_rounds(w.shape[0])
    r = w
    for _ in range(n_rounds):
        r = torch.maximum(r, maxmin_matmul(r, r))
    return r


def threshold_mr_kernel(w: torch.Tensor, thresholds, *,
                        rounds: Optional[int] = None) -> torch.Tensor:
    """MR matrix via the fused threshold-closure kernel, in ``w``'s
    dtype.  The rounds run on a bf16 0/1 batch (exact; the kernel's
    operand type), the read-out in float32."""
    n_rounds = rounds if rounds is not None else default_rounds(w.shape[0])
    t = torch.as_tensor(np.asarray(thresholds)).to(w.device)
    r = threshold_adjacency(w, t, dtype=torch.bfloat16)
    for _ in range(n_rounds):
        r = threshold_step(r)
    mr = largest_threshold(r, t)
    mr.diagonal().copy_(w.diagonal())
    return mr.to(w.dtype)
