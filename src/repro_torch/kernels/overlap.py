"""Hyperedge-overlap (line-graph) matrix: plain version, CUDA wrapper.

    W = B·Bᵀ,  W[i, j] = |e_i ∩ e_j|,  diagonal |e_i|

over the 0/1 incidence ``B [m, n]``.  Counterpart of
``repro/kernels/overlap.py`` (the Pallas kernel) and of ``overlap_ref`` in
``repro/kernels/ref.py``.

* ``overlap_ref`` — the plain PyTorch version, ``b @ b.T`` in the input's
  dtype with an optional diagonal override, as the reference has it.
* ``overlap`` — the wrapper: float32 or bfloat16 in, float32 out, as the
  Pallas kernel.  CPU tensors go to the plain version (in float32); CUDA
  tensors launch the hand-written kernel ``csrc/overlap.cu`` (bf16 tensor
  cores fed by TMA, B's rows read for both operands so Bᵀ is never formed)
  or raise.  There is no fallback from the kernel to anything else.
* ``pad_columns`` — the kernel's operand (``build.tma_operand``): B as
  bf16 (exact for 0/1) with its columns padded by zeros to a multiple of
  8, because TMA needs 16-byte rows; zero columns add nothing to B·Bᵀ.
* ``overlap_rows(a, b)`` / ``overlap_rows_ref`` — the rectangular
  ``W = A·Bᵀ`` of two 0/1 operands ``A [ma, n]`` and ``B [mb, n]``, float32
  ``[ma, mb]``: the rows of the line graph one rank of a ``ProcessMesh``
  owns (``core/hypergraph.py``'s rank overlap route).  It replaces no TPU
  kernel: the reference's mesh route is a sharded ``x @ x.T`` in XLA
  (``src/repro/core/hypergraph.py:285-301``).  The port's logical route
  runs the ``overlap`` kernel, so its rank route runs a kernel too, the
  same tensor-core product with A and B encoded apart
  (``overlap_rows_bf16_launch`` in ``csrc/overlap.cu``).  Its plain
  version is ``a @ b.T``.
* ``LAUNCHES`` / ``ROWS_LAUNCHES`` — incremented once per launch of
  ``overlap`` / ``overlap_rows`` and nowhere else; ``PADDED`` — the
  ``overlap`` launches that needed the column pad.

Counts are sums of 0/1 products in float32: exact while below 2^24.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import launch, tma_operand

__all__ = ["overlap", "overlap_ref", "overlap_rows", "overlap_rows_ref",
           "pad_columns", "LAUNCHES", "ROWS_LAUNCHES", "PADDED"]

# kernel launches made by ``overlap`` in this process
LAUNCHES = 0
# kernel launches made by ``overlap_rows`` in this process
ROWS_LAUNCHES = 0
# of those, launches whose n needed the zero columns
PADDED = 0

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
_ROWS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3


def overlap_ref(b_inc: torch.Tensor,
                sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Line graph W = B·Bᵀ from a 0/1 incidence matrix [m, n]; the diagonal
    is |e_i| either way (row self-product), optionally overridden by
    ``sizes`` (used when B is a padded block of a larger incidence)."""
    w = b_inc @ b_inc.T
    if sizes is not None:
        w.diagonal().copy_(torch.as_tensor(sizes).to(w.device, w.dtype))
    return w


def pad_columns(b_inc: torch.Tensor) -> torch.Tensor:
    """``b_inc`` [m, n] as bf16 [m, np] with ``np`` the next multiple of 8,
    zeros past ``n``; no copy where it is bf16 already, aligned, and ``n``
    a multiple of 8."""
    return tma_operand(b_inc, dims=1)


def overlap_rows_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """W = A·Bᵀ of two 0/1 operands [ma, n] and [mb, n], in their dtype."""
    return a @ b.T


def _check_operand(b_inc, what: str = "overlap: b_inc") -> None:
    if not isinstance(b_inc, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got "
                        f"{type(b_inc).__name__}")
    if b_inc.dtype not in _DTYPES:
        raise TypeError(f"{what} must be float32 or bfloat16, got "
                        f"{b_inc.dtype}")
    if b_inc.dim() != 2:
        raise ValueError(f"{what} must be 2-D, got shape "
                         f"{tuple(b_inc.shape)}")
    if not b_inc.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def overlap(b_inc: torch.Tensor) -> torch.Tensor:
    """b_inc [m, n] 0/1, float32 or bfloat16, contiguous.  Returns W [m, m]
    float32 on its device; m or n of 0 gives zeros [m, m] with no launch.
    Anything else raises."""
    global LAUNCHES, PADDED
    _check_operand(b_inc)
    if b_inc.device.type == "cpu":
        return overlap_ref(b_inc.to(torch.float32))
    if b_inc.device.type != "cuda":
        raise ValueError(f"overlap: unsupported device {b_inc.device}")
    m, n = b_inc.shape
    if m == 0 or n == 0:               # a zero-size grid is a launch error
        return torch.zeros((m, m), dtype=torch.float32, device=b_inc.device)
    operand = pad_columns(b_inc)
    out = torch.empty((m, m), dtype=torch.float32, device=b_inc.device)
    launch("overlap", "overlap_bf16_launch", _ARGTYPES, b_inc.device,
           (operand.data_ptr(), out.data_ptr(), m, operand.shape[1]),
           f"overlap {b_inc.dtype} m={m}, n={n}")
    LAUNCHES += 1
    PADDED += operand.shape[1] != n
    return out


def overlap_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` [ma, n] and ``b`` [mb, n] 0/1, float32 or bfloat16,
    contiguous, on one device.  Returns W = A·Bᵀ [ma, mb] float32 there;
    an empty dimension gives zeros with no launch.  CPU operands go to
    ``overlap_rows_ref`` in float32; CUDA operands launch the kernel
    (both padded by ``pad_columns``) or raise."""
    global ROWS_LAUNCHES
    _check_operand(a, "overlap_rows: a")
    _check_operand(b, "overlap_rows: b")
    if a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError(f"overlap_rows: a {tuple(a.shape)} on {a.device} "
                         f"and b {tuple(b.shape)} on {b.device} differ in "
                         f"width or device")
    if a.device.type == "cpu":
        return overlap_rows_ref(a.to(torch.float32), b.to(torch.float32))
    if a.device.type != "cuda":
        raise ValueError(f"overlap_rows: unsupported device {a.device}")
    (ma, n), mb = a.shape, b.shape[0]
    if ma == 0 or mb == 0 or n == 0:   # a zero-size grid is a launch error
        return torch.zeros((ma, mb), dtype=torch.float32, device=a.device)
    op_a, op_b = pad_columns(a), pad_columns(b)
    out = torch.empty((ma, mb), dtype=torch.float32, device=a.device)
    launch("overlap", "overlap_rows_bf16_launch", _ROWS_ARGTYPES, a.device,
           (op_a.data_ptr(), op_b.data_ptr(), out.data_ptr(), ma, mb,
            op_a.shape[1]),
           f"overlap_rows {a.dtype} ma={ma}, mb={mb}, n={n}")
    ROWS_LAUNCHES += 1
    return out
