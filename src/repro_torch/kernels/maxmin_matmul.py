"""(max, min)-semiring matrix product: plain version, CUDA wrapper.

    C[i, j] = max_k min(A[i, k], B[k, j])          (non-negative operands)

— the squaring step of the bottleneck closure ``W*``.  Counterpart of
``repro/kernels/maxmin_matmul.py`` (the Pallas kernel) and of
``maxmin_matmul_ref`` in ``repro/kernels/ref.py``.

* ``maxmin_matmul_ref`` — the plain PyTorch version: an ``[m, k, n]``
  minimum broadcast and a max over ``k``, ``block`` columns of ``k`` at a
  time so the broadcast stays bounded.  It is what the CPU tests run and
  what the CUDA kernel is held against on the card.
* ``maxmin_matmul`` — the wrapper.  CPU tensors go to the plain version;
  CUDA tensors launch the hand-written kernel ``csrc/maxmin_matmul.cu``
  (register-blocked tile product on the CUDA cores, int32 or float32) or
  raise.  There is no fallback from the kernel to anything else.
* ``LAUNCHES`` — incremented once per kernel launch and nowhere else.

0 is the semiring's zero on the non-negative domain (it annihilates under
min and is the identity of max), so an empty contraction (``k == 0``)
answers zeros, and ``m``, ``n`` or ``k`` of 0 return zeros before any
launch.
"""
from __future__ import annotations

import ctypes

import torch

from .build import launch

__all__ = ["maxmin_matmul", "maxmin_matmul_ref", "LAUNCHES"]

# kernel launches made by ``maxmin_matmul`` in this process
LAUNCHES = 0

_SYMBOLS = {torch.int32: "maxmin_matmul_i32_launch",
            torch.float32: "maxmin_matmul_f32_launch"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3


def maxmin_matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
                      block: int = 512) -> torch.Tensor:
    """C[i,j] = max_k min(A[i,k], B[k,j]).  Non-negative domain, so the
    empty-k reduction identity is 0.  ``k`` is walked ``block`` columns at
    a time (one ``[m, block, n]`` broadcast each); for ``k <= block`` this
    is the reference's single broadcast."""
    m, k = a.shape
    n = b.shape[1]
    if k == 0:
        return torch.zeros((m, n), dtype=a.dtype, device=a.device)
    if k <= block:
        return torch.minimum(a[:, :, None], b[None, :, :]).amax(dim=1)
    out = torch.zeros((m, n), dtype=a.dtype, device=a.device)
    for k0 in range(0, k, block):
        part = torch.minimum(a[:, k0:k0 + block, None],
                             b[None, k0:k0 + block, :]).amax(dim=1)
        torch.maximum(out, part, out=out)
    return out


def _check_operands(a, b) -> None:
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"maxmin_matmul: {name} must be a torch.Tensor, "
                            f"got {type(t).__name__}")
        if t.dtype not in _SYMBOLS:
            raise TypeError(f"maxmin_matmul: {name} must be int32 or "
                            f"float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"maxmin_matmul: {name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"maxmin_matmul: {name} must be contiguous")
    if a.dtype != b.dtype:
        raise TypeError(f"maxmin_matmul: a is {a.dtype}, b is {b.dtype}; "
                        f"both must have one dtype")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"maxmin_matmul: a{tuple(a.shape)} and "
                         f"b{tuple(b.shape)} do not contract")
    if a.device != b.device:
        raise ValueError(f"maxmin_matmul: a is on {a.device}, b on "
                         f"{b.device}; both must share a device")


def maxmin_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  block: int = 512) -> torch.Tensor:
    """a [m, k], b [k, n], both int32 or both float32, non-negative,
    contiguous and on one device.  Returns [m, n] of their dtype on that
    device.  ``block`` bounds the plain version's broadcast on CPU tensors;
    the CUDA kernel tiles itself.  Anything else raises."""
    global LAUNCHES
    _check_operands(a, b)
    if a.device.type == "cpu":
        return maxmin_matmul_ref(a, b, block=block)
    if a.device.type != "cuda":
        raise ValueError(f"maxmin_matmul: unsupported device {a.device}")
    m, k = a.shape
    n = b.shape[1]
    if m == 0 or n == 0 or k == 0:     # a zero-size grid is a launch error
        return torch.zeros((m, n), dtype=a.dtype, device=a.device)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    launch("maxmin_matmul", _SYMBOLS[a.dtype], _ARGTYPES, a.device,
           (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k),
           f"maxmin_matmul {a.dtype} m={m}, k={k}, n={n}")
    LAUNCHES += 1
    return out
