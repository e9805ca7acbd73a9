"""One boolean-closure squaring round over a threshold batch: plain
version, CUDA wrapper.

    out[s] = (R[s] @ R[s] > 0)           R [S, m, m] 0/1 float32

— one round of the threshold-batched closure (``threshold_closure_mr``).
Counterpart of ``repro/kernels/threshold_closure.py`` (the Pallas kernel)
and of ``threshold_step_ref`` in ``repro/kernels/ref.py``.

* ``threshold_step_ref`` — the plain PyTorch version,
  ``(torch.bmm(r, r) > 0).to(r.dtype)``.
* ``threshold_step`` — the wrapper.  CPU tensors go to the plain version;
  CUDA tensors launch the hand-written kernel ``csrc/threshold_step.cu``
  (one launch per batch, the ``> 0`` fused into the epilogue so path counts
  never reach device memory) or raise.  No fallback.
* ``LAUNCHES`` — incremented once per kernel launch and nowhere else.

The sums are float32 on the CUDA cores, never TF32: a path count below
2^24 is an exact integer, so the binarised answer is exact.
"""
from __future__ import annotations

import ctypes

import torch

from .build import launch

__all__ = ["threshold_step", "threshold_step_ref", "threshold_adjacency",
           "LAUNCHES"]

# kernel launches made by ``threshold_step`` in this process
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2


def threshold_adjacency(w: torch.Tensor,
                        thresholds: torch.Tensor) -> torch.Tensor:
    """The first operand of the rounds: ``[S, m, m]`` float32 0/1,
    ``(W >= t_s)`` for each threshold, with self-loops (closure
    semantics), on ``w``'s device."""
    t = thresholds.to(w.device)
    adj = (w[None, :, :] >= t[:, None, None]).to(torch.float32)
    adj.diagonal(dim1=1, dim2=2).fill_(1.0)
    return adj


def threshold_step_ref(r: torch.Tensor) -> torch.Tensor:
    """One boolean-closure squaring round over a threshold batch:
    out[s] = (R[s] @ R[s] > 0), float 0/1 in, float 0/1 out."""
    return (torch.bmm(r, r) > 0).to(r.dtype)


def _check_operand(r) -> None:
    if not isinstance(r, torch.Tensor):
        raise TypeError(f"threshold_step: r must be a torch.Tensor, got "
                        f"{type(r).__name__}")
    if r.dtype != torch.float32:
        raise TypeError(f"threshold_step: r must be float32, got {r.dtype}")
    if r.dim() != 3 or r.shape[1] != r.shape[2]:
        raise ValueError(f"threshold_step: r must be [S, m, m], got shape "
                         f"{tuple(r.shape)}")
    if not r.is_contiguous():
        raise ValueError("threshold_step: r must be contiguous")


def threshold_step(r: torch.Tensor) -> torch.Tensor:
    """r [S, m, m] 0/1 float32, contiguous.  Returns a new [S, m, m] 0/1
    float32 tensor on its device; S or m of 0 returns ``r`` itself with no
    launch, as the reference does.  Anything else raises."""
    global LAUNCHES
    _check_operand(r)
    s, m, _ = r.shape
    if s == 0 or m == 0:               # a zero-size grid is a launch error
        return r
    if r.device.type == "cpu":
        return threshold_step_ref(r)
    if r.device.type != "cuda":
        raise ValueError(f"threshold_step: unsupported device {r.device}")
    out = torch.empty_like(r)
    launch("threshold_step", "threshold_step_launch", _ARGTYPES, r.device,
           (r.data_ptr(), out.data_ptr(), s, m),
           f"threshold_step S={s}, m={m}")
    LAUNCHES += 1
    return out
