"""One boolean-closure squaring round over a threshold batch: plain
version, CUDA wrapper.

    out[s] = (R[s] @ R[s] > 0)           R [S, m, m] 0/1, float32 or bf16

— one round of the threshold-batched closure (``threshold_closure_mr``).
Counterpart of ``repro/kernels/threshold_closure.py`` (the Pallas kernel)
and of ``threshold_step_ref`` in ``repro/kernels/ref.py``.

* ``threshold_step_ref`` — the plain PyTorch version,
  ``(torch.bmm(r, r) > 0).to(r.dtype)``.
* ``threshold_step`` — the wrapper.  CPU tensors go to the plain version;
  CUDA tensors launch the hand-written kernel ``csrc/threshold_step.cu``
  (bf16 tensor cores fed by TMA, one launch per batch, the ``> 0`` fused
  into the epilogue so path counts never reach device memory) or raise.
  No fallback.  The kernel reads and writes bf16: a float32 operand is
  cast first (exact for 0/1) and its answer cast back, so the result has
  the input's dtype, as the reference's.
* ``largest_threshold`` — the read-out after the rounds: per pair the
  largest threshold whose closure joins it, float32.
* ``padded_extent`` / ``pad_batch`` / ``crop_batch`` — the shape logic
  around the launch: TMA needs 16-byte rows, so ``m`` is padded with zero
  rows and columns to a multiple of 8 (they add no paths) and the result
  cropped, as the reference pads to block multiples.
* ``LAUNCHES`` — incremented once per kernel launch and nowhere else;
  ``PADDED`` — the launches among them that needed the pad.

The sums are float32 in the tensor cores: a path count below 2^24 is an
exact integer, so the binarised answer is exact.
"""
from __future__ import annotations

import ctypes

import torch

from .build import launch, tma_extent, tma_operand

__all__ = ["threshold_step", "threshold_step_ref", "threshold_adjacency",
           "largest_threshold", "padded_extent", "pad_batch", "crop_batch",
           "LAUNCHES", "PADDED"]

# kernel launches made by ``threshold_step`` in this process
LAUNCHES = 0
# of those, launches whose m needed the zero pad
PADDED = 0

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2


def threshold_adjacency(w: torch.Tensor, thresholds: torch.Tensor, *,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The first operand of the rounds: ``[S, m, m]`` 0/1 in ``dtype``,
    ``(W >= t_s)`` for each threshold, with self-loops (closure
    semantics), on ``w``'s device."""
    t = thresholds.to(w.device)
    adj = (w[None, :, :] >= t[:, None, None]).to(dtype)
    adj.diagonal(dim1=1, dim2=2).fill_(1)
    return adj


def largest_threshold(reach: torch.Tensor,
                      thresholds: torch.Tensor) -> torch.Tensor:
    """``max over s of reach[s] * t_s`` as float32 [m, m]: the MR value of
    every pair once the rounds are done.  Taken one slice at a time in
    float32, whatever ``reach``'s dtype: a bf16 product would round any
    threshold above 256."""
    t = thresholds.to(reach.device, torch.float32)
    mr = torch.where(reach[0] > 0, t[0], 0.0)
    for r_s, t_s in zip(reach[1:], t[1:]):
        torch.maximum(mr, torch.where(r_s > 0, t_s, 0.0), out=mr)
    return mr


def threshold_step_ref(r: torch.Tensor) -> torch.Tensor:
    """One boolean-closure squaring round over a threshold batch:
    out[s] = (R[s] @ R[s] > 0), float 0/1 in, float 0/1 out."""
    return (torch.bmm(r, r) > 0).to(r.dtype)


def padded_extent(m: int) -> int:
    """The side the kernel runs at: ``m`` rounded up to a multiple of 8."""
    return tma_extent(m)


def pad_batch(r: torch.Tensor) -> torch.Tensor:
    """The kernel's operand (``build.tma_operand``): ``r`` [S, m, m] as bf16
    [S, mp, mp] with ``mp = padded_extent(m)``, zeros past ``m``; one cast
    (and copy) where ``r`` is float32, none where it is bf16, aligned, and
    ``m`` a multiple of 8."""
    return tma_operand(r, dims=2)


def crop_batch(out: torch.Tensor, m: int) -> torch.Tensor:
    """The kernel's [S, mp, mp] result cut back to [S, m, m], contiguous."""
    if out.shape[1] == m:
        return out
    return out[:, :m, :m].contiguous()


def _check_operand(r) -> None:
    if not isinstance(r, torch.Tensor):
        raise TypeError(f"threshold_step: r must be a torch.Tensor, got "
                        f"{type(r).__name__}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"threshold_step: r must be float32 or bfloat16, "
                        f"got {r.dtype}")
    if r.dim() != 3 or r.shape[1] != r.shape[2]:
        raise ValueError(f"threshold_step: r must be [S, m, m], got shape "
                         f"{tuple(r.shape)}")
    if not r.is_contiguous():
        raise ValueError("threshold_step: r must be contiguous")


def threshold_step(r: torch.Tensor) -> torch.Tensor:
    """r [S, m, m] 0/1 float32 or bfloat16, contiguous.  Returns a new
    [S, m, m] 0/1 tensor of its dtype on its device; S or m of 0 returns
    ``r`` itself with no launch, as the reference does.  Anything else
    raises."""
    global LAUNCHES, PADDED
    _check_operand(r)
    s, m, _ = r.shape
    if s == 0 or m == 0:               # a zero-size grid is a launch error
        return r
    if r.device.type == "cpu":
        return threshold_step_ref(r)
    if r.device.type != "cuda":
        raise ValueError(f"threshold_step: unsupported device {r.device}")
    operand = pad_batch(r)
    mp = operand.shape[1]
    out = torch.empty_like(operand)
    launch("threshold_step", "threshold_step_launch", _ARGTYPES, r.device,
           (operand.data_ptr(), out.data_ptr(), s, mp),
           f"threshold_step {r.dtype} S={s}, m={m}")
    LAUNCHES += 1
    PADDED += mp != m
    return crop_batch(out, m).to(r.dtype)
