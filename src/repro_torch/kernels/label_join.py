"""Batched HL-index label join (Algorithm 5): plain version, CUDA wrapper.

    out[q] = max over common hubs of min(s_u[q], s_v[q])

— the serving-path inner loop.  Each query row holds two padded,
rank-sorted label lists.  Counterpart of ``repro/kernels/label_join.py``
(the Pallas kernel) and of ``label_join_ref`` in ``repro/kernels/ref.py``.

* ``label_join_ref`` — the plain PyTorch version: the all-pairs
  hub-equality join, a ``[Q, L, L]`` compare + select + max.  It is what
  the CPU tests run and what the CUDA kernel is held against on the card.
* ``label_join`` — the wrapper.  CPU tensors go to the plain version; CUDA
  tensors launch the hand-written kernel ``csrc/label_join.cu`` (one warp
  per query row, binary search over the v row staged in shared memory) or
  raise.  There is no fallback from the kernel to anything else.
* ``LAUNCHES`` — incremented once per kernel launch and nowhere else, so a
  run can show that a batch really went through the kernel.

Sentinel contract (shared with ``DeviceSnapshot`` / ``pad_label_rows``):

* rank padding is ``INT32_MAX`` (2^31 - 1) on both operands; s padding is 0
  and real s values are positive, so padding sorts last and is inert;
* the reference pads a batch to its block size with query rows that carry
  ``INT32_MAX - 1`` on the u side.  A CUDA launch masks its own ragged edge,
  so this package adds no such rows, but it keeps the reference's bound so
  both refuse the same snapshots: **real ranks must be <= MAX_RANK =
  2^31 - 3** — ``validate_ranks`` asserts it once per snapshot
  (``KernelSnapshot``), not per query batch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import launch

__all__ = ["label_join", "label_join_ref", "validate_ranks", "MAX_RANK",
           "LAUNCHES"]

_PAD = np.iinfo(np.int32).max          # rank-slot padding (both operands)
MAX_RANK = _PAD - 2                    # largest legal real rank (2^31 - 3)

# kernel launches made by ``label_join`` in this process
LAUNCHES = 0


def validate_ranks(ranks) -> None:
    """Raise if any real rank aliases a padding sentinel.

    One host-visible reduction; callers run it once per snapshot (not
    per batch).  The padded label form uses ``INT32_MAX`` for empty
    slots and the reference reserves ``INT32_MAX - 1`` for whole padded
    query rows, so real ranks above ``MAX_RANK`` are refused.
    """
    ranks = torch.as_tensor(ranks)
    if ranks.numel() == 0:
        return
    real_max = int(torch.where(ranks == _PAD, -1, ranks).max())
    if real_max > MAX_RANK:
        raise ValueError(
            f"label rank {real_max} aliases the padding sentinels; the "
            f"kernel join supports real ranks <= {MAX_RANK} (2^31 - 3), "
            f"i.e. at most 2^31 - 2 hyperedges")


def label_join_ref(ru: torch.Tensor, su: torch.Tensor,
                   rv: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """Batched HL-index label join (Algorithm 5 semantics):
    out[q] = max over common hubs of min(s_u, s_v).

    ru/rv: [Q, L] ascending hub ranks (INT32_MAX padding);
    su/sv: [Q, L] s values (0 padding).
    """
    if ru.numel() == 0:
        return torch.zeros((ru.shape[0],), dtype=su.dtype, device=su.device)
    eq = ru[:, :, None] == rv[:, None, :]                      # [Q, L, L]
    cand = torch.where(eq, torch.minimum(su[:, :, None], sv[:, None, :]), 0)
    return cand.amax(dim=(1, 2))


def _check_operands(ru, su, rv, sv) -> None:
    names = ("ru", "su", "rv", "sv")
    for name, t in zip(names, (ru, su, rv, sv)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"label_join: {name} must be a torch.Tensor, "
                            f"got {type(t).__name__}")
        if t.dtype != torch.int32:
            raise TypeError(f"label_join: {name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"label_join: {name} must be [Q, L], got shape "
                             f"{tuple(t.shape)}")
        if t.shape != ru.shape:
            raise ValueError(f"label_join: {name} has shape {tuple(t.shape)}"
                             f", ru has {tuple(ru.shape)}; all four must "
                             f"match")
        if t.device != ru.device:
            raise ValueError(f"label_join: {name} is on {t.device}, ru on "
                             f"{ru.device}; all four must share a device")
        if not t.is_contiguous():
            raise ValueError(f"label_join: {name} must be contiguous")


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]


def label_join(ru: torch.Tensor, su: torch.Tensor, rv: torch.Tensor,
               sv: torch.Tensor) -> torch.Tensor:
    """ru/rv [Q, L] int32 ascending ranks (INT32_MAX pad), su/sv [Q, L]
    int32 (0 pad), all contiguous and on one device.  Returns [Q] int32 on
    that device.  Any Q and L are legal, 0 included (nothing joins: all
    zeros, no launch).  Anything else raises."""
    global LAUNCHES
    _check_operands(ru, su, rv, sv)
    q, lmax = ru.shape
    if ru.device.type == "cpu":
        return label_join_ref(ru, su, rv, sv)
    if ru.device.type != "cuda":
        raise ValueError(f"label_join: unsupported device {ru.device}")
    if q == 0 or lmax == 0:            # a zero-size grid is a launch error
        return torch.zeros((q,), dtype=torch.int32, device=ru.device)
    out = torch.empty((q,), dtype=torch.int32, device=ru.device)
    launch("label_join", "label_join_launch", _ARGTYPES, ru.device,
           (ru.data_ptr(), su.data_ptr(), rv.data_ptr(), sv.data_ptr(),
            out.data_ptr(), q, lmax), f"label_join Q={q}, L={lmax}")
    LAUNCHES += 1
    return out
