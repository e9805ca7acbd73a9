"""Batched HL-index label join (Algorithm 5): plain versions, CUDA wrappers.

    out[q] = max over common hubs of min(s_u[q], s_v[q])

— the serving-path inner loop.  Each query row holds two padded,
rank-sorted label lists.  Counterpart of ``repro/kernels/label_join.py``
(the Pallas kernel) and of ``label_join_ref`` in ``repro/kernels/ref.py``.

* ``label_join_ref`` — the plain PyTorch version: the all-pairs
  hub-equality join, a ``[Q, L, L]`` compare + select + max.  It is what
  the CPU tests run and what the CUDA kernel is held against on the card.
* ``label_join`` — the wrapper on four ``[Q, L]`` operands.  CPU tensors go
  to the plain version; CUDA tensors launch the hand-written kernel
  ``csrc/label_join.cu`` or raise.  There is no fallback from the kernel to
  anything else.
* ``label_join_gather`` — the same join on a snapshot's own ``[n, L]``
  ``ranks`` / ``svals`` and two ``[Q]`` int64 id vectors: the kernel reads
  row ``us[q]`` and row ``vs[q]`` itself, so no gathered rows are written.
  Its plain version is ``label_join_gather_ref``.  This is what
  ``KernelSnapshot.mr`` (the serving path) calls.
* ``lanes_per_query`` — the route the kernel takes for rows of length L,
  chosen once per launch: a group of that many lanes per query (L <= 32),
  or 0 for one warp per query row.
* ``LAUNCHES`` — incremented once per kernel launch, through either entry
  point, and nowhere else, so a run can show that a batch really went
  through the kernel; ``GATHER_LAUNCHES`` counts the launches of
  ``label_join_gather`` among them.

Sentinel contract (shared with ``DeviceSnapshot`` / ``pad_label_rows``):

* rank padding is ``INT32_MAX`` (2^31 - 1) on both operands; s padding is 0
  and real s values are positive, so padding sorts last and is inert;
* the reference pads a batch to its block size with query rows that carry
  ``INT32_MAX - 1`` on the u side.  A CUDA launch masks its own ragged edge,
  so this package adds no such rows, but it keeps the reference's bound so
  both refuse the same snapshots: **real ranks must be <= MAX_RANK =
  2^31 - 3** — ``validate_ranks`` asserts it once per snapshot
  (``KernelSnapshot``), not per query batch;
* ids given to ``label_join_gather`` lie in ``[0, n)``: the plain version
  raises ``IndexError`` otherwise, the kernel stops (a device-side trap,
  as PyTorch's own indexing does on the card).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import launch

__all__ = ["label_join", "label_join_ref", "label_join_gather",
           "label_join_gather_ref", "lanes_per_query", "validate_ranks",
           "MAX_RANK", "LAUNCHES", "GATHER_LAUNCHES"]

_PAD = np.iinfo(np.int32).max          # rank-slot padding (both operands)
MAX_RANK = _PAD - 2                    # largest legal real rank (2^31 - 3)

# kernel launches made by ``label_join`` and ``label_join_gather`` in this
# process, and those of ``label_join_gather`` alone
LAUNCHES = 0
GATHER_LAUNCHES = 0

_WARP = 32


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
_GATHER_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_longlong]


def lanes_per_query(l: int) -> int:
    """The kernel's route for label rows of length ``l``, as
    ``label_join_lanes_per_query`` in ``csrc/label_join.cu`` chooses it:
    the smallest power of two >= ``l`` lanes per query for ``l <= 32``
    (several queries share a warp), 0 for one warp per query row, -1 for
    ``l <= 0`` (nothing to launch)."""
    if l <= 0:
        return -1
    if l > _WARP:
        return 0
    return 1 << (l - 1).bit_length()


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


def _check_ids_in_range(ids: torch.Tensor, n: int) -> None:
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise IndexError(f"label_join_gather: row ids must lie in [0, {n}), "
                         f"got [{int(ids.min())}, {int(ids.max())}]")


def label_join_gather_ref(ranks: torch.Tensor, svals: torch.Tensor,
                          us: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """The plain version of ``label_join_gather``: ``label_join_ref`` on the
    rows ``us`` and ``vs`` of the snapshot ``ranks`` / ``svals`` [n, L].
    Raises ``IndexError`` on an id outside [0, n)."""
    for ids in (us, vs):
        _check_ids_in_range(ids, ranks.shape[0])
    return label_join_ref(ranks[us], svals[us], ranks[vs], svals[vs])


def _check_gather_operands(ranks, svals, us, vs) -> None:
    for name, t in (("ranks", ranks), ("svals", svals), ("us", us),
                    ("vs", vs)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"label_join_gather: {name} must be a "
                            f"torch.Tensor, got {type(t).__name__}")
    for name, t, dtype, dim in (("ranks", ranks, torch.int32, 2),
                                ("svals", svals, torch.int32, 2),
                                ("us", us, torch.int64, 1),
                                ("vs", vs, torch.int64, 1)):
        if t.dtype != dtype:
            raise TypeError(f"label_join_gather: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"label_join_gather: {name} must have {dim} "
                             f"dimension(s), got shape {tuple(t.shape)}")
        if t.device != ranks.device:
            raise ValueError(f"label_join_gather: {name} is on {t.device}, "
                             f"ranks on {ranks.device}; all four must share "
                             f"a device")
        if not t.is_contiguous():
            raise ValueError(f"label_join_gather: {name} must be contiguous")
    if svals.shape != ranks.shape:
        raise ValueError(f"label_join_gather: svals has shape "
                         f"{tuple(svals.shape)}, ranks {tuple(ranks.shape)}; "
                         f"they must match")
    if us.shape != vs.shape:
        raise ValueError(f"label_join_gather: us has {us.shape[0]} ids, vs "
                         f"{vs.shape[0]}; they must match")


def label_join_gather(ranks: torch.Tensor, svals: torch.Tensor,
                      us: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """The join of row ``us[q]`` against row ``vs[q]`` of a snapshot:
    ``ranks`` / ``svals`` [n, L] int32 (the ``label_join`` row contract),
    ``us`` / ``vs`` [Q] int64 ids in [0, n), all contiguous and on one
    device.  Returns [Q] int32 on that device.  Q = 0 or L = 0 answers
    zeros with no launch.  Anything else raises."""
    global LAUNCHES, GATHER_LAUNCHES
    _check_gather_operands(ranks, svals, us, vs)
    if ranks.device.type == "cpu":
        return label_join_gather_ref(ranks, svals, us, vs)
    if ranks.device.type != "cuda":
        raise ValueError(f"label_join_gather: unsupported device "
                         f"{ranks.device}")
    (n, lmax), q = ranks.shape, us.shape[0]
    if q == 0 or lmax == 0:            # a zero-size grid is a launch error
        return torch.zeros((q,), dtype=torch.int32, device=ranks.device)
    out = torch.empty((q,), dtype=torch.int32, device=ranks.device)
    launch("label_join", "label_join_gather_launch", _GATHER_ARGTYPES,
           ranks.device,
           (ranks.data_ptr(), svals.data_ptr(), us.data_ptr(), vs.data_ptr(),
            out.data_ptr(), q, lmax, n),
           f"label_join_gather Q={q}, L={lmax}, n={n}")
    LAUNCHES += 1
    GATHER_LAUNCHES += 1
    return out
