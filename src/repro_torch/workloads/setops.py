"""Set-to-set and multi-source MR: batched reductions over label rows.

``mr_set(U, V) = max over (u, v) in U x V of MR(u, v)`` — "can any
seed reach any target, and how strongly".  The engine path materializes
the |U| x |V| cross-product as one query batch and routes it through
``mr_batch``, i.e. through the same vectorized ``DeviceSnapshot`` label
join every other batch takes — and therefore through the CUDA
``label_join_gather`` kernel (``KernelSnapshot``) when the engine serves
kernels.  The reduction (max, or per-target max for multi-source)
happens on the result row; no new device code is needed, which is the
point: one label layout, many workloads.

Counterpart of ``repro/workloads/setops.py``; the messages are the
reference's.  Every id is held to ``[0, n)`` here, before ``mr_batch``:
the kernel traps on an id outside the snapshot it joins.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["normalize_vertex_set", "cross_pairs"]


def normalize_vertex_set(vs, n: int, name: str = "vertex set",
                         ) -> np.ndarray:
    """Validate and canonicalize one side of a set query: non-empty,
    integer dtype, ids in [0, n), duplicates dropped (a set), sorted."""
    arr = np.asarray(vs)
    if arr.size == 0:
        raise ValueError(f"{name} must be non-empty")
    if arr.ndim != 1:
        raise ValueError(f"{name} must be 1-D; got shape {arr.shape}")
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"{name} must have an integer dtype; got {arr.dtype}")
    arr = arr.astype(np.int64)
    if arr.size and (arr.min() < 0 or arr.max() >= n):
        bad = int(arr.min()) if arr.min() < 0 else int(arr.max())
        raise IndexError(f"{name} id {bad} out of range [0, {n})")
    return np.unique(arr)


def cross_pairs(us: np.ndarray, vs: np.ndarray,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The |U| x |V| query batch, row-major (us varies slowest) — the
    caller reshapes the answer row to [|U|, |V|] for reductions."""
    return (np.repeat(us, len(vs)), np.tile(vs, len(us)))
