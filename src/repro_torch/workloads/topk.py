"""Top-k strongest-s ranking: the k vertices with the largest
MR(u, .) from one label-row sweep.

The engine path batches ``u`` against every vertex — one row of the
vectorized label join (``mr_batch(full(n, u), arange(n))``), the same
sweep shape serving uses — and this module does the selection:
unreachable vertices (MR 0) and ``u`` itself are dropped, survivors are
ranked by (MR descending, vertex id ascending) so the answer is
deterministic across backends, and the top k are returned.

Counterpart of ``repro/workloads/topk.py``.  The selection stays on the
host (``np.lexsort``), as in the reference, so ties rank the same; a
selection on the device would have to keep that order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["select_top_s"]


def select_top_s(mr_row: np.ndarray, u: int, k: int,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices [<=k], mr values [<=k]) from a full MR(u, .) row."""
    row = np.asarray(mr_row, np.int64)
    verts = np.arange(row.size, dtype=np.int64)
    keep = (row > 0) & (verts != int(u))
    verts, vals = verts[keep], row[keep]
    order = np.lexsort((verts, -vals))[:int(k)]
    return verts[order], vals[order]
