"""Gradient compression: the int8 all-reduce over a mesh axis.

Counterpart of ``repro/distributed_lm/compression.py``.  Wire format:
blockwise-int8 codes + float32 absmax scales per shard; each device
gathers every shard's (codes, scales), dequantizes and sums locally: 4x
fewer bytes than a float32 all-reduce.  On one card the devices of the
axis are the slices of a leading per-device axis, and the gather is the
slices themselves: each is quantized, dequantized, and the slices are
summed in order and divided by their count, the reference's all-gather
body run in one process.  On a ``ProcessMesh`` (``core/mesh.py``) the
body runs on ranks as the reference's does inside ``shard_map``: each
rank's leaf is its own gradient ``[1, ...]``, its codes and scales are
all-gathered over ``axis`` (``core/collectives.py``), and every rank
dequantizes, sums in rank order and divides, so every rank gets the
same tensor, bit-equal to the one-process version on the stacked
slices.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..core.collectives import all_gather_panel
from ..core.mesh import ProcessMesh
from ..train.optimizer import quantize_blockwise

__all__ = ["compressed_allreduce"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def compressed_allreduce(tree: Any, mesh, axis: str = "data",
                         block: int = 256) -> Any:
    """Mean of per-device gradient shards across ``axis`` with int8 wire
    traffic.  Leaves (tensors) carry a leading per-device dimension of
    size ``mesh.shape[axis]`` (of size 1 on a ``ProcessMesh``: this
    rank's gradient); the output drops it (the mean)."""
    n = mesh.shape[axis]
    on_ranks = isinstance(mesh, ProcessMesh)

    def one(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.shape[0] != (1 if on_ranks else n):
            holds = ("a rank holds 1" if on_ranks
                     else f"the {axis!r} axis has {n} devices")
            raise ValueError(f"leaf has {leaf.shape[0]} per-device slices; "
                             f"{holds}")
        shape = tuple(leaf.shape[1:])
        nelem = math.prod(shape)
        if on_ranks:
            codes, scale = quantize_blockwise(leaf[0].float(), block)
            all_codes = all_gather_panel(codes[None], mesh, axis, dim=0)
            all_scale = all_gather_panel(scale[None], mesh, axis, dim=0)
            slices = [(all_codes[i], all_scale[i]) for i in range(n)]
        else:
            slices = (quantize_blockwise(leaf[i].float(), block)
                      for i in range(n))
        summed = None
        for codes, scale in slices:
            deq = codes.float() * scale                 # [nb, blk]
            summed = deq if summed is None else summed + deq
        out = summed.reshape(-1)[:nelem] / n
        return out.reshape(shape).to(leaf.dtype)

    return _tree_map(one, tree)
