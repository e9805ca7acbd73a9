"""Gradient compression: the int8 all-reduce over a mesh axis.

Counterpart of ``repro/distributed_lm/compression.py``.  Wire format:
blockwise-int8 codes + float32 absmax scales per shard; each device
gathers every shard's (codes, scales), dequantizes and sums locally: 4x
fewer bytes than a float32 all-reduce.  On one card the devices of the
axis are the slices of a leading per-device axis, and the gather is the
slices themselves: each is quantized, dequantized, and the slices are
summed in order and divided by their count, the reference's all-gather
body run in one process.
"""
from __future__ import annotations

import math
from typing import Any

import torch

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
    size ``mesh.shape[axis]``; the output drops it (the mean)."""
    n = mesh.shape[axis]

    def one(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.shape[0] != n:
            raise ValueError(f"leaf has {leaf.shape[0]} per-device slices; "
                             f"the {axis!r} axis has {n} devices")
        shape = tuple(leaf.shape[1:])
        nelem = math.prod(shape)
        summed = None
        for i in range(n):
            codes, scale = quantize_blockwise(leaf[i].float(), block)
            deq = codes.float() * scale                 # [nb, blk]
            summed = deq if summed is None else summed + deq
        out = summed.reshape(-1)[:nelem] / n
        return out.reshape(shape).to(leaf.dtype)

    return _tree_map(one, tree)
