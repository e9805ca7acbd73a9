"""Per-arch / per-shape sharding glue, as data: batch specs, parameter
and cache placement, dry-run input records.

Counterpart of ``repro/distributed_lm/sharding.py`` over a
``LogicalMesh`` (``core.mesh``).  Conventions, as the reference's:

* the batch dimension splits over ('pod', 'data') when the mesh has a
  'pod' axis, else ('data',);
* long-context decode (a batch too small to split): the KV cache's
  sequence dimension splits instead;
* parameters split over 'model' per the models' ``param_specs()``; the
  'pod' axis never splits parameters.

The reference's ``jax.ShapeDtypeStruct`` stand-ins become ``ShapeDtype``
records (shape, dtype, ``NamedSpec``); nothing is allocated and nothing
is placed: one card holds every block.

On ranks (a ``core.mesh.ProcessMesh``) a leaf is placed: ``block_slices``
/ ``leaf_block`` cut a whole leaf to this rank's block under its spec (a
dimension of size ``d`` split ``k`` ways keeps ``ceil(d / k)`` entries a
block, as XLA's shards and the dry-run's records do; an entry naming
several axes splits row-major over them; an axis the mesh lacks has size
1; a ``models.layers.Fused`` entry's dimension holds its parts side by
side, and the block is the rank's block of each part, an index array),
``leaf_spec`` finds a ``state_dict`` key's spec in a model's
``param_specs()``, ``cache_block`` / ``batch_block`` cut a cache or a
batch (the ``data`` coordinate picks the rows), and ``to_rank_widths``
turns a model built on ``meta`` into one rank's blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import convert
from ..models.common import ArchConfig
from ..models.layers import P, map_specs

__all__ = ["batch_axes", "batch_specs", "input_structs", "shard_params",
           "named", "cache_structs", "ShapeDtype", "NamedSpec",
           "spec_axes", "spec_entries", "block_slices", "leaf_block",
           "leaf_spec", "cache_block", "batch_block", "to_rank_widths",
           "block_shape", "head_vocab_split"]


@dataclasses.dataclass(frozen=True)
class NamedSpec:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: P


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """An array's shape and dtype, and where it would be placed."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional[NamedSpec] = None


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def named(mesh, spec: P) -> NamedSpec:
    return NamedSpec(mesh, spec)


def batch_specs(cfg: ArchConfig, mesh) -> Dict[str, P]:
    """Specs for one training batch dict."""
    ba = P(batch_axes(mesh))
    specs = {"tokens": ba, "labels": ba}
    if cfg.family == "vlm":
        specs["patch_embeds"] = ba
    elif cfg.family == "encdec":
        specs["frames"] = ba
    return specs


def input_structs(cfg: ArchConfig, mesh, batch: int, seq: int
                  ) -> Dict[str, ShapeDtype]:
    """Records of one global training batch (the dry-run's inputs)."""
    sp = batch_specs(cfg, mesh)

    def rec(shape, dtype, key):
        return ShapeDtype(tuple(shape), dtype, named(mesh, sp[key]))

    if cfg.family == "vlm":
        npatch = min(cfg.num_patches, seq // 2)
        return {"tokens": rec((batch, seq - npatch), torch.int32, "tokens"),
                "labels": rec((batch, seq), torch.int32, "labels"),
                "patch_embeds": rec((batch, npatch, cfg.vision_dim),
                                    torch.float32, "patch_embeds")}
    out = {"tokens": rec((batch, seq), torch.int32, "tokens"),
           "labels": rec((batch, seq), torch.int32, "labels")}
    if cfg.family == "encdec":
        out["frames"] = rec((batch, cfg.enc_frames, cfg.d_model),
                            torch.float32, "frames")
    return out


def cache_structs(model, cfg: ArchConfig, mesh, batch: int, seq: int,
                  long_ctx: bool) -> Dict[str, ShapeDtype]:
    """Records of the KV / state cache (shapes from ``init_cache`` on the
    ``meta`` device: nothing is allocated)."""
    shapes = type(model)(cfg, device="meta").init_cache(batch, seq)
    specs = model.cache_specs(long_ctx=long_ctx)

    def rec(spec, t):
        if not long_ctx and "pod" in mesh.axis_names:
            # extend batch sharding over the pod axis too
            entries = list(spec)
            for i, e in enumerate(entries):
                if e == "data":
                    entries[i] = ("pod", "data")
                    break
            spec = P(*entries)
        return ShapeDtype(tuple(t.shape), t.dtype, named(mesh, spec))

    return map_specs(rec, specs, shapes)


def shard_params(model, mesh) -> Dict:
    """Records of the parameters in the reference's tree (layers
    stacked), each with its ``param_specs`` entry on ``mesh``."""
    def stack(leaves):
        return ShapeDtype((len(leaves),) + leaves[0].shape, leaves[0].dtype)

    shapes = convert.nest_layers(
        {k: ShapeDtype(tuple(t.shape), t.dtype)
         for k, t in model.state_dict().items()}, stack=stack)
    return map_specs(lambda spec, r: dataclasses.replace(
        r, sharding=named(mesh, spec)), model.param_specs(), shapes)


# ---------------------------------------------------------------------------
# a rank's blocks (ProcessMesh)
# ---------------------------------------------------------------------------

def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (a name, a tuple, or ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_entries(spec, ndim: int) -> list:
    """``spec``'s entries padded with ``None`` to ``ndim`` dimensions."""
    return list(spec) + [None] * (ndim - len(spec))


def head_vocab_split(params) -> bool:
    """Whether the head's vocab dimension is split over ``model``, so the
    logits come out vocab-split: the ``lm_head``'s columns, else the tied
    embedding's rows (not Whisper's, split on ``d_model``: its head sums
    whole logits over ``model``).  ``params``: a ``param_specs()`` tree
    or the parameter records (each with its spec)."""
    def spec(leaf):
        return leaf.sharding.spec if isinstance(leaf, ShapeDtype) else leaf
    if "lm_head" in params:
        w = spec(params["lm_head"]["w"])
        return "model" in spec_axes(spec_entries(w, 2)[-1])
    return "model" in spec_axes(spec_entries(spec(params["embed"]), 2)[0])


def block_slices(shape: Sequence[int], spec, mesh) -> Tuple:
    """This rank's block of an array of ``shape`` split by ``spec`` on the
    ``ProcessMesh`` ``mesh``: along a dimension of size ``d`` split into
    ``k`` blocks (the product of its axes' sizes), block ``c`` (the
    rank's coordinates over those axes, row-major) is ``[c * ceil(d / k),
    min((c + 1) * ceil(d / k), d))``.  A ``models.layers.Fused`` entry
    splits each of its ``parts`` (``d / parts`` wide) so, and the block is
    an int64 index array of the rank's entries of every part in order."""
    out = []
    for d, entry in zip(shape, spec_entries(spec, len(shape))):
        k, c = 1, 0
        for axis in spec_axes(entry):
            n = mesh.shape.get(axis, 1)
            c = c * n + (mesh.axis_index(axis) if n > 1 else 0)
            k *= n
        parts = getattr(entry, "parts", 1)
        if int(d) % parts:
            raise ValueError(f"a dimension of {d} does not hold {parts} "
                             f"equal fused parts")
        size = int(d) // parts
        step = -(-size // k)
        lo, hi = min(c * step, size), min((c + 1) * step, size)
        if parts == 1:
            out.append(slice(lo, hi))
        else:
            out.append(np.concatenate([np.arange(j * size + lo,
                                                 j * size + hi)
                                       for j in range(parts)]))
    return tuple(out)


def block_shape(block: Sequence) -> Tuple[int, ...]:
    """The shape of a block of ``block_slices``."""
    return tuple(len(s) if isinstance(s, np.ndarray) else s.stop - s.start
                 for s in block)


def leaf_block(t, spec, mesh):
    """``t``'s block (a tensor or an array) under ``spec`` on ``mesh``: a
    view, or a copy where a fused dimension's block is an index array."""
    return t[block_slices(t.shape, spec, mesh)]


def leaf_spec(specs, key: str):
    """The spec of ``state_dict`` key ``key`` in a model's
    ``param_specs()`` tree: a ``convert.STACKED`` group's layer axis
    (``<group>.<i>.``) is dropped from its stacked spec."""
    parts = key.split(".")
    stacked = parts[0] in convert.STACKED
    node = specs
    for p in ([parts[0]] + parts[2:]) if stacked else parts:
        node = node[int(p)] if isinstance(node, list) else node[p]
    return P(*node[1:]) if stacked else node


def cache_block(cache: Dict[str, Any], model, mesh,
                long_ctx: bool = False) -> Dict[str, Any]:
    """Each leaf of a whole cache cut to this rank's block by the model's
    ``cache_specs`` (copies, so the whole may be freed)."""
    specs = model.cache_specs(long_ctx=long_ctx)
    return {k: leaf_block(v, specs[k], mesh).clone() for k, v in
            cache.items()}


def batch_block(batch: Dict[str, Any], cfg: ArchConfig,
                mesh) -> Dict[str, Any]:
    """Each leaf of a batch cut to this rank's rows: the ``data``
    coordinate picks its block of the leading dimension (copies)."""
    specs = batch_specs(cfg, mesh)
    return {k: leaf_block(v, specs.get(k, P(batch_axes(mesh))),
                          mesh).clone() for k, v in batch.items()}


def to_rank_widths(model: nn.Module, mesh, device: torch.device) -> None:
    """Turns ``model`` (built on ``meta``) into this rank's share of it on
    ``device``: every parameter becomes an unset tensor of its block under
    ``model.param_specs()`` on ``mesh``, carrying ``whole_shape`` and
    ``block`` (its slices of the whole leaf), so that ``init`` draws each
    whole leaf and keeps the block (``models.layers.draw``); every
    ``Dense`` whose contraction dimension is split over ``model`` (a
    row-split weight) gets ``reduce_over = "model"``, so that its output,
    a partial product, is summed over the axis (``layers.dense_apply``)."""
    from ..models.layers import Dense
    specs = model.param_specs()
    for key, old in list(model.named_parameters()):
        spec = leaf_spec(specs, key)
        block = block_slices(old.shape, spec, mesh)
        shape = block_shape(block)
        owner, _, name = key.rpartition(".")
        module = model.get_submodule(owner)
        new = nn.Parameter(torch.empty(shape, dtype=old.dtype,
                                       device=device))
        new.whole_shape, new.block = tuple(old.shape), block
        setattr(module, name, new)
        if isinstance(module, Dense) and name == "w" and \
                "model" in spec_axes(spec_entries(spec, old.dim())[-2]):
            module.reduce_over = "model"
