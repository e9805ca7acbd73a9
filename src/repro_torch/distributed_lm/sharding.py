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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .. import convert
from ..models.common import ArchConfig
from ..models.layers import P, map_specs

__all__ = ["batch_axes", "batch_specs", "input_structs", "shard_params",
           "named", "cache_structs", "ShapeDtype", "NamedSpec"]


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
