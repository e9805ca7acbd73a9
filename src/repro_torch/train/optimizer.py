"""Optimizers: AdamW (float32 moments) and blockwise-int8 Adam (8-bit
moments with per-block float32 absmax scales).

Counterpart of ``repro/train/optimizer.py``, with the same math in the
same float32 order.  State is plain data keyed like the parameters:

* ``params``: ``{name: tensor}``, the model's ``named_parameters()``
  (``state_dict`` names, one entry per layer);
* ``adam_init`` -> ``{"m": {name: ...}, "v": {name: ...}, "count": int32
  0-d tensor}``; with ``use_8bit`` each moment is ``{"codes": int8,
  "scale": float32}`` of ``quantize_shaped`` along the last dimension.

``adam_update`` writes the new parameters and moments into these
tensors in place (a torch optimizer's idiom; the reference returns new
pytrees) and returns the same objects: whatever must outlive a step, a
checkpoint above all, is copied to the host first
(``train.checkpoint``).  ``zero1_specs`` / ``opt_state_specs`` give the
reference's ZeRO-1 spec trees as data (``models.layers.P``); on one card
nothing is split.

On ranks that split ``model`` (``ranks``, a ``ProcessMesh``) the
parameters, gradients and moments are the rank's blocks, and the update
runs on them in place as in one process; only the global norm crosses:
each rank's sum of squares (its split leaves' blocks, and the leaves
whole on every rank of the line counted on its first rank only) in one
float32 all-reduce over ``model``.

On ranks whose ``data`` axis is over 1 (ZeRO-1, ``zero1_layout``) a rank
holds its shard of each moment only: the reference's ``opt_state_specs``
of the stacked leaf (``model.param_specs()``, layers on a leading axis)
put ``data`` on one free dimension, and the rank keeps its data
coordinate's block of that dimension of its ``model`` block.  Where that
dimension is a stacked group's layer axis, the rank holds whole moments
(its ``model`` block) of the layers its coordinate owns, and ``m`` /
``v`` have no entry for the other layers' keys.  The gradients given to
``adam_update`` are then the same shards (``train.train_step``
reduce-scatters them over ``data``), the update writes the rank's block
of each parameter, and the norm sums the shards over the whole grid.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Collection, Dict, Mapping, Optional, Tuple

import torch

from .. import convert
from ..core import collectives as coll
from ..models.layers import P, map_specs

__all__ = ["AdamConfig", "adam_init", "adam_update", "lr_schedule",
           "global_norm", "clip_by_global_norm", "quantize_blockwise",
           "dequantize_blockwise", "quantize_shaped", "dequantize_shaped",
           "quantize_v_shaped", "dequantize_v_shaped", "zero1_specs",
           "opt_state_specs", "Zero1Leaf", "Zero1Layout", "zero1_layout"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    use_8bit: bool = False
    q_block: int = 256


# ---------------------------------------------------------------------------
# blockwise int8 quantization (``torch.round`` rounds half to even, as
# ``jnp.round``)
# ---------------------------------------------------------------------------

def _absmax_codes(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes, scale.float()


def quantize_blockwise(x: torch.Tensor, block: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 codes [n_blocks, block], float32 scales
    [n_blocks, 1]).  Flattened absmax quantization; the pad tail
    quantizes zeros.  (Wire-format variant, used by gradient
    compression.)"""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return _absmax_codes(flat.reshape(-1, block))


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor,
                         shape: Tuple[int, ...]) -> torch.Tensor:
    n = math.prod(shape)
    flat = (codes.float() * scale).reshape(-1)[:n]
    return flat.reshape(shape)


def quantize_shaped(x: torch.Tensor, block: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape-preserving blockwise int8 along the LAST dim: codes have
    x's shape (int8, last dim padded up to a block multiple), scales are
    [..., n_blocks] float32, so a moment keeps its parameter's layout."""
    *lead, last = x.shape
    pad = (-last) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    nb = (last + pad) // block
    codes, scale = _absmax_codes(x.reshape(*lead, nb, block))
    return codes.reshape(*lead, last + pad), scale[..., 0]


def dequantize_shaped(codes: torch.Tensor, scale: torch.Tensor,
                      shape: Tuple[int, ...], block: int = 256
                      ) -> torch.Tensor:
    *lead, last_p = codes.shape
    nb = last_p // block
    x = codes.reshape(*lead, nb, block).float() * scale[..., None]
    return x.reshape(*lead, last_p)[..., :shape[-1]]


_V_FLOOR = 1e-24


def quantize_v_shaped(v: torch.Tensor, block: int = 256):
    """Second-moment quantization in the LOG domain: absmax-int8 on
    log(v) bounds the relative error of the Adam denominator (linear
    absmax flushes small v to 0 and the update explodes)."""
    return quantize_shaped(torch.log(v + _V_FLOOR), block)


def dequantize_v_shaped(codes: torch.Tensor, scale: torch.Tensor,
                        shape: Tuple[int, ...], block: int = 256
                        ) -> torch.Tensor:
    return torch.exp(dequantize_shaped(codes, scale, shape, block))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def _moment_shape(p: torch.Tensor) -> Tuple[int, ...]:
    return tuple(p.shape) if p.dim() else (1,)


def adam_init(params: Mapping[str, torch.Tensor], cfg: AdamConfig,
              layout: Optional["Zero1Layout"] = None) -> Dict[str, Any]:
    """Zero moments beside each parameter, on its device; with a ZeRO-1
    ``layout`` (``zero1_layout``) only the rank's shard of each (module
    docstring), float32."""
    if layout is not None:
        if cfg.use_8bit:
            raise NotImplementedError("8-bit moments on ranks are not "
                                      "ported")
        held = {k: torch.zeros(layout.shard(k, p).shape, dtype=torch.float32,
                               device=p.device)
                for k, p in params.items() if layout.holds(k)}
        return {"m": held,
                "v": {k: torch.zeros_like(t) for k, t in held.items()},
                "count": torch.zeros((), dtype=torch.int32,
                                     device=next(iter(params.values()))
                                     .device)}

    def zeros(p):
        return torch.zeros(_moment_shape(p), dtype=torch.float32,
                           device=p.device)

    dev = next(iter(params.values())).device if params else None
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.use_8bit:
        def q(z, fn):
            codes, scale = fn(z, cfg.q_block)
            return {"codes": codes, "scale": scale}
        return {"m": {k: q(zeros(p), quantize_shaped)
                      for k, p in params.items()},
                "v": {k: q(zeros(p), quantize_v_shaped)
                      for k, p in params.items()},
                "count": count}
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "count": count}


def lr_schedule(cfg: AdamConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` (float32)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Mapping[str, torch.Tensor], ranks=None,
                replicated: Collection[str] = (),
                sharded: Collection[str] = ()) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  With
    ``ranks`` the leaves are this rank's blocks: ``replicated`` names
    those whole on every rank of its ``model`` line, ``sharded`` those
    that are its ZeRO-1 shard (different along its ``data`` line; the
    others are whole along it).  Each leaf is counted once over the
    ranks that sum it, on the first rank of a line along which it is
    whole: with ``sharded`` leaves on a ``data`` axis over 1 one float32
    all-reduce over the whole grid, else one over ``model`` (where it is
    split), else none.  The same value on every rank."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros(())
    grid = (ranks is not None and bool(sharded)
            and ranks.shape.get("data", 1) > 1)
    split = ranks is not None and ranks.shape.get("model", 1) > 1
    if not grid and not split:
        return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves))
    first_model = not split or ranks.axis_index("model") == 0
    first_data = not grid or ranks.axis_index("data") == 0
    mine = sum((torch.sum(x.float() ** 2) for k, x in tree.items()
                if (first_model or k not in replicated)
                and (first_data or k in sharded)),
               torch.zeros((), device=leaves[0].device))
    return torch.sqrt(coll.all_reduce_sum(mine.reshape(1), ranks,
                                          None if grid else "model")[0])


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}, norm


def _update_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, cfg: AdamConfig, lr, c1, c2, wd) -> None:
    """One float32-moment leaf's AdamW update, in place: ``p`` (a view of
    the parameter where it is a ZeRO-1 shard), its clipped float32
    gradient ``g``, its moments ``m`` / ``v``."""
    m_new = cfg.b1 * m + (1 - cfg.b1) * g
    v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
    step_ = lr * (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
    pf = p.float()
    p.copy_(pf - step_ - wd * pf)
    m.copy_(m_new)
    v.copy_(v_new)


@torch.no_grad()
def adam_update(params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
                cfg: AdamConfig, ranks=None,
                replicated: Collection[str] = (),
                layout: Optional["Zero1Layout"] = None
                ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, Any],
                           Dict[str, torch.Tensor]]:
    """One AdamW step (global-norm clipping, bias correction, decoupled
    weight decay).  The parameters and the moments are written in place,
    leaf by leaf (so the transient memory is one leaf's, never a second
    copy of the model); ``grads`` are only read.  On ``ranks`` the
    leaves are this rank's blocks and the norm is ``global_norm``'s
    (``replicated``: the leaves whole on every rank of a ``model``
    line).  With a ZeRO-1 ``layout`` the moments and ``grads`` are the
    rank's shards (the keys ``state["m"]`` holds), and the rank's block
    of each parameter is written (module docstring).  Returns (params,
    state, metrics) with ``metrics = {"grad_norm", "lr"}``."""
    gnorm = global_norm(grads, ranks, replicated,
                        layout.sharded if layout is not None else ())
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    state["count"].add_(1)
    count = state["count"].float()
    lr = lr_schedule(cfg, count)
    c1 = 1 - cfg.b1 ** count
    c2 = 1 - cfg.b2 ** count
    wd = lr * cfg.weight_decay
    if layout is not None:
        for k in state["m"]:
            _update_leaf(layout.shard(k, params[k]), grads[k].float() * clip,
                         state["m"][k], state["v"][k], cfg, lr, c1, c2, wd)
        return params, state, {"grad_norm": gnorm, "lr": lr}
    for k, p in params.items():
        g = grads[k].float() * clip
        if cfg.use_8bit:
            m8, v8 = state["m"][k], state["v"][k]
            shape = _moment_shape(p)
            m = dequantize_shaped(m8["codes"], m8["scale"], shape,
                                  cfg.q_block).reshape(p.shape)
            v = dequantize_v_shaped(v8["codes"], v8["scale"], shape,
                                    cfg.q_block).reshape(p.shape)
        else:
            _update_leaf(p, g, state["m"][k], state["v"][k], cfg, lr, c1,
                         c2, wd)
            continue
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        step_ = lr * (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        pf = p.float()
        p.copy_(pf - step_ - wd * pf)
        for slot, new, fn in ((m8, m_new, quantize_shaped),
                              (v8, v_new, quantize_v_shaped)):
            codes, scale = fn(new.reshape(shape), cfg.q_block)
            slot["codes"].copy_(codes)
            slot["scale"].copy_(scale)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# sharding of optimizer state (ZeRO-1), as data
# ---------------------------------------------------------------------------

def zero1_specs(spec: P, shape: Tuple[int, ...], data_size: int,
                axis: str = "data") -> P:
    """Extend a param spec with ``axis`` sharding on the first free,
    divisible dim (ZeRO stage 1).  Unchanged if the spec already uses
    ``axis``."""
    def uses(e):
        return e == axis or (isinstance(e, tuple) and axis in e)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(uses(e) for e in entries):
        return P(*entries)
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % data_size == 0 and s >= data_size:
            entries[i] = axis
            return P(*entries)
    return P(*entries)


def opt_state_specs(param_specs, params_shape, cfg: AdamConfig,
                    data_size: int, zero1: bool = True) -> Dict[str, Any]:
    """The spec tree of the reference's optimizer state (``m``, ``v``,
    ``count``) for a parameter spec tree (``model.param_specs()``) and a
    tree of the same structure whose leaves have ``.shape``."""
    def mom_spec(spec, leaf):
        shape = tuple(leaf.shape)
        if cfg.use_8bit:
            shape = shape if len(shape) else (1,)
            sp = zero1_specs(spec, shape, data_size) if zero1 else \
                P(*(list(spec) + [None] * (len(shape) - len(spec))))
            entries = list(sp) + [None] * (len(shape) - len(sp))
            # codes keep the padded last dim; if padding changed it, the
            # original tiling may no longer divide: drop that entry
            last_pad = -(-shape[-1] // cfg.q_block) * cfg.q_block
            if last_pad != shape[-1] and entries[-1] is not None:
                entries[-1] = None
            return {"codes": P(*entries), "scale": P(*entries[:-1], None)}
        return zero1_specs(spec, shape, data_size) if zero1 else spec

    m = map_specs(mom_spec, param_specs, params_shape)
    return {"m": m, "v": map_specs(lambda s, _: s, m, m), "count": P()}


# ---------------------------------------------------------------------------
# ZeRO-1 on ranks: where a rank's moment shards lie
# ---------------------------------------------------------------------------

class _Shape:
    """A leaf of the tree ``opt_state_specs`` reads: its ``.shape``."""

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = tuple(shape)


def _node(tree, path):
    for part in path:
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _data_dim(spec) -> Optional[int]:
    """The dimension a moment spec splits over ``data``, or ``None``."""
    for i, e in enumerate(spec):
        if e == "data" or (isinstance(e, tuple) and "data" in e):
            return i
    return None


@dataclasses.dataclass(frozen=True)
class Zero1Leaf:
    """One leaf of the reference's parameter tree on ranks: its
    ``state_dict`` ``keys`` (a stacked group's layers in order, else the
    one key), ``dim``, the dimension of the (stacked) leaf that its
    moment spec splits over ``data`` (``None``: whole moments, gradient
    all-reduced over ``data``), and this rank's block ``[lo, hi)`` of
    it."""
    name: str
    keys: Tuple[str, ...]
    stacked: bool
    dim: Optional[int]
    lo: int
    hi: int

    def held(self, i: int, ndim: int) -> Optional[Tuple[slice, ...]]:
        """The slices of the rank's block of ``keys[i]`` (``ndim``
        dimensions) whose moments the rank holds, or ``None``."""
        whole = (slice(None),) * ndim
        if self.dim is None:
            return whole
        if self.stacked and self.dim == 0:
            return whole if self.lo <= i < self.hi else None
        d = self.dim - 1 if self.stacked else self.dim
        return whole[:d] + (slice(self.lo, self.hi),) + whole[d + 1:]


class Zero1Layout:
    """A rank's ZeRO-1 shards (module docstring): ``leaves`` in the
    reference tree's order, ``sharded`` the keys whose moments split
    over ``data``, ``holds(k)`` / ``shard(k, t)`` (the rank's shard of a
    tensor shaped as ``k``'s parameter block: a view) and ``block(k,
    p)``, the shard's slices of the whole leaf ``k`` (for
    ``launch.dryrun.whole_sample``)."""

    def __init__(self, leaves, ndims: Mapping[str, int]):
        self.leaves = list(leaves)
        self._held = {}
        for leaf in self.leaves:
            for i, k in enumerate(leaf.keys):
                self._held[k] = leaf.held(i, ndims[k])
        self.sharded = frozenset(k for leaf in self.leaves
                                 if leaf.dim is not None for k in leaf.keys)

    def holds(self, key: str) -> bool:
        return self._held[key] is not None

    def shard(self, key: str, t: torch.Tensor) -> torch.Tensor:
        return t[self._held[key]]

    def block(self, key: str, p: torch.Tensor) -> Tuple:
        """The whole-leaf slices of ``key``'s moment shard: the
        parameter block's (``p.block``) narrowed as ``shard`` narrows."""
        out = []
        for part, cut, size in zip(p.block, self._held[key], p.shape):
            lo, hi, _ = cut.indices(size)
            out.append(part[lo:hi] if not isinstance(part, slice)
                       else slice(part.start + lo, part.start + hi))
        return tuple(out)


def zero1_layout(model, cfg: AdamConfig, zero1: bool = True
                 ) -> Optional[Zero1Layout]:
    """The rank's ZeRO-1 layout of ``model`` (built with ``ranks``, a
    ``ProcessMesh`` whose ``data`` axis is over 1), or ``None`` (one
    process, or a ``data`` axis of 1: whole moments).  Each leaf's
    moment spec is ``opt_state_specs``' of the stacked leaf (the whole
    leaf's shape); ``zero1=False`` keeps every moment whole (its
    gradient all-reduced over ``data``)."""
    ranks = getattr(model, "ranks", None)
    if ranks is None or ranks.shape.get("data", 1) == 1:
        return None
    data, at = ranks.shape["data"], ranks.axis_index("data")
    params = dict(model.named_parameters())
    shapes = convert.nest_layers(
        {k: _Shape(getattr(p, "whole_shape", p.shape))
         for k, p in params.items()},
        stack=lambda layers: _Shape((len(layers),) + layers[0].shape))
    specs = opt_state_specs(model.param_specs(), shapes, cfg, data,
                            zero1)["m"]
    groups: Dict[Tuple[str, ...], list] = {}
    for k in params:
        parts = k.split(".")
        path = ((parts[0],) + tuple(parts[2:])
                if parts[0] in convert.STACKED else tuple(parts))
        groups.setdefault(path, []).append(k)
    leaves = []
    for path, keys in groups.items():
        stacked = path[0] in convert.STACKED
        if stacked:
            keys.sort(key=lambda k: int(k.split(".")[1]))
        dim = _data_dim(_node(specs, path))
        size = _node(shapes, path).shape[dim] if dim is not None else 0
        lo, hi = at * size // data, (at + 1) * size // data
        leaves.append(Zero1Leaf(".".join(path), tuple(keys), stacked, dim,
                                lo, hi))
    return Zero1Layout(leaves, {k: p.dim() for k, p in params.items()})
