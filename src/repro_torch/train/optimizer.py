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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch

from ..models.layers import P, map_specs

__all__ = ["AdamConfig", "adam_init", "adam_update", "lr_schedule",
           "global_norm", "clip_by_global_norm", "quantize_blockwise",
           "dequantize_blockwise", "quantize_shaped", "dequantize_shaped",
           "quantize_v_shaped", "dequantize_v_shaped", "zero1_specs",
           "opt_state_specs"]

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


def adam_init(params: Mapping[str, torch.Tensor], cfg: AdamConfig
              ) -> Dict[str, Any]:
    """Zero moments beside each parameter, on its device."""
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


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves))


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}, norm


@torch.no_grad()
def adam_update(params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
                cfg: AdamConfig
                ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, Any],
                           Dict[str, torch.Tensor]]:
    """One AdamW step (global-norm clipping, bias correction, decoupled
    weight decay).  The parameters and the moments are written in place,
    leaf by leaf (so the transient memory is one leaf's, never a second
    copy of the model); ``grads`` are only read.  Returns (params, state,
    metrics) with ``metrics = {"grad_norm", "lr"}``."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    state["count"].add_(1)
    count = state["count"].float()
    lr = lr_schedule(cfg, count)
    c1 = 1 - cfg.b1 ** count
    c2 = 1 - cfg.b2 ** count
    wd = lr * cfg.weight_decay
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
            m, v = state["m"][k], state["v"][k]
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        step_ = lr * (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        pf = p.float()
        p.copy_(pf - step_ - wd * pf)
        if cfg.use_8bit:
            for slot, new, fn in ((m8, m_new, quantize_shaped),
                                  (v8, v_new, quantize_v_shaped)):
                codes, scale = fn(new.reshape(shape), cfg.q_block)
                slot["codes"].copy_(codes)
                slot["scale"].copy_(scale)
        else:
            m.copy_(m_new)
            v.copy_(v_new)
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
