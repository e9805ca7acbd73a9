"""Model building blocks: norms, rotary, GQA attention, MLPs, MoE.

Counterpart of ``repro/models/layers.py``.  Conventions:

* parameters live in ``nn.Module``s whose attribute names are the keys of
  the reference's parameter dicts (``wq.w``, ``ln1.scale``, ``moe.w_up``,
  ...), so a reference pytree maps onto a ``state_dict`` key for key
  (``repro_torch.convert.lm_state_dict_from_params``).  Each module's
  ``reset(generator)`` draws its parameters as the reference's ``init_*``
  does (same distributions and scales; torch's numbers, not JAX's).
* the ``*_apply`` functions keep the reference's signatures with the
  module in place of its dict; compute dtype is the caller's (bf16),
  float32 master parameters are cast at use, and products the reference
  takes with ``preferred_element_type=float32`` are taken in float32.
* attention supports GQA (kv heads broadcast), optional qkv bias
  (qwen2), optional per-head qk RMSNorm (qwen3), sliding windows, a
  chunked online-softmax path for long sequences, and a one-token decode
  path against a KV cache, which it writes in place (the reference's
  ``dynamic_update_slice`` returns a new cache).

* every module has its ``*_specs`` twin, returning the reference's tree
  of partition specs as plain data (``P``, a tuple of axis names): on one
  card nothing is sharded, and the specs are what a process group would
  place (``distributed_lm.sharding``, ``train.optimizer.zero1_specs``).
* ``remat`` (``cfg.remat``) wraps a block in ``torch.utils.checkpoint``;
  ``remat_policy`` "dots" keeps the outputs of batch-free matmuls (the
  reference's ``dots_with_no_batch_dims_saveable``).  Both change memory,
  never values.

``sharding_mesh(pm)`` is the reference's ``sharding_mesh``: it threads a
rank's ``ProcessMesh`` into the layers, which then run that rank's share
of a tensor-parallel step (``distributed_lm.sharding.to_rank_widths``
gives a model its blocks).  There, ``dense_apply`` sums a row-split
weight's partial product over ``model`` (``sum_partials``: the partials
cross in float32 and the sum is rounded once to the compute dtype, as
one process rounds its whole product once; bf16 partials summed in bf16
over four ranks round three more times, which parts a bf16 run from the
reference past ``_BF16_TOL`` and flips near-tied router choices),
``attention_apply`` attends with the rank's own query and KV heads, and
``attention_decode`` runs against the rank's slots of a cache whose
sequence is split over ``model``: every head's new q / k / v gathered
over ``model``, the new K/V written by the rank whose slots hold ``pos``,
the softmax combined across the ranks exactly from the all-reduced max
and sum, the weighted values summed, then the rank's heads through its
row-split ``wo``; against a cache whole on every rank (the hybrid's
rolling window, written whole by every rank from the gathered new K/V;
Whisper's cross cache, read only) it attends with the rank's query
heads and the KV heads they read.  Where the axis does not split the
KV heads (fewer than the axis, as the hybrid's one), a rank's column
block of ``wk`` / ``wv`` is part of one head: the new k and v are
all-gathered over ``model`` and the rank keeps the heads its query
heads read (``gathers_kv``, ``_qkv``, ``_rank_kv_heads``).
``moe_apply`` routes every token on every rank (the router is
replicated and reads the all-reduced
residual, so a ``model`` line computes the same experts and gates;
``Tally.route`` keeps their digests), then runs the experts by the
layout of ``moe_specs``: FFN-split
(``"ffn"``) dispatches every expert densely on the rank's slice of the
expert hidden dimension and all-reduces the gated partial sum over
``model``; expert-parallel (``"model"``, or ``"model+data"`` where the
ranks' ``data`` axis is 1: a rank holds ``n_experts / k`` whole experts)
takes the rank's ``ceil(t / k)`` tokens, sends each (token, slot) row to
the rank of its expert and back (``collectives.all_to_all_over``), gates
the returned rows and all-gathers the slices over ``model``.  The
reference's ``constrain`` has nothing to constrain here; ``gqa_repeat``
keeps its numerics (K/V broadcast to every head) and ``act_shard`` is
inert.

A training backward on ranks (a ``dense``, ``moe`` or ``vlm``
transformer; ``train.train_step``) takes its collectives from autograd
``Function``s that keep their mesh in ``ctx``, since the card's
autograd engine runs them on its own thread: the row-split sums and the
embedding's pass the gradient through (``_SumOver``); each column-split
group's input goes through ``enter_split``, whose backward sums the
ranks' partial input gradients over ``model`` in float32 with a status
word beside them (the FFN-split experts' tokens and gates as one panel,
``enter_split_panel``: the router's gradient, from the gates and the
load-balancing loss, is whole on every rank already); the vocab-split
loss is ``cross_entropy_vocab_split``; ``remat`` re-enters the ranks'
mesh for the recompute.  The expert-parallel exchange is three
``Function``s: ``_EnterRows`` cuts the rank's token rows and gates and
all-gathers their gradients; ``_ExpertExchange`` runs the dispatch, the
expert rows and the return, and in the backward the reverse exchanges
around the rows' vector-Jacobian product (``_expert_rows_vjp``), which
a failing rank still joins; ``_GatherRows`` all-gathers the gated rows
and hands each rank its own rows' gradient back.  With the batch split
over ``data`` a training step's load-balancing loss reads the whole
microbatch's expert density (one all-reduce over ``data``).  The raw
gathers, the all-to-all and a sequence-split decode have no backward
and refuse autograd (``collectives.no_backward``; A10d-5b-3b).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from ..core import collectives as coll
from .common import ArchConfig

__all__ = [
    "P", "RMSNorm", "rms_norm", "rms_specs", "rope_cos_sin", "apply_rope",
    "sinusoidal_positions", "Dense", "dense_apply", "dense_specs",
    "Attention", "attention_specs", "attention_apply", "attention_decode",
    "MLP", "mlp_apply", "mlp_specs", "MoE", "moe_apply", "moe_specs",
    "cross_entropy_loss", "remat_policy", "remat", "stacked_specs",
    "map_specs",
    "linear_scan", "causal_conv", "torch_dtype", "sharding_mesh",
    "current_mesh", "draw", "sum_partials", "enter_split", "Fused",
    "embed_vocab_split", "gather_kv", "gathers_kv",
    "cross_entropy_vocab_split", "partial_grad", "HEAD_NORMS",
    "enter_split_panel",
]


class P(tuple):
    """A partition spec as plain data: one entry per array dimension, an
    axis name, a tuple of names, or ``None`` (not split), as
    ``jax.sharding.PartitionSpec(...)`` (which also writes a one-name
    tuple as the name); ``tuple(spec)`` compares with the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


class Fused(str):
    """A spec entry naming one axis over a dimension that fuses ``parts``
    equal parts side by side (Mamba's ``in_proj`` output ``[xs | z]``).
    It equals the axis name as a string, so ``tuple(spec)`` compares with
    the reference's and the bytes a device holds are counted as for a
    plain entry; but a rank's block is its block of each part, side by
    side (``distributed_lm.sharding.block_slices``), where a contiguous
    block would hold one part only and a step that halves the fused
    output would need an exchange to split it."""

    def __new__(cls, axis: str, parts: int):
        out = super().__new__(cls, axis)
        out.parts = int(parts)
        return out

    def __getnewargs__(self):
        return str(self), self.parts


def map_specs(fn, specs, other):
    """``fn(spec, leaf)`` over a spec tree (nested dicts / lists of
    ``P``) and a tree of the same structure; an empty list (a hybrid
    without a tail) has no leaves, so ``other`` may lack it."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, other[k] if v != [] else [])
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, s, x) for s, x in zip(specs, other)]
    return fn(specs, other)


def stacked_specs(tree):
    """``tree`` (nested dicts / lists of ``P``) with a leading unsplit
    layer axis on every spec, as the reference's ``P(None, *s)`` over a
    block's specs."""
    if isinstance(tree, dict):
        return {k: stacked_specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [stacked_specs(v) for v in tree]
    return P(None, *tree)


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) as a torch
    dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# ranks: the threaded mesh, and a rank's blocks drawn from whole leaves
# ---------------------------------------------------------------------------

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_mesh", default=None)


@contextlib.contextmanager
def sharding_mesh(mesh):
    """Makes ``mesh`` (a rank's ``ProcessMesh``, or ``None``: one process)
    the layers' mesh inside the block (module docstring)."""
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def current_mesh():
    """The mesh ``sharding_mesh`` threads, or ``None``."""
    return _MESH.get()


def _split_model(mesh) -> bool:
    """Whether ``mesh`` (the threaded mesh, or ``None``) splits ``model``."""
    return mesh is not None and mesh.shape.get("model", 1) > 1


@torch.no_grad()
def draw(p: torch.Tensor, fill: Callable[[torch.Tensor], object]) -> None:
    """``fill(t)`` sets a leaf in place.  On a rank's block (a parameter
    with ``whole_shape`` and ``block``: ``distributed_lm.sharding.
    to_rank_widths``) the whole leaf is drawn by the same ``fill`` on the
    block's device, its block kept and the rest freed, so the rank gets
    exactly the values a one-process model draws from the same
    generator."""
    block = getattr(p, "block", None)
    if block is None:
        fill(p)
        return
    whole = torch.empty(p.whole_shape, dtype=p.dtype, device=p.device)
    fill(whole)
    # a fused dimension's block is an index array (sharding.block_slices)
    p.copy_(whole[tuple(torch.as_tensor(s, device=p.device)
                        if isinstance(s, np.ndarray) else s
                        for s in block)])
    del whole


class _SumOver(torch.autograd.Function):
    """Forward: the sum of ``y`` over ``axis`` (one ``collectives.
    all_reduce_sum``; with ``f32`` taken in float32 and rounded once to
    ``y``'s dtype).  Backward: the identity, since the incoming gradient
    of a sum that every rank holds whole is already whole on every
    rank."""

    @staticmethod
    def forward(ctx, y, mesh, axis, f32):
        if f32:
            return coll.all_reduce_sum(y.float(), mesh, axis).to(y.dtype)
        return coll.all_reduce_sum(y, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def _rank_part(g: torch.Tensor) -> torch.Tensor:
    """A rank's share of an entry's backward sum: its partial gradient in
    float32."""
    return g.float()


class _EnterSplit(torch.autograd.Function):
    """Forward: the identity on each of ``xs``.  Backward: the sum over
    ``axis`` of the ranks' partial gradients of them all, as one float32
    panel rounded once to each gradient's dtype, with a status word
    beside it (``collectives.all_reduce_sum_checked``): a rank whose
    share fails still joins, and every rank raises.  The mesh rides in
    ``ctx``: the backward may run on another thread (the autograd
    engine's device thread), where no ``sharding_mesh`` is set."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        part, error = None, None
        try:
            part = torch.cat([_rank_part(g).reshape(-1) for g in gs])
        except Exception as exc:             # every rank must hear of it
            error = exc
        total = coll.all_reduce_sum_checked(
            part, (sum(g.numel() for g in gs),), ctx.mesh, ctx.axis,
            "the backward", error)
        outs, at = [], 0
        for g in gs:
            outs.append(total[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        return (None, None, *outs)


def sum_partials(y: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' partial products ``y`` (one
    ``collectives.all_reduce_sum``), taken in float32 and rounded once to
    ``y``'s dtype.  Its backward is the identity (``_SumOver``)."""
    return _SumOver.apply(y, mesh, axis, True)


def enter_split(x: torch.Tensor, mesh, axis: str = "model"
                ) -> torch.Tensor:
    """``x`` as the input of a group of denses split over ``axis`` by
    their output columns (attention's ``wq`` / ``wk`` / ``wv``, the MLP's
    gate / up, the vocab-split head): the identity forward; in the
    backward the ranks' partial input gradients are summed over ``axis``
    (``_EnterSplit``), once for the group.  ``x`` itself outside
    autograd or where ``mesh`` does not split ``axis``."""
    return enter_split_panel((x,), mesh, axis)[0]


def enter_split_panel(xs, mesh, axis: str = "model") -> Tuple:
    """``enter_split`` of several inputs of one split group at once (the
    FFN-split experts' tokens and gates): their partial gradients cross
    as one float32 panel with one status word."""
    if mesh is None or mesh.shape.get(axis, 1) == 1 \
            or not torch.is_grad_enabled():
        return tuple(xs)
    return _EnterSplit.apply(mesh, axis, *xs)


def embed_vocab_split(embed: torch.Tensor, tokens: torch.Tensor,
                      dtype: torch.dtype, mesh) -> torch.Tensor:
    """``tokens``' rows of an embedding in ``dtype``; on a rank (``mesh``
    splitting ``model``) ``embed`` is its block of vocab rows: the others'
    tokens give zeros, then one all-reduce sum over ``model`` (exact in
    any dtype: one rank holds each token's row).  Its backward is the
    identity: the rank's rows take the gradient of the tokens in its
    range, with no collective."""
    if not _split_model(mesh):
        return embed[tokens.long()].to(dtype)
    rows = embed.shape[0]
    ids = tokens.long() - mesh.axis_index("model") * rows
    inside = (ids >= 0) & (ids < rows)
    x = torch.where(inside[..., None],
                    embed[ids.clamp(0, rows - 1)].to(dtype),
                    torch.zeros((), dtype=dtype, device=ids.device))
    return _SumOver.apply(x, mesh, "model", False)


def _f32_einsum(spec: str, a: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """``einsum`` with float32 products and sums, as JAX's
    ``preferred_element_type=float32``."""
    return torch.einsum(spec, a.float(), b.float())


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """``{"scale": ones(d)}``."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)


def rms_specs() -> Dict:
    return {"scale": P(None)}


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * p.scale.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary / sinusoidal positions
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, hd: int, theta: float,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...,] -> cos/sin [..., hd/2]."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd]; cos/sin [..., S, hd/2] (broadcast over heads)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style sinusoidal embedding: positions [...,] -> float32
    [..., d], sines then cosines."""
    dim = torch.arange(d // 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    ang = positions[..., None].float() / (10000 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# dense projection
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """``{"w": [d_in, d_out], "b": [d_out]?}``; ``w`` is drawn N(0, 1) x
    ``scale`` (default 1/sqrt(d_in)), ``b`` is zeros.  ``reduce_over``
    names the axis over which a rank's partial product is summed (a
    row-split block), else ``None``."""

    reduce_over: Optional[str] = None

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 scale: Optional[float] = None, *, device=None):
        super().__init__()
        self.init_scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
        self.w = nn.Parameter(torch.empty((d_in, d_out), device=device))
        if bias:
            self.b = nn.Parameter(torch.zeros((d_out,), device=device))

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        draw(self.w, lambda t: t.normal_(generator=generator).mul_(
            self.init_scale))
        if hasattr(self, "b"):
            self.b.zero_()


def dense_specs(spec_in, spec_out, bias: bool = False) -> Dict:
    p = {"w": P(spec_in, spec_out)}
    if bias:
        p["b"] = P(spec_out)
    return p


def dense_apply(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.reduce_over is not None:
        mesh = current_mesh()
        if mesh is None:
            raise RuntimeError("a row-split Dense block runs only inside "
                               "sharding_mesh(its ranks)")
        y = sum_partials(y, mesh, p.reduce_over)
    if hasattr(p, "b"):
        y = y + p.b.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (``Dense``) and, with ``qk_norm``,
    ``q_norm`` / ``k_norm`` over one head's width."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        self.wq = Dense(d, cfg.n_heads * hd, cfg.qkv_bias, device=device)
        self.wk = Dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias, device=device)
        self.wv = Dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias, device=device)
        self.wo = Dense(cfg.n_heads * hd, d, False, device=device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device=device)
            self.k_norm = RMSNorm(hd, device=device)

    def reset(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset(generator)


def attention_specs(cfg: ArchConfig) -> Dict:
    p = {
        "wq": dense_specs(None, "model", cfg.qkv_bias),
        "wk": dense_specs(None, "model", cfg.qkv_bias),
        "wv": dense_specs(None, "model", cfg.qkv_bias),
        "wo": dense_specs("model", None, False),
    }
    if cfg.qk_norm:
        p["q_norm"] = rms_specs()
        p["k_norm"] = rms_specs()
    return p


# replicated leaves that a rank applies to its own heads only: on ranks
# that split the heads over model, a rank's gradient of one is its part
# of the sum over the heads (``partial_grad``)
HEAD_NORMS = ("q_norm", "k_norm")


def partial_grad(name) -> bool:
    """Whether the replicated leaf ``name`` (a ``state_dict`` key, or the
    path of keys into a spec tree) has, on a rank that splits ``model``,
    a partial gradient that the ranks sum over ``model`` (the qk norms,
    ``HEAD_NORMS``)."""
    parts = name.split(".") if isinstance(name, str) else name
    return any(part in HEAD_NORMS for part in parts)


def _rank_kv_heads(cfg: ArchConfig, mesh) -> Tuple[int, int]:
    """The KV heads ``[lo, hi)`` that this rank's query heads (block ``r``
    of ``n_heads / k`` over ``model``) read: its own block where the axis
    splits the KV heads, else the one head whose group holds its query
    heads.  Raises where the query heads would straddle KV groups."""
    k, r = mesh.shape["model"], mesh.axis_index("model")
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hq, n_rep = h // k, h // kv
    lo, hi = r * hq // n_rep, ((r + 1) * hq - 1) // n_rep + 1
    if hq % (hi - lo) or h % k:
        raise NotImplementedError(
            f"{h} query heads over a model axis of {k} straddle the groups "
            f"of {kv} KV heads")
    return lo, hi


def gathers_kv(cfg: ArchConfig, k: int, whole_kv: bool) -> bool:
    """Whether attention on a ``model`` axis of ``k`` all-gathers the new
    k and v over it (``gather_kv``): where the axis does not split the KV
    heads (a rank's column block of ``wk`` / ``wv`` is part of one head),
    or ``whole_kv`` asks for every KV head (a cache whole on every rank).
    ``_qkv`` runs by it and the dry-run's closed form counts by it."""
    return k > 1 and bool(whole_kv or cfg.n_kv_heads % k)


def gather_kv(k: torch.Tensor, v: torch.Tensor, mesh
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's column block of the new k and v ``[..., w]``, gathered
    over ``model`` as one panel ``[k | v]``: the whole ``[..., k_ax w]``
    (every KV head) of each."""
    k_ax, w = mesh.shape["model"], k.shape[-1]
    kv = coll.all_gather_panel(torch.cat([k, v], dim=-1), mesh, "model",
                               dim=k.dim() - 1)
    kv = kv.reshape(*k.shape[:-1], k_ax, 2, w)
    return (kv[..., 0, :].reshape(*k.shape[:-1], k_ax * w),
            kv[..., 1, :].reshape(*k.shape[:-1], k_ax * w))


def _project_q(p: Attention, cfg: ArchConfig, x: torch.Tensor,
               positions: Optional[torch.Tensor], use_rope: bool
               ) -> torch.Tensor:
    """The query heads this model holds, normed and rotated."""
    b, s = x.shape[:2]
    q = dense_apply(p.wq, x).reshape(b, s, -1, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(p.q_norm, q, cfg.norm_eps)
    if use_rope:
        cos, sin = rope_cos_sin(_positions(positions, s, x.device), cfg.hd,
                                cfg.rope_theta, x.dtype)
        q = apply_rope(q, cos, sin)
    return q


def _positions(positions: Optional[torch.Tensor], s: int, device
               ) -> torch.Tensor:
    return (positions if positions is not None
            else torch.arange(s, device=device)[None, :])


def _qkv(p: Attention, cfg: ArchConfig, x: torch.Tensor,
         kv_x: Optional[torch.Tensor], positions: Optional[torch.Tensor],
         use_rope: bool, whole_kv: bool = False):
    """q, k, v of the heads this model holds: all of them, or on ranks
    the rank's query heads and the KV heads they read, the new k and v
    all-gathered over ``model`` first where ``gathers_kv`` says."""
    b = x.shape[0]
    hd = cfg.hd
    mesh = current_mesh()
    # the inputs of the column-split wq / wk / wv: their partial input
    # gradients are summed once here in a backward
    x = enter_split(x, mesh)
    src = x if kv_x is None else enter_split(kv_x, mesh)
    s_kv = src.shape[1]
    q = _project_q(p, cfg, x, positions, use_rope)
    k = dense_apply(p.wk, src)
    v = dense_apply(p.wv, src)
    if _split_model(mesh) and gathers_kv(cfg, mesh.shape["model"],
                                         whole_kv):
        k, v = gather_kv(k, v, mesh)
        if not whole_kv:
            lo, hi = _rank_kv_heads(cfg, mesh)
            k, v = k[..., lo * hd:hi * hd], v[..., lo * hd:hi * hd]
    k = k.reshape(b, s_kv, -1, hd)
    v = v.reshape(b, s_kv, -1, hd)
    if cfg.qk_norm:
        k = rms_norm(p.k_norm, k, cfg.norm_eps)
    if use_rope:
        cos, sin = rope_cos_sin(_positions(positions, x.shape[1], x.device),
                                hd, cfg.rope_theta, x.dtype)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], n_rep: int) -> torch.Tensor:
    """q [b,sq,h,hd], k/v [b,sk,kv,hd]; GQA via reshape to groups.
    Scores and softmax in float32; mask is additive (0 / -inf),
    [b, sq, sk]."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, n_rep, hd)
    scores = _f32_einsum("bqkrh,bskh->bkrqs", qg, k) / np.sqrt(hd)
    if mask is not None:
        scores = scores + mask[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", w, v)
    return out.reshape(b, sq, h, hd)


# q chunks that share one product in _sdpa_chunked: the transient score
# block is [b, kv, r, Q_CHUNKS_PER_STEP, cq, ck] float32, whatever the
# sequence length
Q_CHUNKS_PER_STEP = 4


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_rep: int, *, causal: bool, window: int, chunk_q: int,
                  chunk_k: int) -> torch.Tensor:
    """Flash-style online-softmax attention, double-chunked over q and kv
    (the reference's ``lax.map`` over q chunks and ``lax.scan`` over kv
    chunks become two loops).  The outer loop takes the q chunks
    ``Q_CHUNKS_PER_STEP`` at a time, so the transient score block stays
    at most [b, kv, r, Q_CHUNKS_PER_STEP, cq, ck] float32 whatever the
    sequence length; each query row goes through the operations of a
    loop over single q chunks in the same order (a batched product may
    round its float32 sums apart from the per-chunk one).

    Each kv block updates only the chunks of the group that may see some
    of it.  A chunk that sees none of a block would keep its running max
    ``m``, sum ``l`` and output ``acc`` bit for bit as they were: its
    scores are all ``-inf``, its weights ``exp(-inf) = 0`` and its
    correction ``exp(0) = 1`` (or, before any visible block,
    ``exp(-inf) = 0`` on a state still zero)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if sq % chunk_q or sk % chunk_k:
        raise ValueError(f"sequence lengths {sq}, {sk} do not split into "
                         f"chunks of {chunk_q}, {chunk_k}")
    nq, nk = sq // chunk_q, sk // chunk_k
    qs = q.reshape(b, nq, chunk_q, kv, n_rep, hd).permute(0, 3, 4, 1, 2, 5)
    ks = k.reshape(b, nk, chunk_k, kv, hd).permute(1, 0, 3, 2, 4)
    vs = v.reshape(b, nk, chunk_k, kv, hd).permute(1, 0, 3, 2, 4)
    scale = 1.0 / np.sqrt(hd)
    dev = q.device
    qpos = torch.arange(sq, device=dev).reshape(nq, chunk_q, 1)
    outs = []
    for q0 in range(0, nq, Q_CHUNKS_PER_STEP):
        q1 = min(nq, q0 + Q_CHUNKS_PER_STEP)
        shape = (b, kv, n_rep, q1 - q0, chunk_q)
        m = torch.full(shape, -math.inf, device=dev)
        l = torch.zeros(shape, device=dev)
        acc = torch.zeros(shape + (hd,), device=dev)
        for ki in range(nk):
            k_lo, k_hi = ki * chunk_k, (ki + 1) * chunk_k - 1
            # the group's q chunks [lo, hi) may see some of this block
            lo = max(q0, k_lo // chunk_q) if causal else q0
            hi = (min(q1, -(-(k_hi + window) // chunk_q)) if window
                  else q1)
            if lo >= hi:
                continue
            kblk, vblk = ks[ki], vs[ki]              # [b, kv, ck, hd]
            s_ = _f32_einsum("bkrnqh,bksh->bkrnqs", qs[:, :, :, lo:hi],
                             kblk) * scale
            if causal or window:
                kpos = k_lo + torch.arange(chunk_k, device=dev)
                ok = torch.ones((hi - lo, chunk_q, chunk_k),
                                dtype=torch.bool, device=dev)
                if causal:
                    ok &= kpos <= qpos[lo:hi]
                if window:
                    ok &= kpos > qpos[lo:hi] - window
                s_ = torch.where(ok, s_, -math.inf)
            part = slice(lo - q0, hi - q0)
            m_old = m[:, :, :, part]
            m_new = torch.maximum(m_old, s_.amax(dim=-1))
            # a fully masked prefix leaves m_new = -inf; a finite stand-in
            # makes every exp() 0 (and m = -inf means l = acc = 0)
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p_ = torch.exp(s_ - m_safe[..., None])
            corr = torch.exp(m_old - m_safe)
            l_new = l[:, :, :, part] * corr + p_.sum(dim=-1)
            acc_new = acc[:, :, :, part] * corr[..., None] + _f32_einsum(
                "bkrnqs,bksh->bkrnqh", p_.to(vblk.dtype), vblk)
            if (lo, hi) == (q0, q1):
                m, l, acc = m_new, l_new, acc_new
            else:                 # functional: autograd keeps the old state
                m, l, acc = (torch.cat([t[:, :, :, :lo - q0], new,
                                        t[:, :, :, hi - q0:]], dim=3)
                             for t, new in ((m, m_new), (l, l_new),
                                            (acc, acc_new)))
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=3)                 # [b, kv, r, nq, cq, hd]
    return out.permute(0, 3, 4, 1, 2, 5).reshape(b, sq, h, hd)


def attention_apply(p: Attention, cfg: ArchConfig, x: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_x: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None,
                    use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  ``kv_x`` switches to
    cross-attention (no mask, no rope on cross keys).  Long sequences
    route to the chunked online-softmax path."""
    b, s = x.shape[:2]
    cross = kv_x is not None
    q, k, v = _qkv(p, cfg, x, kv_x, positions, use_rope and not cross)
    n_rep = q.shape[2] // k.shape[2]            # cfg.n_heads // n_kv_heads
    if cfg.gqa_repeat and n_rep > 1:
        # K/V broadcast to every head (the reference's layout knob)
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
        n_rep = 1
    sk = k.shape[1]
    chunk = cfg.attn_chunk
    if not cross and chunk and s > chunk and s % chunk == 0 \
            and sk % chunk == 0:
        out = _sdpa_chunked(q, k, v, n_rep, causal=causal, window=window,
                            chunk_q=chunk, chunk_k=chunk)
    else:
        mask = None
        if not cross and causal:
            qi = torch.arange(s, device=x.device)[:, None]
            ki = torch.arange(sk, device=x.device)[None, :]
            ok = ki <= qi
            if window:
                ok &= ki > qi - window
            mask = torch.zeros(ok.shape, device=x.device).masked_fill(
                ~ok, -math.inf)[None].expand(b, s, sk)
        out = _sdpa(q, k, v, mask, n_rep)
    return dense_apply(p.wo, out.reshape(b, s, -1))


def attention_decode(p: Attention, cfg: ArchConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos,
                     *, window: int = 0, use_rope: bool = True,
                     update_cache: bool = True, slot=None,
                     causal_mask: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x [b, 1, d]; cache [b, S, kv, hd]; ``pos`` an
    int (or 0-d tensor).  Returns (out [b, 1, d], cache_k, cache_v).

    The new K/V is written into ``cache_k`` / ``cache_v`` in place, at
    ``slot`` (a rolling-window cache: ``pos % S``) or else at ``pos``,
    and the same tensors are returned: the reference returns new caches
    (``dynamic_update_slice``), which a loop over steps would copy whole.
    RoPE uses the absolute ``pos``.  ``update_cache=False`` (a static
    cross-attention cache) writes nothing and projects the query alone.

    Inside ``sharding_mesh`` with a ``model`` axis over 1 a written cache
    without ``slot`` is the rank's slots (``_decode_on_ranks``).  Any
    other cache is whole on every rank: the rank attends with its query
    heads against the KV heads they read (``_rank_kv_heads``), then its
    row-split ``wo`` sums over ``model``.  Into a rolling window every
    rank writes the whole new K/V, all-gathered over ``model``
    (``_qkv(whole_kv=True)``), so the copies stay identical."""
    b = x.shape[0]
    pos = int(pos)
    mesh = current_mesh()
    split = _split_model(mesh)
    if split and update_cache and slot is None:
        if window or not causal_mask:
            raise NotImplementedError(
                "decode on ranks against a sequence-split cache runs causal "
                "self-attention without a window only")
        return _decode_on_ranks(p, cfg, x, cache_k, cache_v, pos, mesh,
                                use_rope)
    positions = (torch.tensor([[pos]], device=x.device) if use_rope
                 else None)
    if update_cache:
        q, k, v = _qkv(p, cfg, x, None, positions, use_rope,
                       whole_kv=slot is not None)
        write_at = pos if slot is None else int(slot)
        cache_k[:, write_at] = k[:, 0].to(cache_k.dtype)
        cache_v[:, write_at] = v[:, 0].to(cache_v.dtype)
    else:
        q = _project_q(p, cfg, x, positions, use_rope)
    lo, hi = _rank_kv_heads(cfg, mesh) if split else (0, cfg.n_kv_heads)
    sk = cache_k.shape[1]
    ki = torch.arange(sk, device=x.device)[None, :]
    ok = (ki <= pos) if causal_mask else torch.ones(
        (1, sk), dtype=torch.bool, device=x.device)
    if window and slot is None and causal_mask:
        ok &= ki > pos - window
    mask = torch.zeros(ok.shape, device=x.device).masked_fill(
        ~ok, -math.inf)[:, None, :].expand(b, 1, sk)
    out = _sdpa(q, cache_k[:, :, lo:hi].to(x.dtype),
                cache_v[:, :, lo:hi].to(x.dtype), mask,
                q.shape[2] // (hi - lo))
    return dense_apply(p.wo, out.reshape(b, 1, -1)), cache_k, cache_v


def _decode_on_ranks(p: Attention, cfg: ArchConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     mesh, use_rope: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``attention_decode`` on a rank: its blocks of ``wq`` / ``wk`` /
    ``wv`` (column-split heads) and ``wo`` (row-split), and its slots
    ``[r * S_r, (r + 1) * S_r)`` of the cache (``cache_k`` / ``cache_v``
    [b, S_r, kv, hd], every KV head), ``r`` its ``model`` coordinate.
    The collectives, over ``model``: one all-gather of the new q, k and v
    (every head), an all-reduce max of the scores' rows ``[b, h]`` and an
    all-reduce sum of their exponentials ``[b, h]`` (float32), an
    all-reduce sum of the weighted values ``[b, h, hd]`` (``sum_partials``,
    float32), and ``wo``'s.
    The softmax is the reference's exactly (``exp(s - max) / sum``, then
    cast to the compute dtype before the values), over every rank's
    slots; a rank whose slots all lie past ``pos`` contributes zeros
    (its scores are ``-inf`` against the finite global max).  RoPE at
    ``pos`` where ``use_rope`` (Whisper's decoder has none)."""
    b, hd, axis = x.shape[0], cfg.hd, "model"
    coll.no_backward(x, "decode against a sequence-split cache")
    k_ax, r = mesh.shape[axis], mesh.axis_index(axis)
    q, k, v = _qkv(p, cfg, x, None,
                   torch.tensor([[pos]], device=x.device) if use_rope
                   else None, use_rope)
    hq, hk = q.shape[2], k.shape[2]
    qkv = coll.all_gather_panel(torch.cat([q, k, v], dim=2), mesh, axis,
                                dim=2).reshape(b, 1, k_ax, hq + 2 * hk, hd)
    q = qkv[:, :, :, :hq].reshape(b, 1, k_ax * hq, hd)
    k = qkv[:, :, :, hq:hq + hk].reshape(b, 1, k_ax * hk, hd)
    v = qkv[:, :, :, hq + hk:].reshape(b, 1, k_ax * hk, hd)
    slots = cache_k.shape[1]
    lo = r * slots
    if lo <= pos < lo + slots:
        cache_k[:, pos - lo] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos - lo] = v[:, 0].to(cache_v.dtype)
    kv = cache_k.shape[2]
    n_rep = q.shape[2] // kv
    qg = q.reshape(b, 1, kv, n_rep, hd)
    scores = _f32_einsum("bqkrh,bskh->bkrqs", qg,
                         cache_k.to(x.dtype)) / np.sqrt(hd)
    seen = lo + torch.arange(slots, device=x.device) <= pos
    scores = scores.masked_fill(~seen, -math.inf)
    top = coll.all_reduce_max(scores.amax(dim=-1), mesh, axis)
    e = torch.exp(scores - top[..., None])
    total = coll.all_reduce_sum(e.sum(dim=-1), mesh, axis)
    w = (e / total[..., None]).to(q.dtype)
    part = torch.einsum("bkrqs,bskh->bqkrh", w, cache_v.to(x.dtype))
    out = sum_partials(part, mesh, axis).reshape(b, 1, kv * n_rep, hd)
    mine = out[:, :, r * hq:(r + 1) * hq].reshape(b, 1, hq * hd)
    return dense_apply(p.wo, mine), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``gate``, ``up``, ``down``) or GELU (``fc1``, ``fc2`` with
    biases)."""

    def __init__(self, d: int, f: int, kind: str = "swiglu", *,
                 device=None):
        super().__init__()
        if kind == "swiglu":
            self.gate = Dense(d, f, device=device)
            self.up = Dense(d, f, device=device)
            self.down = Dense(f, d, device=device)
        else:
            self.fc1 = Dense(d, f, bias=True, device=device)
            self.fc2 = Dense(f, d, bias=True, device=device)

    def reset(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset(generator)


def mlp_specs(kind: str = "swiglu") -> Dict:
    if kind == "swiglu":
        return {"gate": dense_specs(None, "model"),
                "up": dense_specs(None, "model"),
                "down": dense_specs("model", None)}
    return {"fc1": dense_specs(None, "model", bias=True),
            "fc2": dense_specs("model", None, bias=True)}


def mlp_apply(p: MLP, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    # the input of the column-split gate / up (fc1)
    x = enter_split(x, current_mesh())
    if kind == "swiglu":
        return dense_apply(p.down, F.silu(dense_apply(p.gate, x))
                           * dense_apply(p.up, x))
    # jax.nn.gelu defaults to the tanh approximation
    return dense_apply(p.fc2, F.gelu(dense_apply(p.fc1, x),
                                     approximate="tanh"))


# ---------------------------------------------------------------------------
# MoE (top-k routing, one-hot dispatch / combine einsums)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """``router`` (``Dense`` d -> E), expert weights ``w_gate`` / ``w_up``
    [E, d, f] and ``w_down`` [E, f, d], and optionally ``shared`` (the
    shared experts as one SwiGLU of width n_shared·f) and ``dense`` (a
    parallel dense SwiGLU)."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.d, self.f = d, f
        self.router = Dense(d, e, scale=1.0 / np.sqrt(d), device=device)
        self.w_gate = nn.Parameter(torch.empty((e, d, f), device=device))
        self.w_up = nn.Parameter(torch.empty((e, d, f), device=device))
        self.w_down = nn.Parameter(torch.empty((e, f, d), device=device))
        if cfg.n_shared_experts:
            self.shared = MLP(d, cfg.n_shared_experts * f, device=device)
        if cfg.dense_residual:
            self.dense = MLP(d, cfg.d_ff, device=device)

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        self.router.reset(generator)
        draw(self.w_gate, lambda t: t.normal_(generator=generator).mul_(
            1.0 / np.sqrt(self.d)))
        draw(self.w_up, lambda t: t.normal_(generator=generator).mul_(
            1.0 / np.sqrt(self.d)))
        draw(self.w_down, lambda t: t.normal_(generator=generator).div_(
            np.sqrt(self.f)))
        for name in ("shared", "dense"):
            if hasattr(self, name):
                getattr(self, name).reset(generator)


def moe_specs(cfg: ArchConfig) -> Dict:
    if cfg.expert_sharding == "model":
        es = es_d = P("model", None, None)
    elif cfg.expert_sharding == "model+data":
        es, es_d = P("model", None, "data"), P("model", "data", None)
    else:                                  # "ffn": replicate experts
        es, es_d = P(None, None, "model"), P(None, "model", None)
    p = {"router": dense_specs(None, None),
         "w_gate": es, "w_up": es, "w_down": es_d}
    if cfg.n_shared_experts:
        p["shared"] = mlp_specs()
    if cfg.dense_residual:
        p["dense"] = mlp_specs()
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: rows of zeros where ``idx`` is outside [0, n)
    (``F.one_hot`` raises there instead)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_apply(p: MoE, cfg: ArchConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing with one-hot dispatch einsums.  Two
    dispatch modes, as the reference's:

    * dense (default): expert inputs are [E, t, d] — exact;
    * capacity (``cfg.moe_capacity``): Switch-style [E, cap, d] with
      cap = ⌈top_k·t·capacity_factor/E⌉; overflow tokens drop.

    Inside ``sharding_mesh`` with a ``model`` axis over 1 the experts
    run split (module docstring; ``_experts_on_ranks``).  Returns (out,
    aux_loss)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    logits = dense_apply(p.router, xt.float())                  # [t, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, cfg.top_k, dim=-1)       # [t, k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    onehot = _one_hot(idx, cfg.n_experts, x.dtype)              # [t, k, E]

    # aux load-balancing loss (Switch-style)
    density = (onehot.sum(1) > 0).float().mean(0)               # [E]
    density_proxy = probs.mean(0)
    mesh = current_mesh()
    if mesh is not None and mesh.shape.get("data", 1) > 1 \
            and torch.is_grad_enabled():
        # a training step's batch split over data: the density of the
        # whole microbatch (it has no gradient); the proxy stays the
        # rank's, whose mean over data (the step's) is the whole one's
        density = coll.all_reduce_sum(density, mesh, "data") \
            / mesh.shape["data"]
    aux = (density * density_proxy).sum() * (cfg.n_experts ** 2) \
        * cfg.router_aux_weight / cfg.top_k

    if mesh is not None and mesh.shape.get("model", 1) > 1:
        mesh.tally.route(idx, gate_vals)
        out = _experts_on_ranks(p, cfg, xt, idx, gate_vals, onehot, mesh)
    elif cfg.moe_capacity:
        w_gate, w_up = p.w_gate.to(x.dtype), p.w_up.to(x.dtype)
        w_down = p.w_down.to(x.dtype)
        cap = max(int(np.ceil(cfg.top_k * t * cfg.capacity_factor
                              / cfg.n_experts)), 1)
        flat = onehot.reshape(t * cfg.top_k, cfg.n_experts)     # slot-major
        pos = torch.cumsum(flat, dim=0) - flat                  # arrival idx
        pos = (pos * flat).sum(-1).reshape(t, cfg.top_k)        # [t, k]
        keep = (pos < cap).to(x.dtype)
        pos_oh = _one_hot(pos, cap, x.dtype)                    # [t, k, cap]
        disp = onehot[..., None] * pos_oh[:, :, None, :] \
            * keep[..., None, None]                             # [t,k,E,cap]
        comb = disp * gate_vals[..., None, None].to(x.dtype)
        xin = torch.einsum("tkec,td->ecd", disp, xt)            # [E, cap, d]
        hg = F.silu(torch.einsum("ecd,edf->ecf", xin, w_gate))
        hu = torch.einsum("ecd,edf->ecf", xin, w_up)
        ye = torch.einsum("ecf,efd->ecd", hg * hu, w_down)
        out = torch.einsum("tkec,ecd->td", comb, ye)
    else:
        out = _dense_dispatch(p, xt, gate_vals, onehot)

    if hasattr(p, "shared"):
        out = out + mlp_apply(p.shared, xt)
    if hasattr(p, "dense"):
        out = out + mlp_apply(p.dense, xt)
    return out.reshape(b, s, d), aux.float()


def _dense_dispatch(p: MoE, xt: torch.Tensor, gate_vals: torch.Tensor,
                    onehot: torch.Tensor) -> torch.Tensor:
    """The dense dispatch: every expert on every token ([E, t, d]
    inputs), combined with the gates into ``[t, d]``."""
    dt = xt.dtype
    combine = (onehot * gate_vals[..., None].to(dt)).sum(1)    # [t, E]
    dispatch = (onehot.sum(1) > 0).to(dt)
    xin = torch.einsum("te,td->etd", dispatch, xt)
    hg = F.silu(torch.einsum("etd,edf->etf", xin, p.w_gate.to(dt)))
    hu = torch.einsum("etd,edf->etf", xin, p.w_up.to(dt))
    ye = torch.einsum("etf,efd->etd", hg * hu, p.w_down.to(dt))
    return torch.einsum("etd,te->td", ye, combine)


def _experts_on_ranks(p: MoE, cfg: ArchConfig, xt: torch.Tensor,
                      idx: torch.Tensor, gate_vals: torch.Tensor,
                      onehot: torch.Tensor, mesh) -> torch.Tensor:
    """The routed experts' ``[t, d]`` output on a rank whose blocks of
    ``w_gate`` / ``w_up`` / ``w_down`` ``to_rank_widths`` cut by
    ``moe_specs``: FFN-split (the rank's ``moe_d_ff / k`` hidden slice
    of every expert) or expert-parallel (the rank's ``n_experts / k``
    whole experts).  The collectives are over ``model`` (module
    docstring)."""
    e, f = cfg.n_experts, cfg.moe_d_ff
    k = mesh.shape["model"]
    held_e, _, held_f = p.w_gate.shape
    if cfg.moe_capacity:
        raise NotImplementedError("capacity dispatch on ranks (arrival "
                                  "order over every token) is not ported")
    if (held_e, held_f) == (e, f // k) and f % k == 0:
        # the gated sum over the rank's f / k hidden units only; a
        # backward sums the tokens' and the gates' partial gradients
        # where they enter (the router's is whole on every rank already)
        xs, gates = enter_split_panel((xt, gate_vals), mesh)
        part = _dense_dispatch(p, xs, gates, onehot)
        return sum_partials(part, mesh, "model")
    if (held_e, held_f) == (e // k, f) and e % k == 0:
        return _expert_parallel(p, cfg, xt, idx, gate_vals, mesh)
    raise NotImplementedError(
        f"expert blocks [{held_e}, *, {held_f}] of [{e}, *, {f}] over a "
        f"model axis of {k}: neither the FFN split nor whole experts a "
        f"rank")


def _expert_rows(p: MoE, rows: torch.Tensor, experts: torch.Tensor
                 ) -> torch.Tensor:
    """Each row of ``rows`` through the rank's expert ``experts[i]`` (its
    local index): the SwiGLU of the dense dispatch, on the rows an
    expert received only (none is a normal case)."""
    out = torch.zeros_like(rows)
    for j in torch.unique(experts).tolist():
        sel = torch.nonzero(experts == j).squeeze(1)
        xr = rows[sel]
        h = F.silu(xr @ p.w_gate[j].to(rows.dtype)) \
            * (xr @ p.w_up[j].to(rows.dtype))
        out[sel] = h @ p.w_down[j].to(rows.dtype)
    return out


def _expert_rows_vjp(p: MoE, rows: torch.Tensor, experts: torch.Tensor,
                     g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The vector-Jacobian product of ``_expert_rows`` at ``rows`` with
    ``g``: the gradients of the rows and of the rank's ``w_gate`` /
    ``w_up`` / ``w_down`` (float32), the rows' SwiGLU recomputed under
    autograd.  Experts that received no row take zeros."""
    weights = (p.w_gate, p.w_up, p.w_down)
    with torch.enable_grad():
        x = rows.detach().requires_grad_()
        out = _expert_rows(p, x, experts)
        grads = ((None,) * 4 if not out.requires_grad else
                 torch.autograd.grad(out, (x,) + weights, g,
                                     allow_unused=True))
    return tuple(torch.zeros_like(t) if d is None else d
                 for t, d in zip((x,) + weights, grads))


class _EnterRows(torch.autograd.Function):
    """Forward: the rows ``[lo, hi)`` of the tokens ``xt`` and of their
    gates (copies).  Backward: each rank holds the gradient of its own
    rows only; the line's rows cross as one float32 panel ``[c, d +
    top_k]`` a rank (padded to ``c`` rows), all-gathered over ``axis``
    into the whole ``[t, ...]`` gradients of both."""

    @staticmethod
    def forward(ctx, xt, gates, mesh, axis, lo, hi, c):
        ctx.mesh, ctx.axis, ctx.span, ctx.c = mesh, axis, (lo, hi), c
        ctx.t = xt.shape[0]
        return xt[lo:hi].clone(), gates[lo:hi].clone()

    @staticmethod
    def backward(ctx, gx, gg):
        lo, hi = ctx.span
        d = gx.shape[1]
        panel = torch.zeros((ctx.c, d + gg.shape[1]), dtype=torch.float32,
                            device=gx.device)
        panel[:hi - lo] = torch.cat([gx.float(), gg.float()], dim=1)
        whole = coll.all_gather_panel(panel, ctx.mesh, ctx.axis,
                                      dim=0)[:ctx.t]
        return (whole[:, :d].to(gx.dtype), whole[:, d:].to(gg.dtype),
                None, None, None, None, None)


class _ExpertExchange(torch.autograd.Function):
    """Forward: the (token, slot) ``rows`` out to their experts' ranks
    (``collectives.all_to_all_over``), the rows received through the
    rank's experts (``_expert_rows``), and the results back, in the
    order the rows left.  A rank whose expert step fails still joins the
    return exchange, and every rank raises.  Backward: the reverse
    exchanges, send and receive counts swapped: the returned rows'
    gradients out to the experts' ranks, the expert rows' vector-Jacobian
    product (``_expert_rows_vjp``; the rank's expert weights take their
    gradients), the rows' gradients back; a rank whose product fails
    still joins the last exchange, and every rank raises.  The mesh, the
    counts and the module ride in ``ctx``; ``w_gate`` / ``w_up`` /
    ``w_down`` are the module's, passed so that autograd routes their
    gradients."""

    @staticmethod
    def forward(ctx, rows, w_gate, w_up, w_down, p, mesh, axis, send,
                recv, experts):
        got = coll.all_to_all_over(rows, mesh, axis, send, recv,
                                   what="the expert dispatch")
        error, done = None, None
        try:
            done = _expert_rows(p, got, experts)
        except Exception as exc:        # every rank must hear of it
            error = exc
        back = coll.all_to_all_over(done, mesh, axis, recv, send,
                                    error=error, what="the expert step")
        ctx.save_for_backward(got, experts)
        ctx.p, ctx.mesh, ctx.axis, ctx.counts = p, mesh, axis, (send, recv)
        return back

    @staticmethod
    def backward(ctx, g):
        got, experts = ctx.saved_tensors
        send, recv = ctx.counts
        g_done = coll.all_to_all_over(g.contiguous(), ctx.mesh, ctx.axis,
                                      send, recv,
                                      what="the expert backward's dispatch")
        error, grads = None, (None,) * 4
        try:
            grads = _expert_rows_vjp(ctx.p, got, experts, g_done)
        except Exception as exc:        # every rank must hear of it
            error = exc
        g_rows = coll.all_to_all_over(grads[0], ctx.mesh, ctx.axis, recv,
                                      send, error=error,
                                      what="the expert backward")
        return (g_rows, *grads[1:]) + (None,) * 6


class _GatherRows(torch.autograd.Function):
    """Forward: each rank's ``[hi - lo, d]`` rows, padded to ``c``,
    all-gathered over ``axis`` into the whole ``[t, d]``.  Backward: the
    rank's own rows of the incoming gradient, with no exchange: the
    output feeds the residual stream, whose gradient is whole on every
    rank (``_SumOver``)."""

    @staticmethod
    def forward(ctx, mine, mesh, axis, lo, c, t):
        ctx.span = (lo, lo + mine.shape[0])
        pad = torch.zeros((c, mine.shape[1]), dtype=mine.dtype,
                          device=mine.device)
        pad[:mine.shape[0]] = mine
        return coll.all_gather_panel(pad, mesh, axis, dim=0)[:t]

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.span
        return g[lo:hi], None, None, None, None, None


def _expert_parallel(p: MoE, cfg: ArchConfig, xt: torch.Tensor,
                     idx: torch.Tensor, gate_vals: torch.Tensor,
                     mesh) -> torch.Tensor:
    """Expert-parallel dispatch by token on a rank holding experts
    ``[r * E / k, (r + 1) * E / k)``: its ``ceil(t / k)`` tokens'
    (token, slot) rows, sorted by destination rank, go to their experts'
    ranks by one ``all_to_all_over`` and come back by another; every
    rank derives what it receives from the routing the line shares.
    The rows it receives run through its experts (``_expert_rows``); a
    rank whose expert step fails still joins the return exchange, so
    every rank raises (``_ExpertExchange``).  The returned rows are
    gated and summed a token, and the slices all-gathered over ``model``
    (padded to ``ceil(t / k)`` rows a rank) back to the replicated
    ``[t, d]`` (``_GatherRows``).  A backward gathers the rank's rows'
    token and gate gradients over ``model`` where they were cut
    (``_EnterRows``) and runs the exchanges in reverse."""
    t, d = xt.shape
    k, r = mesh.shape["model"], mesh.axis_index("model")
    top = cfg.top_k
    local = cfg.n_experts // k
    c = -(-t // k)
    owner = idx // local                                    # [t, top]
    lo, hi = min(r * c, t), min((r + 1) * c, t)
    dest = owner[lo:hi].reshape(-1)                         # token-major
    order = torch.argsort(dest, stable=True)
    send_counts = torch.bincount(dest, minlength=k).tolist()
    # what each coordinate j sends this rank: its slice's rows bound here
    recv_counts, experts = [], []
    for j in range(k):
        mine = idx[min(j * c, t):min((j + 1) * c, t)].reshape(-1)
        bound = mine[mine // local == r] - r * local
        recv_counts.append(int(bound.numel()))
        experts.append(bound)
    xs, gates = _EnterRows.apply(xt, gate_vals, mesh, "model", lo, hi, c)
    rows = xs.repeat_interleave(top, dim=0)[order]
    back = _ExpertExchange.apply(rows, p.w_gate, p.w_up, p.w_down, p, mesh,
                                 "model", send_counts, recv_counts,
                                 torch.cat(experts))
    ys = back[torch.argsort(order)].reshape(hi - lo, top, d)  # token-major
    mine = torch.einsum("tkd,tk->td", ys, gates.to(xt.dtype))
    return _GatherRows.apply(mine, mesh, "model", lo, c, t)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab: int) -> torch.Tensor:
    """Mean next-token CE.  The gold logit is gathered in float32 (the
    reference's one-hot contraction picks the same value exactly)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


class _VocabSplitCE(torch.autograd.Function):
    """``cross_entropy_vocab_split``: the forward's three float32 ``[t]``
    all-reduces over ``axis``, a local backward."""

    @staticmethod
    def forward(ctx, logits, labels, mesh, axis):
        lf = logits.float()
        width = lf.shape[-1]
        top = coll.all_reduce_max(lf.amax(dim=-1), mesh, axis)
        total = coll.all_reduce_sum(torch.exp(lf - top[..., None]).sum(
            dim=-1), mesh, axis)
        ids = labels.long() - mesh.axis_index(axis) * width
        inside = (ids >= 0) & (ids < width)
        ids = ids.clamp(0, width - 1)
        mine = torch.where(inside, lf.gather(-1, ids[..., None])[..., 0],
                           torch.zeros((), device=lf.device))
        gold = coll.all_reduce_sum(mine, mesh, axis)
        ctx.save_for_backward(logits, top, total, ids, inside)
        return (torch.log(total) + top - gold).mean()

    @staticmethod
    def backward(ctx, g):
        logits, top, total, ids, inside = ctx.saved_tensors
        soft = torch.exp(logits.float() - top[..., None]) / total[..., None]
        soft.scatter_add_(-1, ids[..., None],
                          -inside[..., None].to(soft.dtype))
        return (soft * (g / top.numel())).to(logits.dtype), None, None, None


def cross_entropy_vocab_split(logits: torch.Tensor, labels: torch.Tensor,
                              mesh, axis: str = "model") -> torch.Tensor:
    """``cross_entropy_loss`` of logits whose vocab is split over
    ``axis``: ``logits`` ``[..., V / k]`` is this rank's block (vocab
    rows ``[r V / k, (r + 1) V / k)``), ``labels`` the whole ids.  Three
    float32 ``[t]`` all-reduces over ``axis`` give the row's max, the sum
    of its exponentials and the label's logit (its owner's value, zeros
    elsewhere), so every rank holds the whole loss.  The backward is
    local: ``(softmax_block - onehot_block) / t``."""
    return _VocabSplitCE.apply(logits, labels, mesh, axis)


# ---------------------------------------------------------------------------
# recurrences (Mamba, RG-LRU)
# ---------------------------------------------------------------------------

def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along ``dim`` of the pairs ``(a_t, b_t)`` under
    ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``: returns (the running
    products of ``a``, the states ``h_t = a_t h_{t-1} + b_t`` from
    ``h_{-1} = 0``).  The reference's ``lax.associative_scan`` of the same
    pairs, written as ceil(log2 n) doubling steps of tensor ops
    (Hillis-Steele): 8 steps over a 256 chunk.  Products only, never a
    ``cumsum`` of logs (``exp`` of a long sum of ``dt * A`` overflows)."""
    n = a.shape[dim]
    d = 1
    while d < n:
        a_lo, b_lo = a.narrow(dim, 0, n - d), b.narrow(dim, 0, n - d)
        a_hi, b_hi = a.narrow(dim, d, n - d), b.narrow(dim, d, n - d)
        b = torch.cat([b.narrow(dim, 0, d), b_lo * a_hi + b_hi], dim)
        a = torch.cat([a.narrow(dim, 0, d), a_lo * a_hi], dim)
        d *= 2
    return a, b


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d.  x [B, S, C]; w [K, C].  ``state`` is the
    trailing K-1 inputs of the previous segment (decode path)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(k))
    return out + b.to(x.dtype)


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------

# matmuls without batch dimensions (dense projections: ``x @ w`` lowers to
# ``mm`` / ``addmm``); attention's einsums lower to ``bmm`` and are redone
_BATCH_FREE_MATMULS = frozenset([torch.ops.aten.mm.default,
                                 torch.ops.aten.addmm.default])


def _save_batch_free_matmuls(ctx, op, *args, **kwargs):
    if op in _BATCH_FREE_MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(cfg: ArchConfig) -> Optional[Callable]:
    """``cfg.remat_policy`` as a selective-checkpoint policy: "dots"
    saves the outputs of batch-free matmuls, anything else (``"full"``)
    saves nothing (``None``: plain ``checkpoint``)."""
    if cfg.remat_policy == "dots":
        return _save_batch_free_matmuls
    return None


def remat(fn: Callable, cfg: ArchConfig) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) with
    ``remat_policy(cfg)`` when ``cfg.remat`` is set and autograd is
    recording; ``fn`` itself otherwise.  Values are the same either way.
    The recompute re-enters the ``sharding_mesh`` the forward ran in: it
    runs inside the backward, where the context is not the forward's
    (and on the card on the autograd engine's own thread).  On ranks that
    split ``model`` the recompute runs the whole block, its last
    row-split sum too (no early stop), so a rank's collectives are the
    dry-run's closed form's: each row-split dense sums once in the
    forward, once in the recompute and once in the backward."""
    if not cfg.remat:
        return fn
    policy = remat_policy(cfg)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        mesh = current_mesh()

        def in_mesh(*a, **kw):
            with sharding_mesh(mesh):
                return fn(*a, **kw)
        extra = {} if policy is None else dict(context_fn=functools.partial(
            create_selective_checkpoint_contexts, policy))
        with set_checkpoint_early_stop(not _split_model(mesh)):
            return checkpoint(in_mesh, *args, use_reentrant=False,
                              **extra, **kwargs)
    return wrapped
