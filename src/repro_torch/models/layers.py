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

The reference's ``sharding_mesh`` / ``constrain`` have nothing to
constrain without a process group and are not here; ``gqa_repeat`` keeps
its numerics (K/V broadcast to every head) and ``act_shard`` is inert.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .common import ArchConfig

__all__ = [
    "P", "RMSNorm", "rms_norm", "rms_specs", "rope_cos_sin", "apply_rope",
    "sinusoidal_positions", "Dense", "dense_apply", "dense_specs",
    "Attention", "attention_specs", "attention_apply", "attention_decode",
    "MLP", "mlp_apply", "mlp_specs", "MoE", "moe_apply", "moe_specs",
    "cross_entropy_loss", "remat_policy", "remat", "stacked_specs",
    "map_specs",
    "linear_scan", "causal_conv", "torch_dtype",
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
    ``scale`` (default 1/sqrt(d_in)), ``b`` is zeros."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 scale: Optional[float] = None, *, device=None):
        super().__init__()
        self.init_scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
        self.w = nn.Parameter(torch.empty((d_in, d_out), device=device))
        if bias:
            self.b = nn.Parameter(torch.zeros((d_out,), device=device))

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        self.w.normal_(generator=generator).mul_(self.init_scale)
        if hasattr(self, "b"):
            self.b.zero_()


def dense_specs(spec_in, spec_out, bias: bool = False) -> Dict:
    p = {"w": P(spec_in, spec_out)}
    if bias:
        p["b"] = P(spec_out)
    return p


def dense_apply(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
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


def _qkv(p: Attention, cfg: ArchConfig, x: torch.Tensor,
         kv_x: Optional[torch.Tensor], positions: Optional[torch.Tensor],
         use_rope: bool):
    b, s = x.shape[:2]
    hd = cfg.hd
    src = x if kv_x is None else kv_x
    q = dense_apply(p.wq, x).reshape(b, s, cfg.n_heads, hd)
    k = dense_apply(p.wk, src).reshape(b, src.shape[1], cfg.n_kv_heads, hd)
    v = dense_apply(p.wv, src).reshape(b, src.shape[1], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(p.q_norm, q, cfg.norm_eps)
        k = rms_norm(p.k_norm, k, cfg.norm_eps)
    if use_rope:
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device)[None, :])
        cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta, x.dtype)
        q = apply_rope(q, cos, sin)
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


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_rep: int, *, causal: bool, window: int, chunk_q: int,
                  chunk_k: int) -> torch.Tensor:
    """Flash-style online-softmax attention, double-chunked over q and kv
    (the reference's ``lax.map`` over q chunks and ``lax.scan`` over kv
    chunks become two loops).  The transient score block stays
    [b, kv, r, cq, ck] float32 whatever the sequence length."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if sq % chunk_q or sk % chunk_k:
        raise ValueError(f"sequence lengths {sq}, {sk} do not split into "
                         f"chunks of {chunk_q}, {chunk_k}")
    nq, nk = sq // chunk_q, sk // chunk_k
    qs = q.reshape(b, nq, chunk_q, kv, n_rep, hd).permute(1, 0, 3, 4, 2, 5)
    ks = k.reshape(b, nk, chunk_k, kv, hd).permute(1, 0, 3, 2, 4)
    vs = v.reshape(b, nk, chunk_k, kv, hd).permute(1, 0, 3, 2, 4)
    scale = 1.0 / np.sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = qs[qi]                                # [b, kv, r, cq, hd]
        m = torch.full((b, kv, n_rep, chunk_q), -math.inf, device=dev)
        l = torch.zeros((b, kv, n_rep, chunk_q), device=dev)
        acc = torch.zeros((b, kv, n_rep, chunk_q, hd), device=dev)
        qpos = qi * chunk_q + torch.arange(chunk_q, device=dev)[:, None]
        for ki in range(nk):
            kblk, vblk = ks[ki], vs[ki]              # [b, kv, ck, hd]
            s_ = _f32_einsum("bkrqh,bksh->bkrqs", qblk, kblk) * scale
            kpos = ki * chunk_k + torch.arange(chunk_k, device=dev)[None, :]
            ok = torch.ones((chunk_q, chunk_k), dtype=torch.bool, device=dev)
            if causal:
                ok &= kpos <= qpos
            if window:
                ok &= kpos > qpos - window
            s_ = torch.where(ok, s_, -math.inf)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            # a fully masked prefix leaves m_new = -inf; a finite stand-in
            # makes every exp() 0 (and m = -inf means l = acc = 0)
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p_ = torch.exp(s_ - m_safe[..., None])
            corr = torch.exp(m - m_safe)
            l = l * corr + p_.sum(dim=-1)
            acc = acc * corr[..., None] + _f32_einsum(
                "bkrqs,bksh->bkrqh", p_.to(vblk.dtype), vblk)
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.stack(outs)                          # [nq, b, kv, r, cq, hd]
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hd)


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
    n_rep = cfg.n_heads // cfg.n_kv_heads
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
    return dense_apply(p.wo, out.reshape(b, s, cfg.n_heads * cfg.hd))


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
    cross-attention cache) writes nothing."""
    b = x.shape[0]
    pos = int(pos)
    q, k, v = _qkv(p, cfg, x, None,
                   torch.tensor([[pos]], device=x.device) if use_rope
                   else None, use_rope)
    write_at = pos if slot is None else int(slot)
    if update_cache:
        cache_k[:, write_at] = k[:, 0].to(cache_k.dtype)
        cache_v[:, write_at] = v[:, 0].to(cache_v.dtype)
    sk = cache_k.shape[1]
    ki = torch.arange(sk, device=x.device)[None, :]
    ok = (ki <= pos) if causal_mask else torch.ones(
        (1, sk), dtype=torch.bool, device=x.device)
    if window and slot is None and causal_mask:
        ok &= ki > pos - window
    mask = torch.zeros(ok.shape, device=x.device).masked_fill(
        ~ok, -math.inf)[:, None, :].expand(b, 1, sk)
    out = _sdpa(q, cache_k.to(x.dtype), cache_v.to(x.dtype), mask,
                cfg.n_heads // cfg.n_kv_heads)
    return (dense_apply(p.wo, out.reshape(b, 1, cfg.n_heads * cfg.hd)),
            cache_k, cache_v)


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
        self.w_gate.normal_(generator=generator).mul_(1.0 / np.sqrt(self.d))
        self.w_up.normal_(generator=generator).mul_(1.0 / np.sqrt(self.d))
        self.w_down.normal_(generator=generator).div_(np.sqrt(self.f))
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

    Returns (out, aux_loss)."""
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
    aux = (density * density_proxy).sum() * (cfg.n_experts ** 2) \
        * cfg.router_aux_weight / cfg.top_k

    w_gate, w_up = p.w_gate.to(x.dtype), p.w_up.to(x.dtype)
    w_down = p.w_down.to(x.dtype)
    if cfg.moe_capacity:
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
        combine = (onehot * gate_vals[..., None].to(x.dtype)).sum(1)
        dispatch = (onehot.sum(1) > 0).to(x.dtype)              # [t, E]
        xin = torch.einsum("te,td->etd", dispatch, xt)
        hg = F.silu(torch.einsum("etd,edf->etf", xin, w_gate))
        hu = torch.einsum("etd,edf->etf", xin, w_up)
        ye = torch.einsum("etf,efd->etd", hg * hu, w_down)
        out = torch.einsum("etd,te->td", ye, combine)

    if hasattr(p, "shared"):
        out = out + mlp_apply(p.shared, xt)
    if hasattr(p, "dense"):
        out = out + mlp_apply(p.dense, xt)
    return out.reshape(b, s, d), aux.float()


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
    recording; ``fn`` itself otherwise.  Values are the same either way."""
    if not cfg.remat:
        return fn
    policy = remat_policy(cfg)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        if policy is None:
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts, policy),
                          **kwargs)
    return wrapped
