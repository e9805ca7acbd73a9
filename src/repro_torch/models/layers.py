"""Model building blocks: norms, rotary, GQA attention, MLPs, MoE.

Counterpart of ``repro/models/layers.py`` for what ``TransformerLM``
needs.  Conventions:

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

The reference's sharding helpers (``sharding_mesh``, ``constrain`` and
the ``*_specs`` functions) have no meaning without a process group and
are not here; ``gqa_repeat`` keeps its numerics (K/V broadcast to every
head) and ``act_shard`` has nothing to constrain.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import ArchConfig

__all__ = [
    "RMSNorm", "rms_norm", "rope_cos_sin", "apply_rope", "Dense",
    "dense_apply", "Attention", "attention_apply", "attention_decode",
    "MLP", "mlp_apply", "MoE", "moe_apply", "cross_entropy_loss",
    "torch_dtype",
]


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


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * p.scale.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary positions
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
