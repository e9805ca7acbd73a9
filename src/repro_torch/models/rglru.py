"""RecurrentGemma / Griffin hybrid (recurrentgemma-2b): RG-LRU recurrent
blocks + local sliding-window MQA, pattern (rec, rec, attn) repeating.

Counterpart of ``repro/models/rglru.py``.  The RG-LRU recurrence
h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t) is diagonal and linear, so
the whole sequence is one scan of the (a, gated input) pairs
(``layers.linear_scan``, log-step tensor ops in place of the reference's
``lax.associative_scan``); an initial state is added after the scan, as
the reference adds it.

Layers: ``n_layers // 3`` groups of (rec, rec, attn), each sublayer
followed by an MLP, under ``groups.<i>.`` (the reference stacks them on
a leading axis), then the trailing rec blocks under ``tail.<i>.`` (a list
in the reference too).  The decode cache holds each rec block's conv
window and state, written in place, and a rolling K/V window of
``min(window, max_seq)`` slots: position ``pos`` lands in slot
``pos % w``.

Built with ``ranks`` (a ``ProcessMesh`` whose ``model`` axis splits the
model), the model is one rank's share of a tensor-parallel one, as
``TransformerLM``'s.  A rec block's ``in_x``, ``in_gate``, conv and
``lam`` are channel-split (``d_rnn / k`` channels a rank, and so are the
decode's ``conv*`` / ``h*`` states); ``w_a`` / ``w_i`` are column-split
over a whole ``d_rnn`` contraction, so the rank's conv output is
all-gathered over ``model`` once before the two gates; ``out`` and
every MLP's ``down`` are row-split and sum over ``model``.  The local
attention runs the rank's query heads; its one KV head (fewer than the
axis) comes from the gathered new k / v, and the decode's window stays
whole and identical on every rank (``layers.attention_decode``).  The
vocab-split embedding all-reduces; the tied head leaves the logits
vocab-split.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import collectives as coll
from ..device import DeviceLike, resolve_device
from . import layers as L
from .common import ArchConfig

__all__ = ["GriffinLM"]

Cache = Dict[str, torch.Tensor]

_C = 8.0   # RG-LRU recurrence sharpness constant (Griffin paper)


# ---------------------------------------------------------------------------
# RG-LRU temporal block
# ---------------------------------------------------------------------------

class RecBlock(nn.Module):
    """``ln``, ``in_x`` / ``in_gate`` (d -> d_rnn), ``conv_w`` [4, d_rnn],
    ``conv_b``, ``w_a`` / ``w_i`` (d_rnn -> d_rnn, bias), ``lam`` (4.0:
    sigmoid(4) ≈ .982 decay), ``out`` (d_rnn -> d)."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        d, dr = cfg.d_model, cfg.drnn
        self.ln = L.RMSNorm(d, device=device)
        self.in_x = L.Dense(d, dr, device=device)
        self.in_gate = L.Dense(d, dr, device=device)
        self.conv_w = nn.Parameter(torch.empty((4, dr), device=device))
        self.conv_b = nn.Parameter(torch.zeros((dr,), device=device))
        self.w_a = L.Dense(dr, dr, bias=True, device=device)
        self.w_i = L.Dense(dr, dr, bias=True, device=device)
        self.lam = nn.Parameter(torch.full((dr,), 4.0, device=device))
        self.out = L.Dense(dr, d, device=device)

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        for mod in (self.ln, self.in_x, self.in_gate, self.w_a, self.w_i,
                    self.out):
            mod.reset(generator)
        L.draw(self.conv_w, lambda t: t.normal_(generator=generator).mul_(
            0.1))
        self.conv_b.zero_()
        self.lam.fill_(4.0)


def _rec_specs(cfg: ArchConfig) -> Dict:
    return {
        "ln": L.rms_specs(),
        "in_x": L.dense_specs(None, "model"),
        "in_gate": L.dense_specs(None, "model"),
        "conv_w": L.P(None, "model"),
        "conv_b": L.P("model"),
        "w_a": L.dense_specs(None, "model", bias=True),
        "w_i": L.dense_specs(None, "model", bias=True),
        "lam": L.P("model"),
        "out": L.dense_specs("model", None),
    }


def _gates(p: RecBlock, xs: torch.Tensor):
    """(log a, i) float32 of the RG-LRU from its conv output; on ranks
    the rank's channels of each, from the conv output all-gathered over
    ``model`` (``w_a`` / ``w_i`` contract over all of ``d_rnn``)."""
    mesh = L.current_mesh()
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        xs = coll.all_gather_panel(xs, mesh, "model", dim=xs.dim() - 1)
    r = torch.sigmoid(L.dense_apply(p.w_a, xs).float())
    i = torch.sigmoid(L.dense_apply(p.w_i, xs).float())
    # F.softplus returns x itself past 20, jax.nn.softplus does not (a
    # difference under 2e-9); lam starts at 4
    log_a = -_C * r * F.softplus(p.lam.float())
    return log_a, i


def _rglru(p: RecBlock, xs: torch.Tensor, h0: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs [B, S, dr] -> (ys, h_last).  float32 recurrence."""
    log_a, i = _gates(p, xs)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * xs.float())
    a_acc, h = L.linear_scan(a, gated, dim=1)
    if h0 is not None:
        h = h + a_acc * h0[:, None].float()
    return h.to(xs.dtype), h[:, -1]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _rec_apply(p: RecBlock, cfg: ArchConfig, x: torch.Tensor
               ) -> torch.Tensor:
    res = x
    x = L.rms_norm(p.ln, x, cfg.norm_eps)
    gate = _gelu(L.dense_apply(p.in_gate, x))
    xs = L.causal_conv(L.dense_apply(p.in_x, x), p.conv_w, p.conv_b)
    ys, _ = _rglru(p, xs)
    return res + L.dense_apply(p.out, ys * gate)


def _rec_decode(p: RecBlock, cfg: ArchConfig, x: torch.Tensor,
                conv_state: torch.Tensor, h_state: torch.Tensor
                ) -> torch.Tensor:
    """One step; ``conv_state`` [B, 3, dr] and ``h_state`` [B, dr]
    (float32) advance in place."""
    res = x
    x = L.rms_norm(p.ln, x, cfg.norm_eps)
    gate = _gelu(L.dense_apply(p.in_gate, x))
    xin = L.dense_apply(p.in_x, x)
    xs = L.causal_conv(xin, p.conv_w, p.conv_b, state=conv_state)
    conv_state.copy_(torch.cat([conv_state[:, 1:],
                                xin.to(conv_state.dtype)], dim=1))
    log_a, i = _gates(p, xs)
    a = torch.exp(log_a)[:, 0]
    gated = (torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
             * (i[:, 0] * xs[:, 0].float()))
    h = a * h_state.float() + gated
    h_state.copy_(h)
    ys = h[:, None].to(xs.dtype)
    return res + L.dense_apply(p.out, ys * gate)


# ---------------------------------------------------------------------------
# group = (rec, rec, attn), each followed by an MLP
# ---------------------------------------------------------------------------

class Group(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.rec1 = RecBlock(cfg, device=device)
        self.mlp1 = L.MLP(d, cfg.d_ff, device=device)
        self.ln_m1 = L.RMSNorm(d, device=device)
        self.rec2 = RecBlock(cfg, device=device)
        self.mlp2 = L.MLP(d, cfg.d_ff, device=device)
        self.ln_m2 = L.RMSNorm(d, device=device)
        self.ln_a = L.RMSNorm(d, device=device)
        self.attn = L.Attention(cfg, device=device)
        self.mlp3 = L.MLP(d, cfg.d_ff, device=device)
        self.ln_m3 = L.RMSNorm(d, device=device)

    def reset(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset(generator)


class Tail(nn.Module):
    """A trailing rec block and its MLP: ``rec``, ``mlp``, ``ln_m``."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        self.rec = RecBlock(cfg, device=device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, device=device)
        self.ln_m = L.RMSNorm(cfg.d_model, device=device)

    def reset(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset(generator)


def _group_specs(cfg: ArchConfig) -> Dict:
    return {
        "rec1": _rec_specs(cfg), "mlp1": L.mlp_specs(),
        "ln_m1": L.rms_specs(),
        "rec2": _rec_specs(cfg), "mlp2": L.mlp_specs(),
        "ln_m2": L.rms_specs(),
        "ln_a": L.rms_specs(), "attn": L.attention_specs(cfg),
        "mlp3": L.mlp_specs(), "ln_m3": L.rms_specs(),
    }


def _mlp_res(p: L.MLP, ln: L.RMSNorm, cfg: ArchConfig, x: torch.Tensor
             ) -> torch.Tensor:
    return x + L.mlp_apply(p, L.rms_norm(ln, x, cfg.norm_eps))


def _group_apply(p: Group, cfg: ArchConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    x = _rec_apply(p.rec1, cfg, x)
    x = _mlp_res(p.mlp1, p.ln_m1, cfg, x)
    x = _rec_apply(p.rec2, cfg, x)
    x = _mlp_res(p.mlp2, p.ln_m2, cfg, x)
    x = x + L.attention_apply(p.attn, cfg,
                              L.rms_norm(p.ln_a, x, cfg.norm_eps),
                              causal=True, window=cfg.window)
    return _mlp_res(p.mlp3, p.ln_m3, cfg, x)


class GriffinLM(nn.Module):
    """recurrentgemma-2b: 26 layers = 8 x (rec, rec, attn) + (rec, rec),
    tied head.  Built on ``device`` (``None`` means ``"cuda"``) with its
    parameters unset: ``init(generator)`` draws them.  With ``ranks`` (a
    ``ProcessMesh``) it holds this rank's blocks (module docstring)."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None,
                 ranks=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.ranks = ranks
        whole_dev = dev
        if ranks is not None:
            dev = torch.device("meta")
        self.n_groups = cfg.n_layers // 3
        self.n_tail = cfg.n_layers - 3 * self.n_groups
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              device=dev))
        self.ln_f = L.RMSNorm(cfg.d_model, device=dev)
        self.groups = nn.ModuleList(Group(cfg, device=dev)
                                    for _ in range(self.n_groups))
        self.tail = nn.ModuleList(Tail(cfg, device=dev)
                                  for _ in range(self.n_tail))
        if ranks is not None:
            from ..distributed_lm.sharding import to_rank_widths
            to_rank_widths(self, ranks, whole_dev)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "GriffinLM":
        """Draws every parameter from ``generator`` with the reference's
        distributions."""
        L.draw(self.embed, lambda t: t.normal_(generator=generator).mul_(
            0.02))
        self.ln_f.reset(generator)
        for mod in list(self.groups) + list(self.tail):
            mod.reset(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_specs(self) -> Dict:
        cfg = self.cfg
        tail = [{"rec": _rec_specs(cfg), "mlp": L.mlp_specs(),
                 "ln_m": L.rms_specs()} for _ in range(self.n_tail)]
        return {"embed": L.P("model", None), "ln_f": L.rms_specs(),
                "groups": L.stacked_specs(_group_specs(cfg)), "tail": tail}

    def apply(self, tokens: torch.Tensor, patch_embeds=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits [B, S, V], aux_loss = 0); on ranks the logits are the
        rank's vocab block."""
        with L.sharding_mesh(self.ranks):
            return self._apply(tokens)

    def _apply(self, tokens: torch.Tensor):
        cfg = self.cfg
        x = L.embed_vocab_split(self.embed, tokens,
                                L.torch_dtype(cfg.compute_dtype), self.ranks)
        group = L.remat(_group_apply, cfg)
        for gp in self.groups:
            x = group(gp, cfg, x)
        for tp in self.tail:
            x = _rec_apply(tp.rec, cfg, x)
            x = _mlp_res(tp.mlp, tp.ln_m, cfg, x)
        x = L.rms_norm(self.ln_f, x, cfg.norm_eps)
        # gemma-style tied head
        return (x @ self.embed.to(x.dtype).T,
                torch.zeros((), dtype=torch.float32, device=x.device))

    forward = apply

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, aux = self.apply(batch["tokens"])
        return L.cross_entropy_loss(logits, batch["labels"],
                                    self.cfg.vocab) + aux

    # -- decode --------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> Cache:
        """Per group ``conv1`` / ``conv2`` [G, B, 3, d_rnn] (``dtype``),
        ``h1`` / ``h2`` [G, B, d_rnn] float32 and the rolling K/V window
        [G, B, min(window, max_seq), kv, hd]; ``tail_conv`` / ``tail_h``
        for the trailing rec blocks (one zero slot if there are none)."""
        cfg = self.cfg
        w = min(cfg.window, max_seq)
        g, dr, nt = self.n_groups, cfg.drnn, max(self.n_tail, 1)
        kw = dict(device=self.device)
        return {
            "conv1": torch.zeros((g, batch, 3, dr), dtype=dtype, **kw),
            "h1": torch.zeros((g, batch, dr), dtype=torch.float32, **kw),
            "conv2": torch.zeros((g, batch, 3, dr), dtype=dtype, **kw),
            "h2": torch.zeros((g, batch, dr), dtype=torch.float32, **kw),
            "k": torch.zeros((g, batch, w, cfg.n_kv_heads, cfg.hd),
                             dtype=dtype, **kw),
            "v": torch.zeros((g, batch, w, cfg.n_kv_heads, cfg.hd),
                             dtype=dtype, **kw),
            "tail_conv": torch.zeros((nt, batch, 3, dr), dtype=dtype, **kw),
            "tail_h": torch.zeros((nt, batch, dr), dtype=torch.float32,
                                  **kw),
        }

    def cache_specs(self, long_ctx: bool = False) -> Dict:
        b = None if long_ctx else "data"
        return {
            "conv1": L.P(None, b, None, "model"), "h1": L.P(None, b, "model"),
            "conv2": L.P(None, b, None, "model"), "h2": L.P(None, b, "model"),
            "k": L.P(None, b, None, None, None),
            "v": L.P(None, b, None, None, None),
            "tail_conv": L.P(None, b, None, "model"),
            "tail_h": L.P(None, b, "model"),
        }

    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens [B, 1]; ``pos`` an int -> (logits [B, 1, V], cache).
        Local attention uses the rolling window: position ``pos`` lands
        in slot ``pos % w``, RoPE keeps the absolute ``pos``.  Every state
        advances in place; the same dict is returned.  On ranks: the
        rank's channels of the states, the whole window (the same on every
        rank) and the vocab block of the logits."""
        with L.sharding_mesh(self.ranks):
            return self._decode_step(cache, tokens, int(pos))

    def _decode_step(self, cache: Cache, tokens: torch.Tensor, pos: int):
        cfg = self.cfg
        x = L.embed_vocab_split(self.embed, tokens,
                                L.torch_dtype(cfg.compute_dtype), self.ranks)
        slot = pos % cache["k"].shape[2]
        for i, gp in enumerate(self.groups):
            x = _rec_decode(gp.rec1, cfg, x, cache["conv1"][i],
                            cache["h1"][i])
            x = _mlp_res(gp.mlp1, gp.ln_m1, cfg, x)
            x = _rec_decode(gp.rec2, cfg, x, cache["conv2"][i],
                            cache["h2"][i])
            x = _mlp_res(gp.mlp2, gp.ln_m2, cfg, x)
            a, _, _ = L.attention_decode(
                gp.attn, cfg, L.rms_norm(gp.ln_a, x, cfg.norm_eps),
                cache["k"][i], cache["v"][i], pos, slot=slot)
            x = _mlp_res(gp.mlp3, gp.ln_m3, cfg, x + a)
        for i, tp in enumerate(self.tail):
            x = _rec_decode(tp.rec, cfg, x, cache["tail_conv"][i],
                            cache["tail_h"][i])
            x = _mlp_res(tp.mlp, tp.ln_m, cfg, x)
        x = L.rms_norm(self.ln_f, x, cfg.norm_eps)
        return x @ self.embed.to(x.dtype).T, cache
