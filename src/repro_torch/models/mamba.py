"""Mamba-1 selective SSM (falcon-mamba-7b): attention-free family.

Counterpart of ``repro/models/mamba.py``.  Train / prefill path: the
selective recurrence ``h_t = Ā_t h_{t-1} + B̄_t x_t`` is solved chunk by
chunk, a scan of the ``(Ā, B̄x)`` pairs within each chunk
(``layers.linear_scan``, log-step tensor ops in place of the reference's
``lax.associative_scan``) and a loop carrying the boundary state across
chunks.  The sequence is padded to a multiple of ``scan_chunk`` as the
reference pads it; one chunk's ``[B, chunk, d_inner, d_state]`` float32
pair is formed at a time, so memory stays a few of those whatever the
length.

Decode path: O(1) recurrent step on (conv window, SSM state), both
written in place into the cache (the reference returns new ones).
Layers are an ``nn.ModuleList`` under ``blocks.<i>.``, parameters under
the reference's names.

Built with ``ranks`` (a ``ProcessMesh`` whose ``model`` axis splits the
model), the model is one rank's share of a tensor-parallel one, as
``TransformerLM``'s: its blocks under ``param_specs()``, drawn whole
from the one-process generator leaf by leaf, and ``apply`` /
``decode_step`` inside ``layers.sharding_mesh(ranks)``.  The rank holds
``d_inner / k`` channels: ``conv_*``, ``dt_proj``, ``A_log`` and ``D``
are channel-split, and the selective scan and the decode's ``conv`` /
``ssm`` states cover the rank's channels only.  ``in_proj``'s spec
splits its fused ``[xs | z]`` output over ``model``; a contiguous
column block would hold one half only (the reference's XLA moves
columns to halve it), so the rank holds its channels' columns of each
half (``layers.Fused``): the same bytes, no exchange.  ``x_proj`` and
``out_proj`` are row-split, so each sums its partial product over
``model`` (float32, ``layers.sum_partials``); the vocab-split embedding
all-reduces, and the head leaves the logits vocab-split.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from . import layers as L
from .common import ArchConfig

__all__ = ["MambaLM"]

Cache = Dict[str, torch.Tensor]


class MambaBlock(nn.Module):
    """``ln``, ``in_proj`` (d -> 2 d_inner), ``conv_w`` [d_conv, d_inner],
    ``conv_b``, ``x_proj`` (d_inner -> dt_rank + 2 d_state), ``dt_proj``
    (dt_rank -> d_inner, bias), ``A_log`` [d_inner, d_state], ``D``,
    ``out_proj``."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        d, di, st, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dtr
        self.ln = L.RMSNorm(d, device=device)
        self.in_proj = L.Dense(d, 2 * di, device=device)
        self.conv_w = nn.Parameter(torch.empty((cfg.d_conv, di),
                                               device=device))
        self.conv_b = nn.Parameter(torch.zeros((di,), device=device))
        self.x_proj = L.Dense(di, dtr + 2 * st, device=device)
        self.dt_proj = L.Dense(dtr, di, bias=True, device=device)
        self.A_log = nn.Parameter(torch.empty((di, st), device=device))
        self.D = nn.Parameter(torch.ones((di,), device=device))
        self.out_proj = L.Dense(di, d, device=device)

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        for dense in (self.ln, self.in_proj, self.x_proj, self.dt_proj,
                      self.out_proj):
            dense.reset(generator)
        L.draw(self.conv_w, lambda t: t.normal_(generator=generator).mul_(
            0.1))
        self.conv_b.zero_()
        L.draw(self.A_log, lambda t: t.copy_(torch.log(torch.arange(
            1, t.shape[1] + 1, dtype=torch.float32,
            device=t.device))[None].expand_as(t)))
        self.D.fill_(1.0)


def _block_specs(cfg: ArchConfig) -> Dict:
    return {
        "ln": L.rms_specs(),
        # the [xs | z] halves, each split over model (module docstring)
        "in_proj": L.dense_specs(None, L.Fused("model", 2)),
        "conv_w": L.P(None, "model"),
        "conv_b": L.P("model"),
        "x_proj": L.dense_specs("model", None),
        "dt_proj": L.dense_specs(None, "model", bias=True),
        "A_log": L.P("model", None),
        "D": L.P("model"),
        "out_proj": L.dense_specs("model", None),
    }


def _selective_scan_chunked(u: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, Bc: torch.Tensor,
                            Cc: torch.Tensor, chunk: int,
                            h0: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u/dt [B,S,di], A [di,st], Bc/Cc [B,S,st] -> (y [B,S,di], h_last).

    Discretize: Ā = exp(dt·A) (per channel, per state), B̄x = dt·B·u.
    Within a chunk a scan of the (Ā, B̄x) pairs; across chunks the
    boundary state is carried.  A padded step has dt = 0, so Ā = 1 and
    B̄x = 0: it is the identity."""
    b, s, di = u.shape
    st = A.shape[1]
    pad = (-s) % chunk
    if pad:
        u = F.pad(u, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    h = (torch.zeros((b, di, st), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for c0 in range(0, s + pad, chunk):
        dtc, uc = dt[:, c0:c0 + chunk], u[:, c0:c0 + chunk]
        dA = torch.exp(dtc[..., None].float() * A[None, None])  # [B,c,di,st]
        dBx = (dtc * uc)[..., None].float() \
            * Bc[:, c0:c0 + chunk, None, :]                     # [B,c,di,st]
        a_acc, b_acc = L.linear_scan(dA, dBx, dim=1)
        del dA, dBx
        hs = a_acc * h[:, None] + b_acc                        # [B,c,di,st]
        del a_acc, b_acc
        ys.append(torch.einsum("bcds,bcs->bcd", hs, Cc[:, c0:c0 + chunk]))
        h = hs[:, -1]
        del hs
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(u.dtype), h


def _ssm_inputs(p: MambaBlock, cfg: ArchConfig, xs: torch.Tensor):
    """(dt float32, A, B, C) of the selective SSM from the conv output."""
    dtr, st = cfg.dtr, cfg.ssm_state
    proj = L.dense_apply(p.x_proj, xs)
    dt_r, Bc, Cc = torch.split(proj, [dtr, st, st], dim=-1)
    # F.softplus returns x itself past 20, jax.nn.softplus does not: the
    # two differ there by under log1p(exp(-20)) = 2e-9
    dt = F.softplus(L.dense_apply(p.dt_proj, dt_r).float())
    A = -torch.exp(p.A_log)
    return dt, A, Bc.float(), Cc.float()


def _block_apply(p: MambaBlock, cfg: ArchConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    res = x
    x = L.rms_norm(p.ln, x, cfg.norm_eps)
    xs, z = L.dense_apply(p.in_proj, x).chunk(2, dim=-1)
    xs = F.silu(L.causal_conv(xs, p.conv_w, p.conv_b))
    dt, A, Bc, Cc = _ssm_inputs(p, cfg, xs)
    y, _ = _selective_scan_chunked(xs, dt, A, Bc, Cc, cfg.scan_chunk)
    y = y + xs * p.D.to(xs.dtype)
    y = y * F.silu(z)
    return res + L.dense_apply(p.out_proj, y)


def _block_decode(p: MambaBlock, cfg: ArchConfig, x: torch.Tensor,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor
                  ) -> torch.Tensor:
    """x [B, 1, d]; conv_state [B, K-1, di] and ssm_state [B, di, st],
    both advanced in place."""
    res = x
    x = L.rms_norm(p.ln, x, cfg.norm_eps)
    xin, z = L.dense_apply(p.in_proj, x).chunk(2, dim=-1)
    xs = F.silu(L.causal_conv(xin, p.conv_w, p.conv_b, state=conv_state))
    conv_state.copy_(torch.cat([conv_state[:, 1:],
                                xin.to(conv_state.dtype)], dim=1))
    dt, A, Bc, Cc = _ssm_inputs(p, cfg, xs)
    dA = torch.exp(dt[..., None] * A[None, None])               # [B,1,di,st]
    dBx = (dt * xs.float())[..., None] * Bc[:, :, None, :]
    h = ssm_state.float() * dA[:, 0] + dBx[:, 0]                # [B,di,st]
    y = torch.einsum("bds,bs->bd", h, Cc[:, 0])[:, None]
    ssm_state.copy_(h.to(ssm_state.dtype))
    y = y.to(xs.dtype) + xs * p.D.to(xs.dtype)
    y = y * F.silu(z)
    return res + L.dense_apply(p.out_proj, y)


class MambaLM(nn.Module):
    """falcon-mamba-7b: Mamba-1 blocks, RMSNorm, untied head.

    Built on ``device`` (``None`` means ``"cuda"``) with its parameters
    unset: ``init(generator)`` draws them, or ``load_state_dict`` fills
    them.  With ``ranks`` (a ``ProcessMesh``) it holds this rank's blocks
    (module docstring)."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None,
                 ranks=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.ranks = ranks
        whole_dev = dev
        if ranks is not None:
            dev = torch.device("meta")
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              device=dev))
        self.ln_f = L.RMSNorm(cfg.d_model, device=dev)
        self.blocks = nn.ModuleList(MambaBlock(cfg, device=dev)
                                    for _ in range(cfg.n_layers))
        self.lm_head = L.Dense(cfg.d_model, cfg.vocab, device=dev)
        if ranks is not None:
            from ..distributed_lm.sharding import to_rank_widths
            to_rank_widths(self, ranks, whole_dev)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MambaLM":
        """Draws every parameter from ``generator`` with the reference's
        distributions (embeddings N(0, 0.02²), projections N(0, 1/d_in),
        conv N(0, 0.01), ``A_log`` = log 1..d_state, ``D`` ones)."""
        L.draw(self.embed, lambda t: t.normal_(generator=generator).mul_(
            0.02))
        self.ln_f.reset(generator)
        for blk in self.blocks:
            blk.reset(generator)
        self.lm_head.reset(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_specs(self) -> Dict:
        return {"embed": L.P("model", None), "ln_f": L.rms_specs(),
                "blocks": L.stacked_specs(_block_specs(self.cfg)),
                "lm_head": L.dense_specs(None, "model")}

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
        block = L.remat(_block_apply, cfg)
        for blk in self.blocks:
            x = block(blk, cfg, x)
        x = L.rms_norm(self.ln_f, x, cfg.norm_eps)
        return (L.dense_apply(self.lm_head, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    forward = apply

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, aux = self.apply(batch["tokens"])
        return L.cross_entropy_loss(logits, batch["labels"],
                                    self.cfg.vocab) + aux

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> Cache:
        """``conv`` [L, B, d_conv-1, d_inner] in ``dtype`` and ``ssm``
        [L, B, d_inner, d_state] float32, zeros; O(1) in ``max_seq``."""
        cfg = self.cfg
        return {
            "conv": torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1,
                                 cfg.d_inner), dtype=dtype,
                                device=self.device),
            "ssm": torch.zeros((cfg.n_layers, batch, cfg.d_inner,
                                cfg.ssm_state), dtype=torch.float32,
                               device=self.device),
        }

    def cache_specs(self, long_ctx: bool = False) -> Dict:
        bspec = None if long_ctx else "data"
        return {"conv": L.P(None, bspec, None, "model"),
                "ssm": L.P(None, bspec, "model", None)}

    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens [B, 1] -> (logits [B, 1, V], cache); each layer's conv
        window and SSM state advance in place, the same dict is
        returned (``pos`` is not needed: the state is the position).  On
        ranks: the rank's channels of the states and vocab block of the
        logits."""
        with L.sharding_mesh(self.ranks):
            return self._decode_step(cache, tokens)

    def _decode_step(self, cache: Cache, tokens: torch.Tensor):
        cfg = self.cfg
        x = L.embed_vocab_split(self.embed, tokens,
                                L.torch_dtype(cfg.compute_dtype), self.ranks)
        for i, blk in enumerate(self.blocks):
            x = _block_decode(blk, cfg, x, cache["conv"][i],
                              cache["ssm"][i])
        x = L.rms_norm(self.ln_f, x, cfg.norm_eps)
        return L.dense_apply(self.lm_head, x), cache
