"""Decoder-only transformer LM covering the dense / moe / vlm families.

Counterpart of ``repro/models/transformer.py``.  The reference stacks
every layer's parameters on a leading ``[L, ...]`` axis and drives them
with ``lax.scan``; here the layers are an ``nn.ModuleList`` walked in a
loop, each layer's parameters under ``blocks.<i>.`` of the
``state_dict`` (``repro_torch.convert.lm_state_dict_from_params`` splits
a reference pytree along that axis).  ``remat`` checkpoints each block
when autograd records (``layers.remat``); ``scan_layers`` is the
reference's compile-time knob and changes nothing here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from . import layers as L
from .common import ArchConfig

__all__ = ["TransformerLM"]

Cache = Dict[str, torch.Tensor]


class Block(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and ``mlp`` (or ``moe``)."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, device=device)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device)
        if cfg.family == "moe":
            self.moe = L.MoE(cfg, device=device)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, device=device)

    def reset(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset(generator)


def _block_specs(cfg: ArchConfig) -> Dict:
    p = {"ln1": L.rms_specs(), "attn": L.attention_specs(cfg),
         "ln2": L.rms_specs()}
    if cfg.family == "moe":
        p["moe"] = L.moe_specs(cfg)
    else:
        p["mlp"] = L.mlp_specs()
    return p


def _block_apply(p: Block, cfg: ArchConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x + L.attention_apply(p.attn, cfg, L.rms_norm(p.ln1, x, cfg.norm_eps),
                              causal=True, window=cfg.window)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    y = L.rms_norm(p.ln2, h, cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = L.moe_apply(p.moe, cfg, y)
    else:
        y = L.mlp_apply(p.mlp, y)
    return h + y, aux


def _block_decode(p: Block, cfg: ArchConfig, x: torch.Tensor, ck, cv, pos
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    a, ck, cv = L.attention_decode(p.attn, cfg,
                                   L.rms_norm(p.ln1, x, cfg.norm_eps),
                                   ck, cv, pos, window=cfg.window)
    h = x + a
    y = L.rms_norm(p.ln2, h, cfg.norm_eps)
    if cfg.family == "moe":
        y, _ = L.moe_apply(p.moe, cfg, y)
    else:
        y = L.mlp_apply(p.mlp, y)
    return h + y, ck, cv


class TransformerLM(nn.Module):
    """Dense / MoE / VLM decoder LM (llava, qwen*, minitron, arctic, ...).

    Built on ``device`` (``None`` means ``"cuda"`` and raises without a
    CUDA device) with its parameters unset: ``init(generator)`` draws
    them, or ``load_state_dict`` fills them."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              device=dev))
        self.ln_f = L.RMSNorm(cfg.d_model, device=dev)
        self.blocks = nn.ModuleList(Block(cfg, device=dev)
                                    for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = L.Dense(cfg.d_model, cfg.vocab, device=dev)
        if cfg.vision_dim:
            self.vision_proj = nn.ModuleDict({
                "fc1": L.Dense(cfg.vision_dim, cfg.d_model, bias=True,
                               device=dev),
                "fc2": L.Dense(cfg.d_model, cfg.d_model, bias=True,
                               device=dev)})

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Draws every parameter from ``generator`` (on this model's
        device) with the reference's distributions: embeddings N(0, 0.02²),
        projections N(0, 1/d_in), norms ones, biases zeros."""
        self.embed.normal_(generator=generator).mul_(0.02)
        self.ln_f.reset(generator)
        for blk in self.blocks:
            blk.reset(generator)
        if hasattr(self, "lm_head"):
            self.lm_head.reset(generator)
        if hasattr(self, "vision_proj"):
            for dense in self.vision_proj.values():
                dense.reset(generator)
        return self

    def param_specs(self) -> Dict:
        """The reference's spec tree (layers stacked on a leading axis)."""
        cfg = self.cfg
        p = {"embed": L.P("model", None), "ln_f": L.rms_specs(),
             "blocks": L.stacked_specs(_block_specs(cfg))}
        if not cfg.tie_embeddings:
            p["lm_head"] = L.dense_specs(None, "model")
        if cfg.vision_dim:
            p["vision_proj"] = {
                "fc1": L.dense_specs(None, "model", bias=True),
                "fc2": L.dense_specs("model", None, bias=True)}
        return p

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- embedding helpers ---------------------------------------------------
    def _embed(self, tokens: torch.Tensor,
               patch_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        dt = L.torch_dtype(cfg.compute_dtype)
        x = self.embed[tokens.long()].to(dt)
        if cfg.vision_dim and patch_embeds is not None:
            vp = self.vision_proj
            pe = L.dense_apply(vp["fc2"], F.gelu(
                L.dense_apply(vp["fc1"], patch_embeds.to(dt)),
                approximate="tanh"))
            x = torch.cat([pe, x], dim=1)            # patches prepended
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ self.embed.to(x.dtype).T
        return L.dense_apply(self.lm_head, x)

    # -- full-sequence forward ----------------------------------------------
    def apply(self, tokens: torch.Tensor,
              patch_embeds: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits [B, S, V], aux_loss)."""
        cfg = self.cfg
        x = self._embed(tokens, patch_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        block = L.remat(_block_apply, cfg)
        for blk in self.blocks:
            x, a = block(blk, cfg, x)
            aux = aux + a
        x = L.rms_norm(self.ln_f, x, cfg.norm_eps)
        return self._head(x), aux

    forward = apply

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, aux = self.apply(batch["tokens"], batch.get("patch_embeds"))
        labels = batch["labels"]
        # logits cover [patches + tokens]; labels align with the full stream
        return L.cross_entropy_loss(logits[:, -labels.shape[1]:], labels,
                                    self.cfg.vocab) + aux

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> Cache:
        """``{"k", "v"}`` zeros [L, B, max_seq, kv, hd] on this model's
        device."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def cache_specs(self, long_ctx: bool = False) -> Dict:
        spec = (L.P(None, None, ("data", "model"), None, None) if long_ctx
                else L.P(None, "data", "model", None, None))
        return {"k": spec, "v": spec}

    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens [B, 1]; ``pos`` an int -> (logits [B, 1, V], cache).
        Each layer writes its new K/V into ``cache`` in place
        (``layers.attention_decode``); the same dict is returned."""
        cfg = self.cfg
        x = self._embed(tokens, None)
        for i, blk in enumerate(self.blocks):
            x, _, _ = _block_decode(blk, cfg, x, cache["k"][i],
                                    cache["v"][i], pos)
        x = L.rms_norm(self.ln_f, x, cfg.norm_eps)
        return self._head(x), cache
