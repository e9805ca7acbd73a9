"""Whisper-large-v3 backbone (audio family): encoder-decoder transformer.

Counterpart of ``repro/models/whisper.py``.  The modality frontend is a
stub, as in the reference: the caller supplies precomputed frame
embeddings [B, enc_frames, d_model] (the two conv1d layers and the
log-mel stage are not modelled).  Positions are sinusoidal on both sides
(``layers.sinusoidal_positions``).

Decoder layers: causal self-attention, cross-attention over the encoder
states, GELU MLP, pre-norm; tied head.  Serving fills the per-layer cross
K/V once (``prefill_cross``) and then carries the self-attention cache,
which each decode step writes in place; the cross K/V is only read.
Layers are ``nn.ModuleList``s under ``enc_blocks.<i>.`` and
``dec_blocks.<i>.`` (stacked on a leading axis in the reference).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import layers as L
from .common import ArchConfig

__all__ = ["WhisperModel"]

Cache = Dict[str, torch.Tensor]


class EncBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp`` (GELU)."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, device=device)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, kind="gelu", device=device)

    def reset(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset(generator)


class DecBlock(nn.Module):
    """``ln1``, ``self_attn``, ``ln2``, ``cross_attn``, ``ln3``, ``mlp``
    (GELU)."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device)
        self.self_attn = L.Attention(cfg, device=device)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device)
        self.cross_attn = L.Attention(cfg, device=device)
        self.ln3 = L.RMSNorm(cfg.d_model, device=device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, kind="gelu", device=device)

    def reset(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset(generator)


def _enc_block_specs(cfg: ArchConfig) -> Dict:
    return {"ln1": L.rms_specs(), "attn": L.attention_specs(cfg),
            "ln2": L.rms_specs(), "mlp": L.mlp_specs(kind="gelu")}


def _dec_block_specs(cfg: ArchConfig) -> Dict:
    return {"ln1": L.rms_specs(), "self_attn": L.attention_specs(cfg),
            "ln2": L.rms_specs(), "cross_attn": L.attention_specs(cfg),
            "ln3": L.rms_specs(), "mlp": L.mlp_specs(kind="gelu")}


def _enc_block_apply(p: EncBlock, cfg: ArchConfig, x: torch.Tensor
                     ) -> torch.Tensor:
    x = x + L.attention_apply(p.attn, cfg,
                              L.rms_norm(p.ln1, x, cfg.norm_eps),
                              causal=False, use_rope=False)
    return x + L.mlp_apply(p.mlp, L.rms_norm(p.ln2, x, cfg.norm_eps),
                           kind="gelu")


def _dec_block_apply(p: DecBlock, cfg: ArchConfig, x: torch.Tensor,
                     enc: torch.Tensor) -> torch.Tensor:
    x = x + L.attention_apply(p.self_attn, cfg,
                              L.rms_norm(p.ln1, x, cfg.norm_eps),
                              causal=True, use_rope=False)
    x = x + L.attention_apply(p.cross_attn, cfg,
                              L.rms_norm(p.ln2, x, cfg.norm_eps),
                              kv_x=enc, use_rope=False)
    return x + L.mlp_apply(p.mlp, L.rms_norm(p.ln3, x, cfg.norm_eps),
                           kind="gelu")


class WhisperModel(nn.Module):
    """Encoder-decoder backbone; inputs are (tokens [B, S], frames
    [B, F, D] stub).  Built on ``device`` (``None`` means ``"cuda"``) with
    its parameters unset: ``init(generator)`` draws them."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              device=dev))
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, device=dev)
                                        for _ in range(cfg.enc_layers))
        self.enc_ln = L.RMSNorm(cfg.d_model, device=dev)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device=dev)
                                        for _ in range(cfg.n_layers))
        self.dec_ln = L.RMSNorm(cfg.d_model, device=dev)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "WhisperModel":
        """Draws every parameter from ``generator`` with the reference's
        distributions."""
        self.embed.normal_(generator=generator).mul_(0.02)
        for mod in [*self.enc_blocks, self.enc_ln, *self.dec_blocks,
                    self.dec_ln]:
            mod.reset(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_specs(self) -> Dict:
        cfg = self.cfg
        # whisper's 51,866-token vocab does not divide a 16-way model
        # axis, so the embedding splits on d_model (as the reference's)
        return {"embed": L.P(None, "model"),
                "enc_blocks": L.stacked_specs(_enc_block_specs(cfg)),
                "enc_ln": L.rms_specs(),
                "dec_blocks": L.stacked_specs(_dec_block_specs(cfg)),
                "dec_ln": L.rms_specs()}

    def _dtype(self) -> torch.dtype:
        return L.torch_dtype(self.cfg.compute_dtype)

    def _positions(self, positions: torch.Tensor) -> torch.Tensor:
        return L.sinusoidal_positions(positions, self.cfg.d_model)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.embed.to(x.dtype).T

    # -- encoder -------------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self._dtype()
        pos = self._positions(torch.arange(frames.shape[1],
                                           device=frames.device))
        x = frames.to(dt) + pos[None].to(dt)
        block = L.remat(_enc_block_apply, cfg)
        for blk in self.enc_blocks:
            x = block(blk, cfg, x)
        return L.rms_norm(self.enc_ln, x, cfg.norm_eps)

    # -- decoder full-sequence -------------------------------------------------
    def apply(self, tokens: torch.Tensor, frames: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits [B, S, V], aux_loss = 0)."""
        cfg, dt = self.cfg, self._dtype()
        enc = self.encode(frames)
        pos = self._positions(torch.arange(tokens.shape[1],
                                           device=tokens.device))
        x = self.embed[tokens.long()].to(dt) + pos[None].to(dt)
        block = L.remat(_dec_block_apply, cfg)
        for blk in self.dec_blocks:
            x = block(blk, cfg, x, enc)
        x = L.rms_norm(self.dec_ln, x, cfg.norm_eps)
        return (self._head(x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    forward = apply

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, aux = self.apply(batch["tokens"], batch["frames"])
        return L.cross_entropy_loss(logits, batch["labels"],
                                    self.cfg.vocab) + aux

    # -- decode ----------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> Cache:
        """Self-attention ``k`` / ``v`` [L, B, max_seq, kv, hd] and the
        cross ``cross_k`` / ``cross_v`` [L, B, enc_frames, kv, hd], zeros
        in ``dtype`` (``prefill_cross`` fills the cross part)."""
        cfg = self.cfg
        kv, hd, dev = cfg.n_kv_heads, cfg.hd, self.device
        self_shape = (cfg.n_layers, batch, max_seq, kv, hd)
        cross_shape = (cfg.n_layers, batch, cfg.enc_frames, kv, hd)
        return {"k": torch.zeros(self_shape, dtype=dtype, device=dev),
                "v": torch.zeros(self_shape, dtype=dtype, device=dev),
                "cross_k": torch.zeros(cross_shape, dtype=dtype, device=dev),
                "cross_v": torch.zeros(cross_shape, dtype=dtype,
                                       device=dev)}

    def cache_specs(self, long_ctx: bool = False) -> Dict:
        sspec = (L.P(None, None, ("data", "model"), None, None) if long_ctx
                 else L.P(None, "data", "model", None, None))
        cspec = L.P(None, None if long_ctx else "data", None, None, None)
        return {"k": sspec, "v": sspec, "cross_k": cspec, "cross_v": cspec}

    @torch.no_grad()
    def prefill_cross(self, cache: Cache, frames: torch.Tensor) -> Cache:
        """Encode ``frames`` and write every decoder layer's cross K/V
        into ``cache["cross_k"]`` / ``["cross_v"]`` in place; returns the
        same dict."""
        cfg = self.cfg
        enc = self.encode(frames)
        b, f = enc.shape[:2]
        for i, blk in enumerate(self.dec_blocks):
            ca = blk.cross_attn
            k = L.dense_apply(ca.wk, enc).reshape(b, f, cfg.n_kv_heads,
                                                  cfg.hd)
            v = L.dense_apply(ca.wv, enc).reshape(b, f, cfg.n_kv_heads,
                                                  cfg.hd)
            cache["cross_k"][i].copy_(k)
            cache["cross_v"][i].copy_(v)
        return cache

    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens [B, 1]; ``pos`` an int -> (logits [B, 1, V], cache).
        Self-attention K/V are written in place at ``pos``; the cross
        K/V are read, never written (``update_cache=False``, no mask)."""
        cfg, dt = self.cfg, self._dtype()
        pos = int(pos)
        pos_emb = self._positions(torch.tensor([pos], device=self.device))
        x = self.embed[tokens.long()].to(dt) + pos_emb[None].to(dt)
        for i, blk in enumerate(self.dec_blocks):
            a, _, _ = L.attention_decode(
                blk.self_attn, cfg, L.rms_norm(blk.ln1, x, cfg.norm_eps),
                cache["k"][i], cache["v"][i], pos, use_rope=False)
            x = x + a
            c, _, _ = L.attention_decode(
                blk.cross_attn, cfg, L.rms_norm(blk.ln2, x, cfg.norm_eps),
                cache["cross_k"][i], cache["cross_v"][i], pos,
                use_rope=False, update_cache=False, causal_mask=False)
            x = x + c
            x = x + L.mlp_apply(blk.mlp, L.rms_norm(blk.ln3, x,
                                                    cfg.norm_eps),
                                kind="gelu")
        x = L.rms_norm(self.dec_ln, x, cfg.norm_eps)
        return self._head(x), cache
