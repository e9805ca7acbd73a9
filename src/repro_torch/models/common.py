"""Shared architecture config for the assigned model pool.

Counterpart of ``repro/models/common.py``, field for field: the same
dataclass, defaults, derived widths and parameter counts, so a config
means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One config object spans all five families; family-specific fields
    default to inert values.  Exact per-arch instances live in
    ``repro_torch.configs.<arch>``."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0               # routed-expert hidden dim
    dense_residual: bool = False    # arctic: parallel dense MLP beside MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # experts sharding: "model" (experts over model axis),
    # "model+data" (experts over model, hidden over data — 480B-scale EP),
    # "ffn" (experts replicated, hidden over model)
    expert_sharding: str = "ffn"
    # capacity-based dispatch (Switch-style): expert inputs shrink from
    # [E, tokens, d] to [E, cap, d] with cap ≈ top_k·t·cf/E — the §Perf B
    # lever (dropped-token overflow is the standard trade)
    moe_capacity: bool = False

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # default d_model // 16
    scan_chunk: int = 256           # chunked associative scan window

    # --- hybrid (recurrentgemma / griffin) ---
    window: int = 0                 # local-attention window
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    d_rnn: int = 0                  # RG-LRU width (default d_model)

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 1500          # stub conv frontend output length

    # --- VLM stub (llava) ---
    vision_dim: int = 0             # >0 activates the patch-embed stub input
    num_patches: int = 576

    # --- attention memory ---
    attn_chunk: int = 1024          # flash-style chunk size (0 = disabled)

    # --- §Perf hillclimb knobs (beyond-paper optimizations) ---
    # replicate K/V heads across TP and broadcast to full heads before the
    # score contraction, so every attention tensor stays head-sharded and
    # the GQA (kv, rep) reshape never forces a GSPMD reshard (see
    # EXPERIMENTS.md §Perf A)
    gqa_repeat: bool = False
    # explicit with_sharding_constraint on block/attention activations
    act_shard: bool = False

    # --- training/runtime knobs ---
    scan_layers: bool = True
    remat: bool = True
    # "full": nothing saveable (min memory, re-runs fwd collectives in bwd);
    # "dots": dots_with_no_batch_dims_saveable (saves matmul outputs — no
    # re-forward, ~25% fewer activation all-reduces; §Perf A iter 2)
    remat_policy: str = "full"
    microbatch: int = 1             # grad-accumulation microbatches
    opt_8bit: bool = False          # blockwise int8 Adam moments
    zero1: bool = True              # shard optimizer state over data axis
    param_dtype: str = "float32"    # master copy dtype
    compute_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def dtr(self) -> int:
        return self.dt_rank if self.dt_rank else max(1, self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def drnn(self) -> int:
        return self.d_rnn if self.d_rnn else self.d_model

    def n_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, st, dtr = self.d_inner, self.ssm_state, self.dtr
            per = (d * 2 * di + self.d_conv * di + di * (dtr + 2 * st)
                   + dtr * di + di * st + di + di * d)
            return self.n_layers * per + emb
        if self.family == "moe":
            routed = self.n_experts * 3 * d * self.moe_d_ff
            shared = self.n_shared_experts * 3 * d * self.moe_d_ff
            dense = 3 * d * f if self.dense_residual else 0
            router = d * self.n_experts
            return self.n_layers * (attn + routed + shared + dense + router) + emb
        if self.family == "hybrid":
            pat = self.block_pattern or ("rec", "rec", "attn")
            n_attn = sum(1 for i in range(self.n_layers)
                         if pat[i % len(pat)] == "attn")
            n_rec = self.n_layers - n_attn
            rec = 2 * d * self.drnn + 2 * self.drnn * self.drnn // self.drnn \
                + self.drnn * d + 4 * self.drnn  # proj + gates + out
            rec = 3 * d * self.drnn + 4 * self.drnn
            mlp = 3 * d * f
            return n_attn * (attn + mlp) + n_rec * (rec + mlp) + emb
        if self.family == "encdec":
            enc = self.enc_layers * (attn + 2 * d * f)
            dec = self.n_layers * (2 * attn + 2 * d * f)
            return enc + dec + emb
        # dense / vlm
        mlp = 3 * d * f
        extra = self.vision_dim * d + d * d if self.vision_dim else 0
        return self.n_layers * (attn + mlp) + emb + extra

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared + dense)."""
        if self.family != "moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        act = self.top_k * 3 * d * self.moe_d_ff \
            + self.n_shared_experts * 3 * d * self.moe_d_ff \
            + (3 * d * f if self.dense_residual else 0) \
            + d * self.n_experts
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + act) + emb
