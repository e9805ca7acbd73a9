"""Serve steps: one-token decode and full-sequence prefill.

Counterpart of ``repro/serve/serve_step.py``.  ``make_serve_step``: one
token against a KV cache of ``seq_len`` (the ``decode_*`` / ``long_*``
shape cells).  ``make_prefill_step``: full-sequence forward returning
last-token logits (the ``prefill_*`` cells).  The model holds its
parameters, so the steps take none.

On ranks (a model built with ``ranks``) both steps run the rank's
share: they return the rank's vocab block of the logits (whole logits
for Whisper, whose head sums them over ``model``) and write the rank's
cache block, as the reference's partitioned step leaves them.
``whole_logits`` gathers the blocks into whole logits on every rank,
the caller's job outside a timed step.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..core.collectives import all_gather_panel
from ..distributed_lm.sharding import head_vocab_split
from ..models.common import ArchConfig

__all__ = ["make_serve_step", "make_prefill_step", "whole_logits"]


def make_serve_step(model, cfg: ArchConfig) -> Callable:
    @torch.no_grad()
    def serve_step(cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   pos) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return model.decode_step(cache, tokens, pos)
    return serve_step


def make_prefill_step(model, cfg: ArchConfig) -> Callable:
    if cfg.family == "encdec":
        @torch.no_grad()
        def prefill(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
            logits, _ = model.apply(batch["tokens"], batch["frames"])
            return logits[:, -1]
    elif cfg.family == "vlm":
        @torch.no_grad()
        def prefill(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
            logits, _ = model.apply(batch["tokens"], batch["patch_embeds"])
            return logits[:, -1]
    else:
        @torch.no_grad()
        def prefill(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
            logits, _ = model.apply(batch["tokens"])
            return logits[:, -1]
    return prefill


def whole_logits(block: torch.Tensor, mesh, model) -> torch.Tensor:
    """The whole logits from every rank's block of ``mesh`` (a
    ``ProcessMesh``): the vocab blocks (last dimension) gathered over
    ``model`` where ``model``'s head splits the vocab
    (``head_vocab_split``; Whisper's head sums whole logits over
    ``model``), then the batch rows (first dimension) over ``data``;
    every rank gets the same tensor."""
    out = block
    if head_vocab_split(model.param_specs()):
        out = all_gather_panel(out, mesh, "model", dim=block.dim() - 1)
    return all_gather_panel(out, mesh, "data", dim=0)
