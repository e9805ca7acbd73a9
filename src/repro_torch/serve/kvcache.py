"""Serving cache utilities: prefill + decode drivers.

Counterpart of ``repro/serve/kvcache.py``; its ``lax.scan`` over steps is
a loop here.  The model's ``decode_step`` writes each step's K/V into
``cache`` in place, so both drivers fill the cache they are given (and
return it); the prompt ``tokens`` are only read.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["prefill_with_decode", "greedy_decode"]

Cache = Dict[str, torch.Tensor]


@torch.no_grad()
def prefill_with_decode(model, cache: Cache, tokens: torch.Tensor
                        ) -> Tuple[torch.Tensor, Cache]:
    """Fill the cache by running ``decode_step`` over the prompt
    [B, S], one position at a time.  Works for every family (attention
    archs can instead run the full-sequence path, ``serve_step``'s
    prefill).  Returns (last step's logits [B, V], cache)."""
    logits = None
    for pos in range(tokens.shape[1]):
        logits, cache = model.decode_step(cache, tokens[:, pos:pos + 1], pos)
    return logits[:, 0], cache


@torch.no_grad()
def greedy_decode(model, cache: Cache, last_logits: torch.Tensor,
                  start_pos: int, steps: int) -> Tuple[torch.Tensor, Cache]:
    """Greedy continuation for ``steps`` tokens -> (tokens [B, steps]
    int32, cache)."""
    logits, toks = last_logits, []
    for i in range(steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, cache = model.decode_step(cache, tok[:, None], start_pos + i)
        logits = logits[:, 0]
        toks.append(tok)
    if not toks:
        return torch.zeros((last_logits.shape[0], 0), dtype=torch.int32,
                           device=last_logits.device), cache
    return torch.stack(toks, dim=1), cache
