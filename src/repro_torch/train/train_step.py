"""Train step: microbatched gradient accumulation + AdamW update.

Counterpart of ``repro/train/train_step.py``.  The batch splits into
``cfg.microbatch`` equal slices along its first axis; each slice's loss
is back-propagated into the parameters' float32 ``.grad``, which sums the
microbatches as the reference's float32 accumulator does, then the mean
gradient goes to ``adam_update``.  The model holds the parameters, so
``params`` must be its own ``{name: parameter}``
(``model_params(model)``); they and the optimizer state are updated in
place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

from ..models.common import ArchConfig
from .optimizer import AdamConfig, adam_update

__all__ = ["make_train_step", "make_eval_step", "model_params"]


def model_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``{state_dict name: parameter}`` of ``model``: the ``params`` the
    steps and the optimizer take."""
    return dict(model.named_parameters())


def _on(model, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=model.device)
            for k, v in batch.items()}


def _check_params(model, params: Mapping[str, torch.Tensor]) -> None:
    own = dict(model.named_parameters())
    if own.keys() != params.keys() or any(
            params[k] is not own[k] for k in own):
        raise ValueError("params must be the model's own parameters "
                         "(model_params(model)); the model computes with "
                         "those")


def make_train_step(model, cfg: ArchConfig, opt_cfg: AdamConfig
                    ) -> Callable:
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` leaves (tensors or arrays) are [B_global, ...]
    and B must divide by ``cfg.microbatch``; ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-d float32 tensors."""
    nm = max(cfg.microbatch, 1)

    def train_step(params: Dict[str, torch.Tensor],
                   opt_state: Dict[str, Any], batch: Mapping[str, Any]):
        _check_params(model, params)
        batch = _on(model, batch)
        b = next(iter(batch.values())).shape[0]
        if b % nm:
            raise ValueError(f"batch {b} does not split into {nm} "
                             f"microbatches")
        per = b // nm
        for p in params.values():
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        with torch.enable_grad():
            for i in range(nm):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                loss = model.loss(mb)
                loss.backward()
                loss_sum += loss.detach().float()
        grads = {k: (p.grad.div_(nm) if p.grad is not None
                     else torch.zeros_like(p, dtype=torch.float32))
                 for k, p in params.items()}
        params, opt_state, metrics = adam_update(params, grads, opt_state,
                                                 opt_cfg)
        for p in params.values():
            p.grad = None
        return params, opt_state, dict(metrics, loss=loss_sum / nm)

    return train_step


def make_eval_step(model) -> Callable:
    @torch.no_grad()
    def eval_step(params: Mapping[str, torch.Tensor],
                  batch: Mapping[str, Any]) -> torch.Tensor:
        _check_params(model, params)
        return model.loss(_on(model, batch))
    return eval_step
