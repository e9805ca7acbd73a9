"""Train step: microbatched gradient accumulation + AdamW update.

Counterpart of ``repro/train/train_step.py``.  The batch splits into
``cfg.microbatch`` equal slices along its first axis; each slice's loss
is back-propagated into the parameters' float32 ``.grad``, which sums the
microbatches as the reference's float32 accumulator does, then the mean
gradient goes to ``adam_update``.  The model holds the parameters, so
``params`` must be its own ``{name: parameter}``
(``model_params(model)``); they and the optimizer state are updated in
place.

A model built with ``ranks`` (a ``ProcessMesh`` whose ``model`` axis
splits it; a ``dense`` transformer, float32 moments) runs the rank's
step: what one device of a tensor-parallel mesh runs.  Its parameters,
gradients and moments are the rank's blocks.  The backward's collectives
sit in the layers (``models.layers``: the entry of each column-split
group sums its input gradient over ``model``, the row-split denses' and
the embedding's sums pass the gradient through, the vocab-split loss is
local).  The replicated leaves applied to the rank's own heads
(``layers.partial_grad``: the qk norms) hold a partial gradient, summed
over ``model`` in float32 once a step (one all-reduce of them all),
and the global norm is taken over the ``model`` line
(``optimizer.global_norm``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

from ..core import collectives as coll
from ..distributed_lm.sharding import leaf_spec, spec_axes
from ..models.common import ArchConfig
from ..models.layers import partial_grad
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


def _rank_split(model, cfg: ArchConfig, opt_cfg: AdamConfig):
    """The rank's ``ProcessMesh`` where ``model`` is a rank's share of a
    tensor-parallel model (its ``model`` axis over 1), else ``None``;
    raises where that step is not ported."""
    ranks = getattr(model, "ranks", None)
    if ranks is None or ranks.shape.get("model", 1) == 1:
        return None
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training a {cfg.family!r} model on ranks (its gathers', "
            f"all-to-alls' and scans' backwards) is not ported (ROADMAP.md, "
            f"A10d-5b-3)")
    if opt_cfg.use_8bit:
        raise NotImplementedError("8-bit moments on ranks are not ported")
    return ranks


def _sum_partial_grads(grads: Dict[str, torch.Tensor], keys, ranks) -> None:
    """Each gradient of ``keys`` (float32 partial sums) replaced in place
    by its sum over ``model``: one all-reduce of them all."""
    if not keys:
        return
    total = coll.all_reduce_sum(torch.cat([grads[k].reshape(-1)
                                           for k in keys]), ranks, "model")
    at = 0
    for k in keys:
        n = grads[k].numel()
        grads[k].copy_(total[at:at + n].view_as(grads[k]))
        at += n


def make_train_step(model, cfg: ArchConfig, opt_cfg: AdamConfig
                    ) -> Callable:
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` leaves (tensors or arrays) are [B_global, ...]
    and B must divide by ``cfg.microbatch``; ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-d float32 tensors.  On ranks (module
    docstring) every rank passes the same batch and gets the same
    metrics."""
    nm = max(cfg.microbatch, 1)
    ranks = _rank_split(model, cfg, opt_cfg)
    replicated, partial = set(), []
    if ranks is not None:
        specs = model.param_specs()
        for k, p in model.named_parameters():
            if not any("model" in spec_axes(e)
                       for e in leaf_spec(specs, k)):
                replicated.add(k)
                if partial_grad(k):
                    partial.append(k)

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
        if ranks is not None:
            _sum_partial_grads(grads, partial, ranks)
        params, opt_state, metrics = adam_update(params, grads, opt_state,
                                                 opt_cfg, ranks, replicated)
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
