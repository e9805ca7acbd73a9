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
splits it; a transformer of the ``dense``, ``moe`` or ``vlm`` family,
float32 moments) runs the rank's step: what one device of a
tensor-parallel mesh runs.  Its parameters,
gradients and moments are the rank's blocks.  The backward's collectives
sit in the layers (``models.layers``: the entry of each column-split
group sums its input gradient over ``model``, the row-split denses' and
the embedding's sums pass the gradient through, the vocab-split loss is
local; FFN-split experts sum their tokens' and gates' gradients where
they enter, expert-parallel ones run the all-to-alls in reverse and
gather the gradients of the rank's token rows).  The replicated leaves applied to the rank's own heads
(``layers.partial_grad``: the qk norms) hold a partial gradient, summed
over ``model`` in float32 once a step (one all-reduce of them all),
and the global norm is taken over the ``model`` line
(``optimizer.global_norm``).

On ranks whose ``data`` axis is over 1 (a model built with the whole
``(data, model)`` ``ProcessMesh``) each rank runs what one
device of the data-parallel mesh runs.  Every rank is handed the whole
global batch, and takes of each microbatch ``[i * per, (i + 1) * per)``
its data coordinate's ``per / data`` rows (the reference's ``reshape``
into microbatches, each batch-split over ``data``; a MoE layer's
load-balancing loss reads the expert density of the whole microbatch,
one float32 all-reduce over ``data`` a forward pass).  After the backward
and the qk norms' sum, each leaf of the reference's tree (a stacked
group's layers together: one collective a leaf, not a layer) is reduced
over ``data`` in float32 and scaled to the global mean: reduce-scattered
to the rank's ZeRO-1 shard of its moments (``optimizer.zero1_layout``),
or all-reduced where its moments are whole (``cfg.zero1`` off, or no
dimension ZeRO-1 can split).  Adam updates the shards, the norm sums
them over the grid, and each split leaf's new parameter is all-gathered
over ``data`` into the rank's block, in place.  The loss is the global
batch's mean on every rank (one float32 all-reduce over ``data``).  A
rank whose backward or shard update fails makes every rank raise
(``collectives.agree_or_raise``) before any rank enters the next
exchange over ``data``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping

import torch

from ..core import collectives as coll
from ..distributed_lm.sharding import leaf_spec, spec_axes
from ..models.common import ArchConfig
from ..models.layers import partial_grad
from .optimizer import AdamConfig, adam_update, zero1_layout

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
    tensor- or data-parallel model (its ``model`` or ``data`` axis over
    1), else ``None``; raises where that step is not ported."""
    ranks = getattr(model, "ranks", None)
    if ranks is None or math.prod(ranks.dims) == 1:
        return None
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"training a {cfg.family!r} model on ranks (its gathers' and "
            f"split scans' backwards) is not ported (ROADMAP.md, "
            f"A10d-5b-3b)")
    if opt_cfg.use_8bit:
        raise NotImplementedError("8-bit moments on ranks are not ported "
                                  "(ROADMAP.md, A10d-5b-3c)")
    if cfg.family == "moe" and cfg.moe_capacity:
        raise NotImplementedError("capacity dispatch (moe_capacity) on "
                                  "ranks is not ported (ROADMAP.md, "
                                  "A10d-5c-3)")
    if cfg.family == "moe" and cfg.expert_sharding == "model+data" \
            and ranks.shape.get("data", 1) > 1:
        raise NotImplementedError(
            "'model+data' experts with the ranks' data axis over 1 are not "
            "ported (ROADMAP.md, A10d-5c-2)")
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


def _reduce_over_data(grads: Dict[str, torch.Tensor], layout, ranks
                      ) -> None:
    """Each leaf's gradient (float32, the rank's local mean) replaced in
    place by the global mean over ``data``: its ZeRO-1 shard (one
    reduce-scatter a leaf of the reference's tree), or whole (one
    all-reduce) where its moments are; a stacked group's layers cross
    as one ``[L, ...]`` tensor.  The keys of layers whose moments the
    rank does not hold are dropped."""
    n = ranks.shape["data"]
    for leaf in layout.leaves:
        parts = [grads[k].float() for k in leaf.keys]
        g = torch.stack(parts) if leaf.stacked else parts[0]
        if leaf.dim is None:
            g = coll.all_reduce_sum(g, ranks, "data").div_(n)
            for i, k in enumerate(leaf.keys):
                grads[k] = g[i] if leaf.stacked else g
            continue
        shard = coll.reduce_scatter_sum(g, ranks, "data", leaf.dim).div_(n)
        for i, k in enumerate(leaf.keys):
            if not layout.holds(k):
                del grads[k]
            elif not leaf.stacked:
                grads[k] = shard
            else:
                grads[k] = shard[i - leaf.lo if leaf.dim == 0 else i]


@torch.no_grad()
def _gather_over_data(params: Dict[str, torch.Tensor], layout,
                      ranks) -> None:
    """Each split leaf's new parameter (the rank's shard, written by the
    update) all-gathered over ``data`` into the rank's block, in place:
    one all-gather a leaf of the reference's tree."""
    for leaf in layout.leaves:
        if leaf.dim is None:
            continue
        mine = [layout.shard(k, params[k]) for k in leaf.keys
                if layout.holds(k)]
        block = torch.stack(mine) if leaf.stacked else mine[0]
        whole = coll.all_gather_panel(block, ranks, "data", leaf.dim)
        for i, k in enumerate(leaf.keys):
            params[k].copy_(whole[i] if leaf.stacked else whole)


def make_train_step(model, cfg: ArchConfig, opt_cfg: AdamConfig
                    ) -> Callable:
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` leaves (tensors or arrays) are [B_global, ...]
    and B must divide by ``cfg.microbatch``; ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-d float32 tensors.  On ranks (module
    docstring) every rank passes the same batch and gets the same
    metrics; on a ``data`` axis over 1 each microbatch's rows must split
    over it, and ``opt_state`` must be ``adam_init(params, opt_cfg,
    zero1_layout(model, opt_cfg, cfg.zero1))``."""
    nm = max(cfg.microbatch, 1)
    ranks = _rank_split(model, cfg, opt_cfg)
    # the data-parallel step's shards: None where no data axis splits
    layout = zero1_layout(model, opt_cfg, cfg.zero1)
    n_data = ranks.shape["data"] if layout is not None else 1
    at = ranks.axis_index("data") if layout is not None else 0
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
        if per % n_data:
            raise ValueError(f"a microbatch of {per} rows does not split "
                             f"over the data axis of {n_data}")
        if layout is not None and set(opt_state["m"]) != {
                k for k in params if layout.holds(k)}:
            raise ValueError("opt_state is not this rank's ZeRO-1 shard: "
                             "adam_init(params, cfg, zero1_layout(model, "
                             "cfg, zero1))")
        rows = per // n_data
        for p in params.values():
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        error = None
        try:
            with torch.enable_grad():
                for i in range(nm):
                    lo = i * per + at * rows
                    mb = {k: v[lo:lo + rows] for k, v in batch.items()}
                    loss = model.loss(mb)
                    loss.backward()
                    loss_sum += loss.detach().float()
        except Exception as exc:         # every rank must hear of it
            if layout is None:
                raise
            error = exc
        if layout is not None:
            coll.agree_or_raise(ranks, "the backward", error)
        grads = {k: (p.grad.div_(nm) if p.grad is not None
                     else torch.zeros_like(p, dtype=torch.float32))
                 for k, p in params.items()}
        loss = loss_sum / nm
        if ranks is not None:
            _sum_partial_grads(grads, partial, ranks)
        if layout is not None:
            loss = coll.all_reduce_sum(loss.reshape(1), ranks,
                                       "data")[0] / n_data
            _reduce_over_data(grads, layout, ranks)
        error = None
        try:
            params, opt_state, metrics = adam_update(
                params, grads, opt_state, opt_cfg, ranks, replicated, layout)
        except Exception as exc:         # every rank must hear of it
            if layout is None:
                raise
            error = exc
        if layout is not None:
            coll.agree_or_raise(ranks, "the ZeRO-1 shard update", error)
            _gather_over_data(params, layout, ranks)
        for p in params.values():
            p.grad = None
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_eval_step(model) -> Callable:
    @torch.no_grad()
    def eval_step(params: Mapping[str, torch.Tensor],
                  batch: Mapping[str, Any]) -> torch.Tensor:
        _check_params(model, params)
        return model.loss(_on(model, batch))
    return eval_step
