"""The LM dry-run: every (arch x shape x mesh) cell priced on the
production mesh, and one device's share of a cell run on the card.

Counterpart of ``repro/launch/dryrun.py``: the same cells (``main``),
flags, file names (``{module}__{shape}__{sp|mp}[__tag].json``), status
lines and record keys.  The reference lowers and compiles each cell's
step over ``jax.ShapeDtypeStruct`` stand-ins and reads XLA's memory
analysis, cost analysis and HLO.  The port compiles nothing: it reads the
same step's arguments from the ``ShapeDtype`` records of
``distributed_lm.sharding`` and their specs, on a ``LogicalMesh``
(``launch/mesh.make_production_mesh``, or ``core/mesh.make_mesh`` for
``mesh_shape``).  What each record holds, against the reference's:

* ``arch``, ``shape``, ``multi_pod``, ``status``, ``reason``,
  ``mesh_shape``, ``n_devices``, ``model_params`` and
  ``model_params_active`` are the reference's.
* ``memory.argument_bytes``: the per-device bytes of the arguments the
  step reads.  ``train``: the parameters (``shard_params``), the Adam
  state (``adam_init``'s shapes, split by ``opt_state_specs``: ZeRO-1
  and 8-bit moments as configured) and the batch (``input_structs``).
  ``prefill``: the parameters and the batch's inputs (the prefill step
  never reads ``labels``, and XLA drops an argument the step does not
  read).  ``decode``: the parameters the decode step reads (not LLaVA's
  projector, nor Whisper's encoder and cross-attention K/V projections,
  whose output the cross cache holds), the cache (``cache_structs``), the
  ``[B, 1]`` int32 tokens and the int32 ``pos`` (which Mamba's step does
  not read).  A dimension of size
  ``d`` split over ``k`` devices takes ``ceil(d / k)`` entries on each,
  as XLA's shards do.  Equal to the reference's on the cells the tests
  compare.
* ``memory.output_bytes``: the same rule over the step's outputs, plus 8
  bytes a leaf for the output tuple's index table where the step returns
  more than one array, as XLA counts it.  ``prefill``: the last-position
  logits ``[B, V]`` in the compute dtype, batch-split, and vocab-split
  where the head's vocab dimension is.  ``decode``: ``[B, 1, V]`` logits
  so split and the new cache, split as the old.  ``train``: the new
  parameters, each split as its moments are (the update is elementwise
  on the ZeRO-1 shards, and XLA leaves its result there), the new Adam
  state, the int32 step count and the three float32 metrics.  The field
  is ``None`` where no rule reproduces the reference's number: the
  hybrid's decode (XLA splits the single-head K/V window it returns over
  ``model`` on the head dimension, which the cache's spec leaves whole:
  a choice of its own) and training with 8-bit moments (not held to a
  reference number).
* ``memory.temp_bytes``, ``memory.generated_code_bytes``, ``lower_s``,
  ``compile_s``, ``flops``, ``bytes_accessed`` and ``loops`` are
  ``None``: nothing is lowered or compiled, so there is no memory plan,
  cost analysis or HLO.  ``keep_hlo`` is accepted and does nothing (no
  ``hlo_len`` / ``_hlo``).
* ``collective`` / ``collective_executed`` (``bytes``, ``counts``,
  ``total_bytes`` over the reference's five kinds) are a closed form of
  what a partition by these specs must move per device, in the
  reference's units (an op's result bytes).  They are not the
  reference's numbers, which are XLA's own choices on its mesh
  (``docs/ARCHITECTURE_TORCH.md`` gives the ratios).  With ``t`` tokens
  a device holds per microbatch and ``a`` the compute dtype's bytes; a
  partial sum (every all-reduce below but the embedding's and the
  float32 statistics of a softmax or a loss) crosses in float32, 4
  bytes a value, and is rounded once to the compute dtype, as the ranks
  run it (``models.layers.sum_partials``):

  - row-split denses: every dense weight whose contraction dimension is
    split over ``model`` (attention out, MLP down, Mamba's ``x_proj`` /
    ``out_proj``, RG-LRU's ``out``, Whisper's ``fc2``, the shared
    experts' and arctic's dense residual's down) ends in an all-reduce
    over ``model`` of its ``[t, d_out]`` output.  Training adds one for
    the remat recompute (``remat`` with policy ``"full"``) and one in the
    backward: the gradient entering each column-split group
    (``models.layers.enter_split``: attention's ``wq`` / ``wk`` / ``wv``
    input, the MLP's gate / up input), one a row-split dense, with one
    float32 status word beside it (``collectives.
    all_reduce_sum_checked``).  Mamba's
    ``in_proj`` moves nothing: its spec splits the fused ``[xs | z]``
    columns, and a rank holds its channels' columns of each half
    (``layers.Fused``), the same bytes as a contiguous block, where the
    reference's XLA moves columns to halve a contiguous block;
  - FFN-split MoE (``w_down`` split over ``model`` on its hidden
    dimension): the gated sum of every expert's partial output, one
    all-reduce of ``[t, d]`` in each forward pass and the remat
    recompute (``models/layers._experts_on_ranks``); training's backward
    sums the tokens' and the gates' partial gradients where they enter,
    one float32 panel ``[t, d + top_k]`` and its status word;
  - expert-parallel MoE (experts split over ``model``; ``k`` the axis):
    each rank sends its ``ceil(t / k)`` tokens' ``top_k`` rows to their
    experts' ranks and gets them back, an all-to-all each way whose
    result holds, on the line's mean, ``[t x top_k / k, d]`` (every
    (token, slot) row crosses once each way over the line; a rank's own
    share follows the routing, so a run's counted all-to-all bytes equal
    ``k`` times this term summed over each ``model`` line, and its calls
    and every other term rank by rank: ``closed_form_mismatch``), then
    one all-gather of the gated slices ``[k x ceil(t / k), d]``, in each
    forward pass and the remat recompute; training's backward runs both
    all-to-alls in reverse (the same bytes) and all-gathers the
    gradients of the rank's token rows and their gates, one float32
    panel ``[k x ceil(t / k), d + top_k]``;
  - a MoE layer's load-balancing loss in a training step whose batch is
    split: the expert density of the whole microbatch, one float32
    all-reduce of ``[n_experts]`` over the batch axes in each forward
    pass and the remat recompute (any ``model`` axis);
  - the input embedding: an all-reduce of ``[t, d]`` in the compute
    dtype where the vocab is split (one rank holds each token's row: the
    sum is exact), an all-gather where ``d_model`` is (Whisper);
  - the head: with a vocab-split head, training all-reduces the loss's
    three float32 statistics ``[t]`` (max, sum of exponentials, the
    label's logit: ``models.layers.cross_entropy_vocab_split``) and, in
    the backward, the ``[t, d]`` input gradient and its status word;
    prefill and decode leave the logits vocab-split, as the step's
    result.  A head contracted over a split ``d_model`` (Whisper's tied
    embedding) all-reduces its ``[t, V]`` logits, in pieces of
    ``models.whisper.HEAD_CHUNK_TOKENS`` tokens (one all-reduce each; a
    whole ``[t, V]`` float32 partial would hold some 850 MB at 4,096
    tokens on every rank);
  - a decode's self-attention against a cache whose sequence is split
    over ``model`` (every attention family's decode cell but the
    hybrid's window): each layer all-gathers the new q, k and v over
    ``model`` (``[t, (h + 2 kv) hd]``: every head on every rank), then
    all-reduces the scores' max and their exponentials' sum ``[t, h]``
    (float32) and the weighted values ``[t, h, hd]``, the exact softmax
    over every rank's slots, before the row-split ``wo``;
  - all-gathers over ``model`` of a column-split input, each in the
    compute dtype, in every forward pass and the remat recompute (a
    training backward reduce-scatters its float32 gradient, ``[t, w /
    k]``): RG-LRU's gates ``w_a`` / ``w_i`` contract over the whole
    ``d_rnn`` while a rank holds ``d_rnn / k`` channels of the conv
    output, so each rec block gathers ``[t, d_rnn]``; KV heads that the
    axis does not split (``n_kv_heads % k``; a rank's column block of
    ``wk`` / ``wv`` is part of one head, as the hybrid's one KV head),
    so each attention layer gathers the new k and v as one panel ``[t,
    2 kv hd]``, and a decode against a cache whole on every rank does
    so whatever the axis (every rank writes the whole new K/V into its
    copy of the hybrid's window, which the cache's spec leaves whole);
    ``models.layers.gathers_kv`` decides both, for the ranks and this
    count, in every family (``_run_rule`` runs such cells for the
    hybrid only);
  - Whisper's cross cache: a decode cell reads a seeded cache, replicated
    over ``model``, with each rank's own heads, which moves nothing but
    the row-split ``wo``'s all-reduce (``prefill_cross`` on ranks
    all-gathers each layer's new cross K/V; no cell runs it);
  - LLaVA's projector: its row-split ``fc2`` all-reduces ``[p, d]`` over
    the ``p`` patches, once a forward (outside the remat blocks; its
    backward passes the gradient through, and ``fc1`` reads constant
    patch embeddings, whose gradient no step needs);
  - a training step over a split ``model``, once a step, float32: one
    all-reduce of the gradients of the replicated leaves a rank applies
    to its own heads (``models.layers.partial_grad``: the qk norms), if
    the model has any;
  - the gradient reduction over the batch axes, once a step, float32,
    one collective a leaf of the reference's tree (a stacked group's
    layers together): a leaf that ZeRO-1 splits over ``data`` is
    reduce-scattered over ``data`` (result: its moment's shard),
    all-reduced over ``pod`` if there is one, and the new parameter
    all-gathered over ``data`` (result: the device's block of the
    parameter, in its dtype); any other leaf is all-reduced over the
    batch axes it is not split on (``train.train_step``);
  - the step's metrics, once a step, float32: where the batch is split,
    one all-reduce of the loss's single value over the batch axes (the
    global batch's mean on every device), and where ``model`` is split
    or ZeRO-1 shards a leaf over ``data``, one of the global norm's sum
    of squares over every axis that splits a gradient (a single value:
    ``train.optimizer.global_norm``).

  ``collective`` counts each layer stack's body (a layer, or the
  hybrid's group) once, and one microbatch, as the reference's flat
  count does; ``collective_executed`` multiplies the bodies by their
  layers and every per-microbatch term by the microbatches.

With ``run=True`` a cell runs one device's share (``_run_rule`` says
which can; any other records why in ``run_reason`` and runs nothing).
In one process, on ``device``, a cell whose mesh has a ``model`` axis of
1 (a ``pod`` axis only splits the batch): the model at the cell's
config, weights from seed 0, the batch ``global_batch / (pod x data)``
at the cell's ``seq_len`` (seeded), through ``make_train_step`` /
``make_prefill_step`` / ``make_serve_step``; decode against a seeded
cache of ``cache_structs``' shapes at ``pos = seq_len - 1``.  On ranks
(``ranks``, a ``ProcessMesh`` over (``data``, ``model``); every rank
calls ``lower_cell`` with the same arguments) a serving cell whose
``model`` axis equals the ranks': each rank runs exactly what one device
of the cell's mesh runs, tensor-parallel where ``model`` is split (a
``dense``, ``moe`` or ``vlm`` transformer whose every split the axis
makes exact, ``_run_rule``; ``"model+data"`` experts only where the
ranks' ``data`` axis is 1, so a rank holds ``n_experts / k`` whole
experts, where a device of a cell mesh with a wider ``data`` axis holds
their hidden dimension split over it, which no collective over
``model`` sees): its block of every parameter under
``param_specs()``, drawn whole from the one-process model's generator
leaf by leaf (``models.layers.draw``), its block of the cache (its rows,
its sequence slots, its channels of a recurrent state; the hybrid's window
and Whisper's cross cache whole) and its share of the batch (the
ranks' ``data``
axis covers as many consecutive data rows of the cell's mesh, drawn
together from seed 1), with the collectives of the closed form above
over ``model`` (``core/collectives.py``; ``models/layers.py`` under
``sharding_mesh``).  Its logits stay vocab-split; the whole logits are
gathered after the timed passes (Whisper's come out whole: its head
sums them over ``model``).  A training cell on ranks (a ``dense``,
``moe`` or ``vlm`` transformer, the ranks' ``data`` axis the cell's
batch blocks: ``_run_rule``)
runs the rank's step (``train.train_step``) on a model that holds the
whole grid: its blocks of the parameters, its ZeRO-1 shards of the Adam
moments where ``data`` is over 1 (``train.optimizer.zero1_layout``),
the whole global batch on every rank (drawn together from seed 1, each
microbatch cut to the data coordinate's rows by the step), the
backward's collectives and the gradient's reduction over ``data`` of
the closed form.  A rank whose share fails makes every rank raise
(``collectives.agree_or_raise``) where no rank is left inside a
collective, and so does a rank whose share of a backward sum fails (its
status word); there is no fallback to one process.

A run adds ``run_batch``, ``run_s`` (CUDA events, the median of
``run_reps`` (3 by default) after 1 warm-up; ``None`` off the card),
``run_times_s``, ``run_flops`` (``FlopCounterMode`` over the untimed
warm-up), ``peak_bytes`` (``torch.cuda.max_memory_allocated`` over
the timed passes; ``None`` off the card) and ``run_bound_s``: the larger
of ``analytic_cell_model``'s flops over ``PEAK_FLOPS`` and its HBM bytes
over ``HBM_BW`` at the device's batch on one chip (the work the card
does), divided by the ``model`` axis on ranks (the work splits evenly).
On ranks ``run_s`` is the slowest rank's, ``peak_bytes`` the largest,
and the run adds ``run_ranks`` (each rank's ``run_s``,
``run_exchange_s``, ``peak_bytes``, ``run_flops``), ``run_exchange_s``
(the slowest rank's host seconds inside collectives in a timed pass)
and ``run_collective`` (each rank's ``ProcessMesh.tally`` of one timed
pass, in the closed form's kinds and units, equal to
``collective_executed`` as ``closed_form_mismatch`` holds it).  Four
ranks that share one card run one after another on it, so their
``run_s`` is not what four cards would take.
``run_checks`` lists what held: every output finite; ``train``: every
parameter changed; ``prefill``: logits ``[run_batch, vocab]`` (the
rank's vocab block on ranks where the head splits the vocab);
``decode``: each attention cache changed at ``pos`` and nowhere else
(the hybrid's rolling window at ``pos % window``, on every rank; on
ranks, a sequence-split cache on the rank whose slots hold ``pos``,
every other rank's cache unchanged), a cross-attention cache not at
all, each recurrent state (Mamba's ``conv`` / ``ssm``, RG-LRU's
``conv*`` / ``h*``) advanced in every channel it holds (the rank's on
ranks) of every layer, the hybrid's placeholder tail slot (no trailing
blocks) unchanged; on ranks also every all-reduced tensor of the
warm-up byte-equal on the ranks of a ``model`` line (by
``collectives.digest``), so is every MoE layer's routing (its experts
and gates, ``Tally.route``) and the hybrid's window after the passes,
and the gathered logits equal on every rank; a training step on ranks
also: every parameter's gradient non-zero somewhere before the warm-up
step's update (read by a hook as it accumulates: weight decay moves a
parameter whose gradient a cut backward zeroed, so "changed" alone
would not see the cut), every leaf whole on every rank (replicated)
byte-equal along the ``model`` line after the passes, every parameter
block byte-equal along the ``data`` line, each pass's loss and gradient
norm equal on every rank, and every rank's counted collectives equal to
the closed form's (``closed_form_mismatch``).  A failed check raises.

  python -m repro_torch.launch.dryrun --all --out build/dryrun --device cpu
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --mesh-shape 64,1 --run
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import convert
from ..benchmarks import roofline
from ..configs import ALIASES, get_config
from ..core.mesh import make_mesh
from ..device import DeviceLike, resolve_device
from ..core import collectives as coll
from ..distributed_lm.sharding import (ShapeDtype, batch_axes, batch_block,
                                       cache_block, cache_structs,
                                       head_vocab_split, input_structs,
                                       named, shard_params)
from ..distributed_lm.sharding import spec_axes as _axes
from ..distributed_lm.sharding import spec_entries as _entries
from ..models import build_model
from ..models import whisper as _whisper
from ..models.layers import P, gathers_kv, partial_grad, torch_dtype
from ..serve.serve_step import (make_prefill_step, make_serve_step,
                                whole_logits)
from ..train.optimizer import (AdamConfig, adam_init, opt_state_specs,
                               zero1_layout)
from ..train.train_step import make_train_step, model_params
from .mesh import make_production_mesh
from .shapes import SHAPES, ShapeCell, cell_applicable

__all__ = ["COLLECTIVE_KINDS", "shard_shape", "leaf_bytes",
           "step_arguments", "argument_bytes", "output_bytes",
           "collective_closed_form", "closed_form_mismatch", "run_cell",
           "lower_cell", "main"]

# the reference's collective kinds (``launch/hlo_analysis.py``), in order
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# XLA's output tuple holds one 8-byte buffer pointer a leaf
_TUPLE_ENTRY_BYTES = 8
# a partial sum crosses in float32 (``models.layers.sum_partials``)
_PARTIAL = 4
# timed passes of a run, by default
_RUN_REPS = 3
# parameters a decode step never reads: LLaVA's projector (no patches in
# decode), Whisper's encoder and its cross-attention K/V projections (the
# cross cache holds their output)
_NOT_READ_BY_DECODE = (("vision_proj",), ("enc_blocks",), ("enc_ln",),
                       ("dec_blocks", "cross_attn", "wk"),
                       ("dec_blocks", "cross_attn", "wv"))


# ---------------------------------------------------------------------------
# per-device bytes of records
# ---------------------------------------------------------------------------

def shard_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """One device's block of an array of ``shape`` split by ``spec``: a
    dimension of size ``d`` over ``k`` devices keeps ``ceil(d / k)``."""
    out = []
    for d, e in zip(shape, _entries(spec, len(shape))):
        k = math.prod(mesh.shape[a] for a in _axes(e))
        out.append(-(-int(d) // k))
    return tuple(out)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def leaf_bytes(rec: ShapeDtype) -> int:
    """Per-device bytes of ``rec`` under its spec."""
    return math.prod(shard_shape(rec.shape, rec.sharding.spec,
                                 rec.sharding.mesh)) * _itemsize(rec.dtype)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _drop(tree, prefixes, path=()):
    """``tree`` without the subtrees at ``prefixes`` (key paths)."""
    if not isinstance(tree, dict):
        return tree
    return {k: _drop(v, prefixes, path + (k,)) for k, v in tree.items()
            if path + (k,) not in prefixes}


def _tree_bytes(tree) -> int:
    return sum(leaf_bytes(r) for _, r in _leaves(tree))


# ---------------------------------------------------------------------------
# the step's arguments and outputs
# ---------------------------------------------------------------------------

def _zip_leaves(fn, tree, other):
    """``fn(leaf, other_leaf)`` over ``tree`` (nested dicts and lists),
    walking ``other`` alongside; ``other``'s leaves may be subtrees."""
    if isinstance(tree, dict):
        return {k: _zip_leaves(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_leaves(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def _opt_records(params, param_specs, opt_cfg: AdamConfig, mesh,
                 zero1: bool) -> Tuple[Dict, Dict]:
    """(Adam state records, their specs): ``adam_init``'s shapes, leaf by
    leaf on ``meta`` tensors, split by ``opt_state_specs``."""
    specs = opt_state_specs(param_specs, params, opt_cfg,
                            data_size=mesh.shape["data"], zero1=zero1)

    def moments(slot):
        def one(rec, spec):
            leaf = adam_init({"p": torch.empty(rec.shape, dtype=rec.dtype,
                                               device="meta")},
                             opt_cfg)[slot]["p"]
            if isinstance(leaf, dict):                 # 8-bit codes, scale
                return {k: ShapeDtype(tuple(t.shape), t.dtype,
                                      named(mesh, spec[k]))
                        for k, t in leaf.items()}
            return ShapeDtype(tuple(leaf.shape), leaf.dtype,
                              named(mesh, spec))
        return _zip_leaves(one, params, specs[slot])

    state = {"m": moments("m"), "v": moments("v"),
             "count": ShapeDtype((), torch.int32, named(mesh, P()))}
    return state, specs


def step_arguments(cfg, shape: ShapeCell, mesh, model) -> Dict[str, Any]:
    """The records of the arguments the cell's step reads, by group:
    ``params`` and, by kind, ``opt_state`` + ``batch`` (train), ``batch``
    without ``labels`` (prefill), or ``cache`` + ``tokens`` + ``pos``
    (decode); ``opt_specs`` rides along for train."""
    params = shard_params(model, mesh)
    out: Dict[str, Any] = {"params": params}
    if shape.kind == "train":
        out["opt_state"], out["opt_specs"] = _opt_records(
            params, model.param_specs(), AdamConfig(use_8bit=cfg.opt_8bit),
            mesh, cfg.zero1)
        out["batch"] = input_structs(cfg, mesh, shape.global_batch,
                                     shape.seq_len)
    elif shape.kind == "prefill":
        batch = input_structs(cfg, mesh, shape.global_batch, shape.seq_len)
        batch.pop("labels")
        out["batch"] = batch
    else:
        long_ctx = shape.name.startswith("long")
        out["params"] = _drop(params, _NOT_READ_BY_DECODE)
        out["cache"] = cache_structs(model, cfg, mesh, shape.global_batch,
                                     shape.seq_len, long_ctx)
        ba = P(batch_axes(mesh)) if not long_ctx else P()
        out["tokens"] = ShapeDtype((shape.global_batch, 1), torch.int32,
                                   named(mesh, ba))
        if cfg.family != "ssm":
            out["pos"] = ShapeDtype((), torch.int32, named(mesh, P()))
    return out


def argument_bytes(args: Dict[str, Any]) -> int:
    return sum(_tree_bytes(v) for k, v in args.items() if k != "opt_specs")


def output_bytes(cfg, shape: ShapeCell, mesh,
                 args: Dict[str, Any]) -> Optional[int]:
    """Per-device bytes of the step's outputs (module docstring), or
    ``None`` where the rule was not held to the reference's."""
    dt = torch_dtype(cfg.compute_dtype)
    long_ctx = shape.name.startswith("long")
    ba = batch_axes(mesh) if not long_ctx else None
    vocab = "model" if head_vocab_split(args["params"]) else None
    if shape.kind == "prefill":
        logits = ShapeDtype((shape.global_batch, cfg.vocab), dt,
                            named(mesh, P(ba, vocab)))
        return leaf_bytes(logits)
    if shape.kind == "decode":
        if cfg.family == "hybrid":
            return None
        logits = ShapeDtype((shape.global_batch, 1, cfg.vocab), dt,
                            named(mesh, P(ba, None, vocab)))
        leaves = [logits] + [r for _, r in _leaves(args["cache"])]
    else:
        if cfg.opt_8bit:
            return None
        params, state = args["params"], args["opt_state"]
        leaves = [ShapeDtype(r.shape, r.dtype,
                             _get(state["m"], path).sharding)
                  for path, r in _leaves(params)]
        leaves += [r for _, r in _leaves(state)]
        leaves += [ShapeDtype((), torch.float32, named(mesh, P()))] * 3
    return sum(leaf_bytes(r) for r in leaves) \
        + _TUPLE_ENTRY_BYTES * len(leaves)


# ---------------------------------------------------------------------------
# the collective closed form
# ---------------------------------------------------------------------------

class _Tally:
    def __init__(self):
        self.bytes = {k: 0 for k in COLLECTIVE_KINDS}
        self.counts = {k: 0 for k in COLLECTIVE_KINDS}

    def add(self, kind: str, nbytes: int, count: int = 1, times: int = 1):
        self.bytes[kind] += int(nbytes) * count * times
        self.counts[kind] += count * times

    def merge(self, other: "_Tally", times: int = 1):
        for k in COLLECTIVE_KINDS:
            self.bytes[k] += other.bytes[k] * times
            self.counts[k] += other.counts[k] * times

    def record(self) -> Dict[str, Any]:
        return {"bytes": dict(self.bytes), "counts": dict(self.counts),
                "total_bytes": int(sum(self.bytes.values()))}


def _gathered(out: "_Tally", elems: int, act: int, passes: int,
              k: int) -> None:
    """An all-gather over ``model`` whose result holds ``elems`` values in
    the compute dtype, in each forward pass (and the remat recompute);
    training's backward reduce-scatters its float32 gradient (result
    ``ceil(elems / k)`` values)."""
    out.add("all-gather", elems * act, times=max(passes - 1, 1))
    if passes > 1:
        out.add("reduce-scatter", -(-elems // k) * _PARTIAL)


def _body_terms(recs, cfg, tokens: int, act: int, passes: int,
                k: int, whole_kv: bool = False,
                cross_tokens: int = 0) -> _Tally:
    """One body's model-axis collectives for ``tokens`` tokens, over
    ``passes`` passes, on a ``model`` axis of ``k`` (module docstring);
    ``recs`` are the body's parameter records, each with its spec.
    ``whole_kv``: a decode whose cache every rank holds whole (the
    hybrid's window); ``cross_tokens``: the encoder positions a
    cross-attention's k and v are projected from."""
    out = _Tally()
    for path, rec in _leaves(recs):
        spec = _entries(rec.sharding.spec, len(rec.shape))
        if path[-1] == "w":
            if "model" in _axes(spec[-2]) and \
                    "model" not in _axes(spec[-1]):
                out.add("all-reduce", tokens * rec.shape[-1] * _PARTIAL,
                        times=max(passes - 1, 1))
                if passes > 1:              # the backward's, and its status
                    out.add("all-reduce",
                            (tokens * rec.shape[-1] + 1) * _PARTIAL)
            if path[-2] == "w_a" and "model" in _axes(spec[-1]):
                # RG-LRU's gates read the whole conv output
                _gathered(out, tokens * rec.shape[-2], act, passes, k)
            if path[-2] == "wk" and gathers_kv(cfg, k, whole_kv):
                # the new k and v, every KV head
                t_kv = cross_tokens if "cross_attn" in path else tokens
                _gathered(out, t_kv * 2 * rec.shape[-1], act, passes, k)
        elif path[-1] == "w_down":
            d, top = rec.shape[-1], cfg.top_k
            fwd = max(passes - 1, 1)
            if "model" in _axes(spec[-3]):          # experts over model
                rows, a2a = k * -(-tokens // k), tokens * top * d * act // k
                out.add("all-to-all", a2a, count=2, times=fwd)
                out.add("all-gather", rows * d * act, times=fwd)
                if passes > 1:       # the reverse exchanges, the rows' entry
                    out.add("all-to-all", a2a, count=2)
                    out.add("all-gather", rows * (d + top) * _PARTIAL)
            elif "model" in _axes(spec[-2]):        # FFN-split experts
                out.add("all-reduce", tokens * d * _PARTIAL, times=fwd)
                if passes > 1:        # tokens and gates entering, and status
                    out.add("all-reduce",
                            (tokens * (d + top) + 1) * _PARTIAL)
    return out


def _decode_attention_terms(cfg, tokens: int, act: int) -> _Tally:
    """One decode layer's attention against a cache whose sequence is
    split over ``model`` (``models/layers._decode_on_ranks``), for
    ``tokens`` tokens: one all-gather of the new q, k and v
    ``[t, (h + 2 kv) hd]``, all-reduces of the scores' max and of their
    exponentials' sum ``[t, h]`` (float32) and of the weighted values
    ``[t, h, hd]``."""
    out = _Tally()
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out.add("all-gather", tokens * (h + 2 * kv) * hd * act)
    out.add("all-reduce", tokens * h * 4, count=2)
    out.add("all-reduce", tokens * h * hd * _PARTIAL)
    return out


def collective_closed_form(cfg, shape: ShapeCell, mesh,
                           args: Dict[str, Any]
                           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(``collective``, ``collective_executed``) of the cell: the module
    docstring's terms, per device."""
    kind = shape.kind
    long_ctx = shape.name.startswith("long")
    act = _itemsize(torch_dtype(cfg.compute_dtype))
    split_model = mesh.shape.get("model", 1) > 1
    baxes = batch_axes(mesh)
    nb = 1 if long_ctx else math.prod(mesh.shape[a] for a in baxes)
    b_loc = -(-shape.global_batch // nb)
    nm = max(cfg.microbatch, 1) if kind == "train" else 1
    b = -(-b_loc // nm)
    seq = 1 if kind == "decode" else shape.seq_len
    t_dec = b * seq
    npatch = min(cfg.num_patches, shape.seq_len // 2) if cfg.vision_dim \
        else 0
    t_text = b * (seq - npatch) if kind != "decode" else t_dec
    passes = 1
    if kind == "train":
        passes = 2 + (1 if cfg.remat and cfg.remat_policy == "full" else 0)
    # the parameters the step reads (decode leaves some out)
    recs = args["params"]
    flat, executed = _Tally(), _Tally()
    # the layer stack whose self-attention reads a decode cache split
    # over model along its sequence
    seq_split = None
    cache_k = args.get("cache", {}).get("k")
    if cache_k is not None and "model" in _axes(
            _entries(cache_k.sharding.spec, len(cache_k.shape))[2]):
        seq_split = "dec_blocks" if "dec_blocks" in recs else "blocks"
    if split_model:
        for key in convert.STACKED + ("tail",):
            if key not in recs:
                continue
            tokens = b * cfg.enc_frames if key == "enc_blocks" else t_dec
            for r in (recs[key] if key == "tail" else [recs[key]]):
                body = _body_terms(r, cfg, tokens, act, passes,
                                   mesh.shape["model"],
                                   whole_kv=kind == "decode"
                                   and key != seq_split,
                                   cross_tokens=b * cfg.enc_frames)
                if key == seq_split:
                    body.merge(_decode_attention_terms(cfg, tokens, act))
                trips = 1 if key == "tail" else \
                    next(iter(_leaves(r)))[1].shape[0]
                flat.merge(body)
                executed.merge(body, trips * nm)
        head = _Tally()
        d, v = cfg.d_model, cfg.vocab
        emb = _entries(recs["embed"].sharding.spec, 2)
        if "model" in _axes(emb[0]):
            head.add("all-reduce", t_text * d * act)
        elif "model" in _axes(emb[1]):
            head.add("all-gather", t_text * d * act)
        if head_vocab_split(recs):
            if kind == "train":
                head.add("all-reduce", t_dec * 4, count=3)
                head.add("all-reduce", (t_dec * d + 1) * _PARTIAL)
        else:
            # summed HEAD_CHUNK_TOKENS tokens at a time
            chunk = _whisper.HEAD_CHUNK_TOKENS
            for t0 in range(0, t_dec, chunk):
                head.add("all-reduce", min(chunk, t_dec - t0) * v * _PARTIAL)
        if "vision_proj" in recs:
            w = recs["vision_proj"]["fc2"]["w"]
            head.add("all-reduce", b * npatch * w.shape[-1] * _PARTIAL)
        flat.merge(head)
        executed.merge(head, nm)
    if kind == "train" and cfg.family == "moe" and nb > 1:
        # each MoE layer's expert density over the batch axes
        density = _Tally()
        density.add("all-reduce", cfg.n_experts * 4,
                    times=max(passes - 1, 1))
        flat.merge(density)
        executed.merge(density, cfg.n_layers * nm)
    if kind == "train":
        grads = _Tally()
        state = args["opt_specs"]
        for path, rec in _leaves(recs):
            pspec = rec.sharding.spec
            used = {a for e in pspec for a in _axes(e)}
            red = [a for a in baxes if a not in used and mesh.shape[a] > 1]
            if not red:
                continue
            mspec = _get(state["m"], path)
            if isinstance(mspec, dict):
                mspec = mspec["codes"]
            scattered = cfg.zero1 and "data" in red and "data" in {
                a for e in mspec for a in _axes(e)}
            if scattered:
                shard = math.prod(shard_shape(rec.shape, mspec, mesh)) * 4
                grads.add("reduce-scatter", shard)
                if "pod" in red:
                    grads.add("all-reduce", shard)
                grads.add("all-gather", leaf_bytes(rec))
            else:
                grads.add("all-reduce",
                          math.prod(shard_shape(rec.shape, pspec, mesh)) * 4)
        if split_model:
            # the replicated leaves a rank applies to its own heads hold a
            # partial gradient: one float32 all-reduce of them all
            part = sum(math.prod(rec.shape) * 4 for path, rec in _leaves(recs)
                       if partial_grad(path) and "model" not in {
                           a for e in rec.sharding.spec for a in _axes(e)})
            if part:
                grads.add("all-reduce", part)
        if nb > 1:
            # the loss's one float32 value, the global batch's mean
            grads.add("all-reduce", 4)
        if split_model or grads.counts["reduce-scatter"]:
            # the global norm's one float32 value
            grads.add("all-reduce", 4)
        flat.merge(grads)
        executed.merge(grads)
    return flat.record(), executed.record()


# ---------------------------------------------------------------------------
# one device's share on the card, in one process or on ranks
# ---------------------------------------------------------------------------

def _batch_rows(mesh, shape: ShapeCell) -> int:
    """The cell mesh's batch blocks (its batch axes' product; 1 for a
    long-context decode, whose batch is not split)."""
    if shape.name.startswith("long"):
        return 1
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def _run_rule(mesh, cfg, shape: ShapeCell, ranks=None) -> Optional[str]:
    """Why the cell's share cannot run (its ``run_reason``), or ``None``.
    In one process: a ``model`` axis of 1 (a ``pod`` axis only splits the
    batch).  On ranks (a ``ProcessMesh`` over ``data`` and ``model``):
    the ranks' ``model`` axis equal to the cell's, their ``data`` axis
    within the cell's batch blocks, a training cell only for a
    transformer (``dense``, ``moe``, ``vlm``; the Mamba, hybrid and
    Whisper backwards are A10d-5b-3b) with float32 moments, on a mesh
    without a ``pod`` axis, on
    ranks whose ``data`` axis is the cell's batch blocks (ZeRO-1's shards
    and the gradient's reduction span the whole ``data`` axis) and whose
    every microbatch splits over it, and where ``model`` is split, a
    model whose every split the axis makes exact.  A
    transformer (``dense``, ``moe``, ``vlm``): heads, KV heads and vocab;
    ``d_ff`` where a dense MLP runs; ``d_model`` for LLaVA's projector;
    ``moe_d_ff`` and the shared experts' ``n_shared_experts x
    moe_d_ff`` for FFN-split experts, ``n_experts`` for experts over
    ``model``; a decode's cache length.  Mamba
    (``ssm``): ``d_inner`` and vocab.  The hybrid: heads, the KV heads'
    columns ``n_kv_heads x head_dim`` (fewer KV heads than the axis are
    gathered, so the axis must divide them or be their multiple),
    ``d_ff``, ``d_rnn`` and vocab.  Whisper (``encdec``): heads, KV
    heads, ``d_ff``, ``d_model`` and a decode's cache length.  Not on
    ranks: a long-context decode, capacity dispatch (``moe_capacity``)
    and ``"model+data"`` experts where the ranks' ``data`` axis is over
    1 (whether or not ``model`` is split)."""
    model = mesh.shape.get("model", 1)
    if ranks is None:
        if model != 1:
            return (f"model axis {model} > 1: a tensor-parallel share runs "
                    f"on ranks only (lower_cell(..., ranks=ProcessMesh))")
        return None
    if tuple(ranks.axis_names) != ("data", "model"):
        return (f"the ranks' mesh has axes {tuple(ranks.axis_names)}, not "
                f"('data', 'model')")
    if ranks.shape["model"] != model:
        return (f"the ranks' model axis {ranks.shape['model']} differs from "
                f"the cell's {model}")
    if ranks.shape["data"] > _batch_rows(mesh, shape):
        return (f"the ranks' data axis {ranks.shape['data']} exceeds the "
                f"cell's {_batch_rows(mesh, shape)} batch blocks")
    if shape.kind == "train":
        rows = _batch_rows(mesh, shape)
        nm = max(cfg.microbatch, 1)
        if cfg.family in ("ssm", "hybrid", "encdec"):
            return (f"training a {cfg.family!r} model on ranks (the "
                    f"backwards of its gathers and split scans) is not "
                    f"ported (ROADMAP.md, A10d-5b-3b)")
        if "pod" in mesh.axis_names:
            return ("training on a mesh with a pod axis: the gradient's "
                    "all-reduce over pod is not run on ranks")
        if ranks.shape["data"] < rows:
            return (f"the ranks' data axis {ranks.shape['data']} is below "
                    f"the cell's {rows} batch blocks: ZeRO-1's shards and "
                    f"the gradient's reduction span the whole data axis")
        if shape.global_batch % nm or (shape.global_batch // nm) % rows:
            return (f"a microbatch of {shape.global_batch} / {nm} rows does "
                    f"not split over the data axis of {rows}")
        if cfg.opt_8bit:
            return ("8-bit Adam moments on ranks are not ported "
                    "(ROADMAP.md, A10d-5b-3c)")
    if cfg.family == "moe" and (model > 1 or ranks.shape["data"] > 1):
        if cfg.moe_capacity:
            return ("capacity dispatch (moe_capacity) on ranks: its arrival "
                    "order runs over every token, not ported")
        if cfg.expert_sharding == "model+data" and ranks.shape["data"] > 1:
            return (f"expert_sharding 'model+data' with the ranks' data "
                    f"axis {ranks.shape['data']} > 1: the expert weights "
                    f"would split over the axis that also splits the "
                    f"tokens, not ported")
    if model == 1:
        return None
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "encdec"):
        return f"family {cfg.family!r} has no tensor-parallel split on ranks"
    if shape.name.startswith("long"):
        if cfg.family in ("ssm", "hybrid"):
            return ("a long-context decode (one sequence, its batch not split "
                    "over data) is not ported on ranks")
        return ("a long-context decode splits its cache over (data, model):"
                " not ported on ranks")
    if cfg.family == "ssm":
        sizes = [("d_inner", cfg.d_inner), ("vocab", cfg.vocab)]
    elif cfg.family == "hybrid":
        sizes = [("n_heads", cfg.n_heads),
                 ("n_kv_heads x head_dim", cfg.n_kv_heads * cfg.hd),
                 ("d_ff", cfg.d_ff), ("d_rnn", cfg.drnn),
                 ("vocab", cfg.vocab)]
        if cfg.n_kv_heads % model and model % cfg.n_kv_heads:
            return (f"model axis {model} neither divides nor is a multiple "
                    f"of n_kv_heads {cfg.n_kv_heads}: a rank's query heads "
                    f"would straddle KV groups")
    elif cfg.family == "encdec":
        sizes = [("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                 ("d_ff", cfg.d_ff), ("d_model", cfg.d_model)]
    else:
        sizes = [("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                 ("vocab", cfg.vocab)]
        if cfg.family != "moe" or cfg.dense_residual:
            sizes.append(("d_ff", cfg.d_ff))
        if cfg.family == "vlm":
            sizes.append(("d_model", cfg.d_model))
    if cfg.family == "moe":
        if cfg.expert_sharding.startswith("model"):
            sizes.append(("n_experts", cfg.n_experts))
        else:
            sizes.append(("moe_d_ff", cfg.moe_d_ff))
        if cfg.n_shared_experts:
            sizes.append(("n_shared_experts x moe_d_ff",
                          cfg.n_shared_experts * cfg.moe_d_ff))
    if shape.kind == "decode" and cfg.family not in ("ssm", "hybrid"):
        sizes.append(("seq_len", shape.seq_len))
    for name, size in sizes:
        if size % model:
            return (f"model axis {model} does not divide {name} {size}: "
                    f"the split would not be exact")
    return None


def _seeded(rec_shape, dtype, gen, device, high=None):
    if dtype.is_floating_point:
        return torch.randn(rec_shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)
    return torch.randint(0, high, rec_shape, generator=gen, device=device,
                         dtype=dtype)


def _timed(fn, device: torch.device) -> Optional[float]:
    """Seconds of ``fn()`` by CUDA events; ``None`` off the card."""
    if device.type != "cuda":
        fn()
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _finite(name: str, t: torch.Tensor) -> None:
    if not bool(torch.isfinite(t.float()).all()):
        raise AssertionError(f"run: {name} is not finite")


def _sample(p: torch.Tensor, n: int = 4096) -> torch.Tensor:
    flat = p.detach().reshape(-1)
    return flat[::max(1, flat.numel() // n)].clone()


def whole_sample(t: torch.Tensor, like: torch.Tensor, block=None,
                 n: int = 4096) -> Tuple[Any, Any]:
    """A fixed strided sample of a leaf by its whole leaf's coordinates:
    along each of its ``D`` dimensions (size ``d``) about ``n ** (1 /
    D)`` evenly spaced coordinates from 0 to ``d - 1``, and every entry of
    their grid, so each block of a split dimension holds its share (one
    stride over the flattened leaf can alias with a row's width and miss
    whole column blocks).  ``t`` has the shape of the parameter ``like``;
    where ``like`` is a rank's block (its ``whole_shape`` and ``block``:
    ``distributed_lm.sharding.to_rank_widths``), the grid's entries that
    fall in the block; ``block``, where given, is the block of the whole
    leaf that ``t`` holds instead (a ZeRO-1 moment shard:
    ``train.optimizer.Zero1Layout.block``).  Returns (the entries' flat
    indices in the whole leaf, int64, ascending; their values, float32),
    numpy on the host, so a rank's entries meet the same entries of a
    one-process run's."""
    whole = tuple(getattr(like, "whole_shape", like.shape))
    block = block or getattr(like, "block", None) or tuple(
        slice(0, d) for d in whole)
    per = math.ceil(n ** (1 / max(len(whole), 1)))
    coords, local = [], []
    for size, part in zip(whole, block):
        c = np.unique(np.linspace(0, size - 1, min(size, per)).round()
                      .astype(np.int64))
        if isinstance(part, slice):
            c = c[(c >= part.start) & (c < part.stop)]
            at = c - part.start
        else:                       # a fused dimension's index block
            where = np.full(size, -1, np.int64)
            where[part] = np.arange(len(part))
            c = c[where[c] >= 0]
            at = where[c]
        coords.append(c)
        local.append(at)
    grid = np.meshgrid(*coords, indexing="ij")
    idx = np.ravel_multi_index(grid, whole).reshape(-1)
    pick = tuple(torch.as_tensor(g.reshape(-1), device=t.device)
                 for g in np.meshgrid(*local, indexing="ij"))
    vals = t.detach()[pick].float().cpu().numpy()
    order = np.argsort(idx, kind="stable")
    return idx[order], vals[order]


def _agreed(ranks, what: str, fn):
    """``fn()``; on ranks every rank then learns whether any rank's
    ``fn`` failed, and if one did, all raise together
    (``collectives.agree_or_raise``)."""
    if ranks is None:
        return fn()
    try:
        out = fn()
    except Exception as exc:        # every rank must hear of it
        coll.agree_or_raise(ranks, what, exc)
        raise
    coll.agree_or_raise(ranks, what)
    return out


def _all_ranks(obj, ranks) -> List:
    """Every rank's JSON-able ``obj``, in rank order, on every rank."""
    dev = coll.exchange_device(ranks)
    parts = coll.all_gather_ragged(torch.from_numpy(
        coll.encode_json(obj)).to(dev), ranks)
    return [coll.decode_json(p.cpu().numpy()) for p in parts]


def _same_on(words: List[int], ranks, axis: Optional[str] = None) -> bool:
    """Whether the ranks of this rank's line along ``axis`` (every rank
    for ``None``) passed the same ``words``; every rank joins."""
    mine = torch.tensor(words, dtype=torch.int64,
                        device=coll.exchange_device(ranks))
    parts = coll.all_gather_ragged(mine, ranks)
    peers = (range(ranks.world_size) if axis is None
             else ranks.axis_ranks(axis))
    return all(torch.equal(parts[k].cpu(), mine.cpu()) for k in peers)


def closed_form_mismatch(counted: Sequence[Dict[str, Any]],
                         executed: Dict[str, Any],
                         dims: Sequence[int]) -> Optional[str]:
    """Where a run's counted collectives (``run_collective``: each rank's
    tally, in rank order, on ranks of ``(data, model)`` shape ``dims``)
    part from the closed form's ``collective_executed``, or ``None``:
    every rank's calls of every kind and bytes of every kind but
    ``all-to-all`` are the closed form's; the all-to-all bytes, which
    follow the routing rank by rank, sum over each ``model`` line to
    ``model`` times the closed form's (module docstring)."""
    k = dims[-1]
    for rank, got in enumerate(counted):
        if got["counts"] != executed["counts"]:
            return (f"rank {rank} counted calls {got['counts']}, the closed "
                    f"form {executed['counts']}")
        for kind, nbytes in got["bytes"].items():
            if kind != "all-to-all" and nbytes != executed["bytes"][kind]:
                return (f"rank {rank} counted {nbytes} B of {kind}, the "
                        f"closed form {executed['bytes'][kind]} B")
    want = k * executed["bytes"]["all-to-all"]
    for lo in range(0, len(counted), k):
        line = [c["bytes"]["all-to-all"] for c in counted[lo:lo + k]]
        if sum(line) != want:
            return (f"ranks {lo}-{lo + k - 1} counted {line} B of "
                    f"all-to-all ({sum(line)} B), the closed form {k} x "
                    f"{executed['bytes']['all-to-all']} B")
    return None


def _check_written(name: str, v: torch.Tensor, before: torch.Tensor,
                   pos: int, seq_split: bool, model_at: int) -> None:
    """An attention cache ``[L, B, S, kv, hd]`` after a decode: changed at
    ``pos`` (a rolling window: slot ``pos % S``) and nowhere else; with
    its sequence split over ``model``, on the rank whose slots hold
    ``pos`` only, every other rank's unchanged."""
    slots = v.shape[2]
    lo = model_at * slots if seq_split else 0
    diff = v != before
    if seq_split and not lo <= pos < lo + slots:
        if bool(diff.any()):
            raise AssertionError(f"run: cache {name} changed on a rank "
                                 f"whose slots do not hold pos {pos}")
        return
    slot = (pos - lo) % slots
    if bool(diff[:, :, :slot].any()) or bool(diff[:, :, slot + 1:].any()):
        raise AssertionError(f"run: cache {name} changed away from pos "
                             f"{pos}")
    if not bool(diff[:, :, slot].any()):
        raise AssertionError(f"run: cache {name} did not change at pos "
                             f"{pos}")


def _check_advanced(name: str, v: torch.Tensor, before: torch.Tensor,
                    live: int, channels: int) -> None:
    """A recurrent state ``[layers, ...]`` after a decode: each of its
    first ``live`` layers changed in every channel (dimension
    ``channels``: the rank's channels on ranks), the rest (the hybrid's
    placeholder tail slot) unchanged."""
    diff = v != before
    moved = diff[:live].movedim(channels, -1).reshape(-1, v.shape[channels])
    if live and not bool(moved.any(dim=0).all()):
        raise AssertionError(f"run: state {name} did not advance in every "
                             f"channel")
    if bool(diff[live:].any()):
        raise AssertionError(f"run: state {name} changed past its layers")


def run_cell(cfg, shape: ShapeCell, mesh, device: torch.device,
             run_reps: int = _RUN_REPS, ranks=None,
             logits: Optional[List[torch.Tensor]] = None,
             executed: Optional[Dict[str, Any]] = None,
             sample: Optional[List[Dict[str, Any]]] = None
             ) -> Dict[str, Any]:
    """Runs one device's share of the cell (module docstring), timed
    ``run_reps`` times after the warm-up, and returns the fields it adds
    to the record.  With ``ranks`` every rank of the ``ProcessMesh`` calls
    it with the same arguments and runs its own share on its device.
    ``logits``, if given, receives the last pass's whole logits (float32,
    on the host; on ranks gathered from every rank's block).  A training
    cell on ranks holds its counted collectives to ``executed`` (the
    closed form's ``collective_executed``); ``sample``, if given,
    receives a training run's ``{"loss", "grad_norm"}`` (each pass's,
    floats) and ``{"params", "m"}``: ``whole_sample`` of every new
    parameter and first moment after the last pass, by name (on ranks
    the rank's entries: of a ZeRO-1 shard, the moments it holds)."""
    from torch.utils.flop_counter import FlopCounterMode
    long_ctx = shape.name.startswith("long")
    run_batch = -(-shape.global_batch // _batch_rows(mesh, shape))
    if ranks is not None:
        device = ranks.device
    # the ranks' data axis covers that many data rows of the cell: the
    # batch is drawn for all of them, and each data coordinate takes its
    # own run_batch rows
    rows = run_batch * (ranks.shape["data"] if ranks is not None else 1)
    # a training step on ranks reduces over data too: its model holds
    # the whole grid
    split = ranks if ranks is not None and (
        ranks.shape["model"] > 1 or shape.kind == "train") else None
    model_at = split.axis_index("model") if split is not None else 0
    checks: List[str] = []

    def setup():
        gen = torch.Generator(device=device).manual_seed(0)
        model = build_model(cfg, device=device, ranks=split)
        model.init(gen)
        return model

    model = _agreed(ranks, "run_cell setup", setup)
    vocab_split = head_vocab_split(model.param_specs())
    data = torch.Generator(device=device).manual_seed(1)

    def rank_rows(batch):
        return batch if ranks is None else batch_block(batch, cfg, ranks)

    if shape.kind == "train":
        opt_cfg = AdamConfig(use_8bit=cfg.opt_8bit)
        params = model_params(model)
        layout = zero1_layout(model, opt_cfg, cfg.zero1)
        state = adam_init(params, opt_cfg, layout)
        # every rank takes the whole global batch; the step cuts each
        # microbatch to its data coordinate's rows
        batch = {k: _seeded(r.shape, r.dtype, data, device, cfg.vocab)
                 for k, r in input_structs(cfg, mesh, rows,
                                           shape.seq_len).items()}
        before = {k: _sample(p) for k, p in params.items()}
        step = make_train_step(model, cfg, opt_cfg)
        losses, norms = [], []
        # on ranks, whether each gradient is non-zero somewhere in the
        # warm-up step: weight decay moves a parameter whose gradient a
        # collective cut, so "changed" alone would not see the cut
        nonzero: Dict[str, torch.Tensor] = {}
        hooks = [] if ranks is None else [
            p.register_post_accumulate_grad_hook(
                lambda p, k=k: nonzero.__setitem__(k, p.grad.ne(0).any()))
            for k, p in params.items()]

        def one():
            _, _, metrics = step(params, state, batch)
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
            for h in hooks:
                h.remove()
            hooks.clear()

        def check():
            for i, loss in enumerate(losses):
                _finite(f"loss {i}", loss)
            for k, p in params.items():
                _finite(k, p)
                if torch.equal(_sample(p), before[k]):
                    raise AssertionError(f"run: parameter {k} did not "
                                         f"change")
            checks[:] = ["losses finite", "parameters finite",
                         f"all {len(params)} parameters changed"]
            if ranks is None:
                return
            zero = [k for k in params if k not in nonzero
                    or not bool(nonzero[k])]
            if zero:
                raise AssertionError(
                    f"run: the gradient of {', '.join(zero)} is zero "
                    f"everywhere before the update (a cut backward)")
            checks.insert(2, f"all {len(params)} gradients non-zero before "
                             f"the update")
    elif shape.kind == "prefill":
        batch = rank_rows({k: _seeded(r.shape, r.dtype, data, device,
                                      cfg.vocab)
                           for k, r in input_structs(cfg, mesh, rows,
                                                     shape.seq_len).items()
                           if k != "labels"})
        step = make_prefill_step(model, cfg)
        outs = []
        width = cfg.vocab // (split.shape["model"] if split and vocab_split
                              else 1)

        def one():
            outs.append(step(batch))

        def check():
            for i, logits in enumerate(outs):
                if tuple(logits.shape) != (run_batch, width):
                    raise AssertionError(f"run: logits {tuple(logits.shape)}"
                                         f", want {(run_batch, width)}")
                _finite(f"logits {i}", logits)
            checks[:] = [f"logits [{run_batch}, {width}]", "logits finite"]
    else:
        cache = {}
        for k, r in cache_structs(model, cfg, mesh, rows, shape.seq_len,
                                  long_ctx).items():
            whole = _seeded(r.shape, r.dtype, data, device)
            cache[k] = whole if ranks is None else cache_block(
                {k: whole}, model, ranks, long_ctx)[k]
            del whole
        before = {k: v.clone() for k, v in cache.items()}
        cache_specs = model.cache_specs(long_ctx)
        # whether the attention cache's sequence is split over model (else
        # it is whole on every rank: the hybrid's window)
        seq_split = "k" in cache and "model" in _axes(
            _entries(cache_specs["k"], 5)[2])
        tokens = rank_rows({"tokens": torch.randint(
            0, cfg.vocab, (rows, 1), generator=data, device=device,
            dtype=torch.int32)})["tokens"]
        pos = shape.seq_len - 1
        step = make_serve_step(model, cfg)
        outs = []

        def one():
            logits, new = step(cache, tokens, pos)
            if new is not cache:
                cache.update(new)
            outs.append(logits)

        def check():
            for i, logits in enumerate(outs):
                _finite(f"logits {i}", logits)
            checks[:] = ["logits finite", "cache finite"]
            for k, v in cache.items():
                _finite(f"cache {k}", v)
                entries = _entries(cache_specs[k], v.dim())
                if k in ("k", "v"):
                    _check_written(k, v, before[k], pos, split is not None
                                   and "model" in _axes(entries[2]),
                                   model_at)
                elif k.startswith("cross_"):
                    if not torch.equal(v, before[k]):
                        raise AssertionError(f"run: cache {k} changed")
                else:
                    # a recurrent state [layers, rows, ..., channels, ...]
                    live = (model.n_tail if k.startswith("tail_")
                            else v.shape[0])
                    _check_advanced(k, v, before[k], live,
                                    [_axes(e) for e in entries]
                                    .index(("model",)))
            written = [k for k in cache if k in ("k", "v")]
            if written:
                checks.append(f"{'/'.join(written)} written at pos {pos} "
                              f"only")
                if split is not None and seq_split:
                    checks.append("the other ranks' caches unchanged")
            states = [k for k in cache if k not in ("k", "v")
                      and not k.startswith("cross_")]
            if states:
                checks.append(f"{'/'.join(states)} advanced in every "
                              f"channel {'of the rank' if split else ''}"
                              .rstrip())
            if any(k.startswith("cross_") for k in cache):
                checks.append("cross K/V unchanged")
    on_card = device.type == "cuda"
    tally = ranks.tally if ranks is not None else coll.Tally()
    tally.reset(digests=True)
    with FlopCounterMode(display=False) as counter:
        one()                                      # the untimed warm-up
    # each all-reduced tensor's digest, by the axis it was reduced over
    # (None: every rank)
    digests: Dict[Optional[str], List[int]] = {}
    for axis, d in zip(tally.digest_axes, tally.digests):
        digests.setdefault(axis, []).extend(d)
    routes = [w for d in tally.routes for w in d]
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    times, exchange = [], []
    for _ in range(run_reps):
        tally.reset()
        times.append(_timed(one, device))
        exchange.append(tally.seconds)
    counted = tally.record()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    whole = outs[-1] if shape.kind != "train" else None
    if ranks is not None:
        # the exchanges first, on every rank: a check that fails on one
        # rank must not leave the others waiting in a collective
        if whole is not None:
            whole = whole_logits(whole, ranks, model)
        # every rank joins each exchange: no short cut
        lines_agree = all([_same_on(digests.get(axis, []), ranks, axis)
                           for axis in ("model", "data", None)])
        # a cache whole on every rank and written (the hybrid's window)
        # holds the same bytes along a model line
        window = (shape.kind == "decode" and split is not None
                  and "k" in cache and not seq_split)
        window_agree = not window or _same_on(
            [w for k in ("k", "v") for w in coll.digest(cache[k])], ranks,
            "model")
        routes_agree = _same_on(routes, ranks, "model")
        logits_agree = whole is None or _same_on(list(coll.digest(whole)),
                                                 ranks)
        if shape.kind == "train":
            # the leaves whole on every rank of a model line hold the
            # same bytes along it, every block along its data line, and
            # the step's metrics on every rank
            whole_leaves = [k for k, p in params.items()
                            if tuple(p.shape) == tuple(getattr(
                                p, "whole_shape", p.shape))]
            replicas_agree = _same_on(
                [w for k in whole_leaves for w in coll.digest(params[k])],
                ranks, "model")
            blocks_agree = ranks.shape["data"] == 1 or _same_on(
                [w for p in params.values() for w in coll.digest(p)],
                ranks, "data")
            metrics_agree = _same_on([w for t in losses + norms
                                      for w in coll.digest(t)], ranks)

    def check_all():
        check()
        if ranks is None:
            return
        if not lines_agree:
            raise AssertionError("run: an all-reduced tensor differs "
                                 "between the ranks it was reduced over")
        if not routes_agree:
            raise AssertionError("run: a MoE layer's routing differs "
                                 "between the ranks of a model line")
        if not logits_agree:
            raise AssertionError("run: the gathered logits differ between "
                                 "ranks")
        if not window_agree:
            raise AssertionError("run: the window cache differs between the "
                                 "ranks of a model line")
        if shape.kind == "train":
            if not replicas_agree:
                raise AssertionError("run: a replicated parameter differs "
                                     "between the ranks of a model line "
                                     "after the step")
            if not blocks_agree:
                raise AssertionError("run: a parameter block differs "
                                     "between the ranks of a data line "
                                     "after the step")
            if not metrics_agree:
                raise AssertionError("run: the loss or the gradient norm "
                                     "differs between ranks")
            checks.append(f"{len(whole_leaves)} replicated parameters equal "
                          f"on every rank of a model line")
            if ranks.shape["data"] > 1:
                checks.append(f"all {len(params)} parameter blocks equal "
                              f"on every rank of a data line")
            checks.append("loss and grad_norm equal on every rank")
        for axis, where in (("model", "every rank of a model line"),
                            ("data", "every rank of a data line"),
                            (None, "every rank")):
            if axis == "model" or digests.get(axis):
                checks.append(f"{len(digests.get(axis, [])) // 2} "
                              f"all-reduced tensors equal on {where}")
        if routes:
            checks.append(f"{len(routes) // 4} routings (experts, gates) "
                          f"equal on every rank of a model line")
        if whole is not None:
            checks.append("gathered logits equal on every rank")
        if window:
            checks.append("the window equal on every rank of a model line")

    _agreed(ranks, "run_cell checks", check_all)
    if logits is not None and whole is not None:
        logits.append(whole.float().cpu())
    if sample is not None and shape.kind == "train":
        sample.append({
            "loss": [float(t) for t in losses],
            "grad_norm": [float(t) for t in norms],
            "params": {k: whole_sample(p, p) for k, p in params.items()},
            "m": {k: whole_sample(m, params[k], layout.block(
                k, params[k]) if layout is not None else None)
                  for k, m in state["m"].items()}})
    a = roofline.analytic_cell_model(
        cfg, dataclasses.replace(shape, global_batch=run_batch))
    parts = ranks.shape["model"] if ranks is not None else 1
    t_flops = a["flops"] / roofline.PEAK_FLOPS / parts
    t_bytes = a["hbm_bytes"] / roofline.HBM_BW / parts
    out = dict(run_batch=run_batch,
               run_s=statistics.median(times) if on_card else None,
               run_times_s=times if on_card else None,
               run_flops=int(counter.get_total_flops()), peak_bytes=peak,
               run_bound_s=max(t_flops, t_bytes),
               run_bound_by="flops" if t_flops >= t_bytes else "bytes",
               run_checks=checks)
    if ranks is None:
        return out
    mine = dict(rank=ranks.rank, coords=list(ranks.coords),
                run_s=out["run_s"], run_times_s=out["run_times_s"],
                run_exchange_s=statistics.median(exchange) if on_card
                else None,
                peak_bytes=peak, run_flops=out["run_flops"],
                collective={k: counted[k] for k in ("bytes", "counts",
                                                    "total_bytes")})
    every = _all_ranks(mine, ranks)
    out.update(run_ranks=[{k: v for k, v in r.items() if k != "collective"}
                          for r in every],
               run_collective=[r["collective"] for r in every])
    if shape.kind == "train" and executed is not None:
        # every rank holds every rank's tally: all raise together
        why = closed_form_mismatch(out["run_collective"], executed,
                                   ranks.dims)
        if why is not None:
            raise AssertionError(f"run: the counted collectives part from "
                                 f"the closed form: {why}")
        checks.append("collectives equal to the closed form's")
    if on_card:
        out["run_s"] = max(r["run_s"] for r in every)
        out["run_exchange_s"] = max(r["run_exchange_s"] for r in every)
        out["peak_bytes"] = max(r["peak_bytes"] for r in every)
    else:
        out["run_exchange_s"] = None
    return out


# ---------------------------------------------------------------------------
# a cell, and the command line
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_name: Union[str, ShapeCell], *,
               multi_pod: bool = False, keep_hlo: bool = False,
               overrides: Optional[Dict] = None,
               mesh_shape: Optional[tuple] = None,
               device: DeviceLike = None, run: bool = False,
               run_reps: int = _RUN_REPS, ranks=None,
               logits: Optional[List[torch.Tensor]] = None,
               sample: Optional[List[Dict[str, Any]]] = None
               ) -> Dict[str, Any]:
    """One cell's record (module docstring).  ``overrides`` applies
    ``dataclasses.replace`` on the config and ``mesh_shape`` re-factors
    the mesh into (data, model) or (pod, data, model), as the
    reference's.  ``shape_name`` may be a ``ShapeCell`` (a reduced cell
    for a quick run).  ``keep_hlo`` does nothing: there is no HLO.
    ``device=None`` means ``"cuda"`` and raises without a card.
    ``run_reps`` is the number of timed passes of a run.  ``ranks`` (a
    ``ProcessMesh``; every rank calls with the same arguments) runs the
    share on ranks, ``logits`` receives the run's whole logits and
    ``sample`` a training run's metrics and sampled state
    (``run_cell``)."""
    del keep_hlo
    dev = resolve_device(device)
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = (shape_name if isinstance(shape_name, ShapeCell)
             else SHAPES[shape_name])
    ok, why = cell_applicable(cfg, shape)
    rec: Dict[str, Any] = dict(arch=arch, shape=shape.name,
                               multi_pod=multi_pod)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    if mesh_shape is not None:
        axes = (("pod", "data", "model") if len(mesh_shape) == 3
                else ("data", "model"))
        mesh = make_mesh(tuple(mesh_shape), axes, device=dev)
        rec["mesh_shape"] = list(mesh_shape)
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    model = build_model(cfg, device="meta")
    args = step_arguments(cfg, shape, mesh, model)
    coll, coll_exec = collective_closed_form(cfg, shape, mesh, args)
    # nothing is lowered or compiled: no memory plan, cost analysis or HLO
    rec.update(
        status="ok",
        n_devices=int(mesh.devices.size),
        lower_s=None, compile_s=None, flops=None, bytes_accessed=None,
        collective=coll, collective_executed=coll_exec, loops=None,
        memory=dict(argument_bytes=argument_bytes(args),
                    output_bytes=output_bytes(cfg, shape, mesh, args),
                    temp_bytes=None, generated_code_bytes=None),
        model_params=cfg.n_params(),
        model_params_active=cfg.n_active_params(),
        device=str(dev),
    )
    if run:
        reason = _run_rule(mesh, cfg, shape, ranks)
        if reason is not None:
            rec["run_reason"] = reason
        else:
            rec.update(run_cell(cfg, shape, mesh, dev, run_reps, ranks,
                                logits, coll_exec, sample))
    return rec


def _line(tag: str, rec: Dict[str, Any]) -> str:
    if rec["status"] != "ok":
        return (f"[{rec['status']:7s}] {tag} "
                + rec.get("reason", rec.get("error", "")))
    text = (f"[{rec['status']:7s}] {tag} flops={rec['flops']} "
            f"coll={rec['collective']['total_bytes']:.3e} "
            f"compile={rec['compile_s']}")
    if "run_bound_s" in rec:
        run_s = ("not-measured" if rec["run_s"] is None
                 else f"{rec['run_s']:.4f}s")
        text += (f" run={run_s} bound={rec['run_bound_s']:.4f}s "
                 f"run_flops={rec['run_flops']:.3e} "
                 f"peak={rec['peak_bytes']} batch={rec['run_batch']}")
    elif "run_reason" in rec:
        text += " run=skipped"
    return text


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    """The reference's command line plus ``--device`` and ``--run``;
    writes one record per cell into ``--out`` (when given) and returns
    them.  Raises ``SystemExit`` if a cell failed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default=None,
                    help="directory for per-cell JSON records")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose JSON record already exists")
    ap.add_argument("--set", type=str, default=None, dest="overrides",
                    help='JSON config overrides, e.g. \'{"gqa_repeat":true}\'')
    ap.add_argument("--tag", type=str, default="",
                    help="suffix for output record filenames")
    ap.add_argument("--mesh-shape", type=str, default=None,
                    help="alternative chip factorization, e.g. 32,8")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--run", action="store_true",
                    help="run one device's share where the mesh's model "
                         "axis is 1")
    args = ap.parse_args(argv)
    overrides = json.loads(args.overrides) if args.overrides else None
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)

    cells = []
    archs = list(ALIASES.keys()) if args.all else [args.arch]
    shapes = list(SHAPES.keys()) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    failures = 0
    records = []
    for a, s, mp in cells:
        tag = f"{a} × {s} × {'2x16x16' if mp else '16x16'}"
        suffix = f"__{args.tag}" if args.tag else ""
        fn = f"{ALIASES.get(a, a)}__{s}__{'mp' if mp else 'sp'}{suffix}.json"
        if args.skip_existing and args.out and \
                os.path.exists(os.path.join(args.out, fn)):
            print(f"[cached ] {tag}")
            continue
        try:
            rec = lower_cell(a, s, multi_pod=mp, overrides=overrides,
                             mesh_shape=mesh_shape, device=args.device,
                             run=args.run)
        except Exception as e:  # a cell's failure is its record
            failures += 1
            rec = dict(arch=a, shape=s, multi_pod=mp, status="error",
                       error=f"{type(e).__name__}: {e}",
                       tb=traceback.format_exc()[-2000:])
        print(_line(tag, rec), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, fn), "w") as f:
                json.dump(rec, f, indent=1)
        records.append(rec)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")
    return records


if __name__ == "__main__":
    main()
