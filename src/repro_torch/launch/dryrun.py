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
  a device holds per microbatch and ``a`` the compute dtype's bytes:

  - row-split denses: every dense weight whose contraction dimension is
    split over ``model`` (attention out, MLP down, Mamba's ``x_proj`` /
    ``out_proj``, RG-LRU's ``out``, MoE ``w_down`` with FFN-split
    experts) ends in an all-reduce over ``model`` of its ``[t, d_out]``
    output (``t x top_k`` rows for the experts).  Training adds one for
    the remat recompute (``remat`` with policy ``"full"``) and one in the
    backward (the gradient entering each column-split group);
  - expert-parallel MoE (experts split over ``model``): an all-to-all
    each way (dispatch, combine) of ``[t x top_k, d]``, in each pass;
  - the input embedding: an all-reduce of ``[t, d]`` where the vocab is
    split, an all-gather where ``d_model`` is (Whisper);
  - the head: with a vocab-split head, training all-reduces the loss's
    three float32 statistics ``[t]`` (max, sum of exponentials, the
    label's logit) and, in the backward, the ``[t, d]`` input gradient;
    prefill and decode leave the logits vocab-split, as the step's
    result.  A head contracted over a split ``d_model`` (Whisper's tied
    embedding) all-reduces its ``[t, V]`` logits;
  - LLaVA's projector: its row-split ``fc2`` all-reduces ``[p, d]`` over
    the ``p`` patches, forward and (training) backward;
  - the gradient reduction over the batch axes, once a step, float32:
    a leaf that ZeRO-1 splits over ``data`` is reduce-scattered over
    ``data`` (result: its moment's shard), all-reduced over ``pod`` if
    there is one, and the new parameter all-gathered over ``data``
    (result: its own shard); any other leaf is all-reduced over the
    batch axes it is not split on.

  ``collective`` counts each layer stack's body (a layer, or the
  hybrid's group) once, and one microbatch, as the reference's flat
  count does; ``collective_executed`` multiplies the bodies by their
  layers and every per-microbatch term by the microbatches.

With ``run=True`` a cell whose mesh has a ``model`` axis of 1 and no
``pod`` axis runs one device's share on ``device``: the model at the
cell's config, weights from seed 0, the batch ``global_batch / data`` at
the cell's ``seq_len`` (seeded), through ``make_train_step`` /
``make_prefill_step`` / ``make_serve_step``; decode against a seeded
cache of ``cache_structs``' shapes at ``pos = seq_len - 1``.  The port
has no tensor-parallel execution, so any other cell says why in
``run_reason`` and runs nothing.  A run adds ``run_batch``, ``run_s``
(CUDA events, the median of ``run_reps`` (3 by default) after 1 warm-up;
``None`` off the card),
``run_times_s``, ``run_flops`` (``FlopCounterMode`` over the untimed
warm-up), ``peak_bytes`` (``torch.cuda.max_memory_allocated`` over
the timed passes; ``None`` off the card) and ``run_bound_s``: the larger
of ``analytic_cell_model``'s flops over ``PEAK_FLOPS`` and its HBM bytes
over ``HBM_BW`` at the device's batch on one chip (the work the card
does).  ``run_checks`` lists what held: every output finite; ``train``:
every parameter changed; ``prefill``: logits ``[run_batch, vocab]``;
``decode``: each attention cache changed at ``pos`` and nowhere else
(the hybrid's rolling window at ``pos % window``), a cross-attention
cache not at all.  A failed check raises.

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

import torch

from .. import convert
from ..benchmarks import roofline
from ..configs import ALIASES, get_config
from ..core.mesh import make_mesh
from ..device import DeviceLike, resolve_device
from ..distributed_lm.sharding import (ShapeDtype, batch_axes, cache_structs,
                                       input_structs, named, shard_params)
from ..models import build_model
from ..models.layers import P, torch_dtype
from ..serve.serve_step import make_prefill_step, make_serve_step
from ..train.optimizer import AdamConfig, adam_init, opt_state_specs
from ..train.train_step import make_train_step, model_params
from .mesh import make_production_mesh
from .shapes import SHAPES, ShapeCell, cell_applicable

__all__ = ["COLLECTIVE_KINDS", "shard_shape", "leaf_bytes",
           "step_arguments", "argument_bytes", "output_bytes",
           "collective_closed_form", "run_cell", "lower_cell", "main"]

# the reference's collective kinds (``launch/hlo_analysis.py``), in order
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# XLA's output tuple holds one 8-byte buffer pointer a leaf
_TUPLE_ENTRY_BYTES = 8
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

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entries(spec, ndim: int) -> List:
    return list(spec) + [None] * (ndim - len(spec))


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


def _head_vocab_split(params) -> bool:
    """Whether the head's vocab dimension is split over ``model``: the
    ``lm_head``'s columns, else the tied embedding's rows."""
    if "lm_head" in params:
        return "model" in _axes(params["lm_head"]["w"].sharding.spec[-1])
    return "model" in _axes(params["embed"].sharding.spec[0])


def output_bytes(cfg, shape: ShapeCell, mesh,
                 args: Dict[str, Any]) -> Optional[int]:
    """Per-device bytes of the step's outputs (module docstring), or
    ``None`` where the rule was not held to the reference's."""
    dt = torch_dtype(cfg.compute_dtype)
    long_ctx = shape.name.startswith("long")
    ba = batch_axes(mesh) if not long_ctx else None
    vocab = "model" if _head_vocab_split(args["params"]) else None
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


def _body_terms(recs, cfg, tokens: int, act: int, passes: int) -> _Tally:
    """One body's model-axis collectives for ``tokens`` tokens, over
    ``passes`` passes (module docstring); ``recs`` are the body's
    parameter records, each with its spec."""
    out = _Tally()
    for path, rec in _leaves(recs):
        spec = _entries(rec.sharding.spec, len(rec.shape))
        if path[-1] == "w":
            if "model" in _axes(spec[-2]) and \
                    "model" not in _axes(spec[-1]):
                out.add("all-reduce", tokens * rec.shape[-1] * act,
                        times=passes)
        elif path[-1] == "w_down":
            rows = tokens * max(cfg.top_k, 1)
            if "model" in _axes(spec[-3]):          # experts over model
                out.add("all-to-all", rows * rec.shape[-1] * act, count=2,
                        times=passes)
            elif "model" in _axes(spec[-2]):
                out.add("all-reduce", rows * rec.shape[-1] * act,
                        times=passes)
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
    if split_model:
        for key in convert.STACKED + ("tail",):
            if key not in recs:
                continue
            tokens = b * cfg.enc_frames if key == "enc_blocks" else t_dec
            for r in (recs[key] if key == "tail" else [recs[key]]):
                body = _body_terms(r, cfg, tokens, act, passes)
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
        if _head_vocab_split(recs):
            if kind == "train":
                head.add("all-reduce", t_dec * 4, count=3)
                head.add("all-reduce", t_dec * d * act)
        else:
            head.add("all-reduce", t_dec * v * act)
        if "vision_proj" in recs:
            w = recs["vision_proj"]["fc2"]["w"]
            head.add("all-reduce", b * npatch * w.shape[-1] * act,
                     times=2 if kind == "train" else 1)
        flat.merge(head)
        executed.merge(head, nm)
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
        flat.merge(grads)
        executed.merge(grads)
    return flat.record(), executed.record()


# ---------------------------------------------------------------------------
# one device's share on the card
# ---------------------------------------------------------------------------

def _run_rule(mesh) -> Optional[str]:
    if "pod" in mesh.axis_names:
        return ("the mesh has a pod axis: the port runs data-parallel "
                "shares only (no pod or tensor-parallel execution)")
    if mesh.shape.get("model", 1) != 1:
        return (f"model axis {mesh.shape['model']} > 1: the port has no "
                f"tensor-parallel execution, so only a data-parallel "
                f"share (model axis 1) runs")
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


def run_cell(cfg, shape: ShapeCell, mesh, device: torch.device,
             run_reps: int = _RUN_REPS) -> Dict[str, Any]:
    """Runs one device's share of the cell (module docstring), timed
    ``run_reps`` times after the warm-up, and returns the fields it adds
    to the record."""
    from torch.utils.flop_counter import FlopCounterMode
    long_ctx = shape.name.startswith("long")
    split = 1 if long_ctx else math.prod(mesh.shape[a]
                                         for a in batch_axes(mesh))
    run_batch = -(-shape.global_batch // split)
    gen = torch.Generator(device=device).manual_seed(0)
    model = build_model(cfg, device=device)
    model.init(gen)
    data = torch.Generator(device=device).manual_seed(1)
    checks: List[str] = []
    if shape.kind == "train":
        opt_cfg = AdamConfig(use_8bit=cfg.opt_8bit)
        params = model_params(model)
        state = adam_init(params, opt_cfg)
        batch = {k: _seeded(r.shape, r.dtype, data, device, cfg.vocab)
                 for k, r in input_structs(cfg, mesh, run_batch,
                                           shape.seq_len).items()}
        before = {k: _sample(p) for k, p in params.items()}
        step = make_train_step(model, cfg, opt_cfg)
        losses = []

        def one():
            _, _, metrics = step(params, state, batch)
            losses.append(metrics["loss"])

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
    elif shape.kind == "prefill":
        batch = {k: _seeded(r.shape, r.dtype, data, device, cfg.vocab)
                 for k, r in input_structs(cfg, mesh, run_batch,
                                           shape.seq_len).items()
                 if k != "labels"}
        step = make_prefill_step(model, cfg)
        outs = []

        def one():
            outs.append(step(batch))

        def check():
            for i, logits in enumerate(outs):
                if tuple(logits.shape) != (run_batch, cfg.vocab):
                    raise AssertionError(f"run: logits {tuple(logits.shape)}"
                                         f", want {(run_batch, cfg.vocab)}")
                _finite(f"logits {i}", logits)
            checks[:] = [f"logits [{run_batch}, {cfg.vocab}]",
                         "logits finite"]
    else:
        cache = {k: _seeded(r.shape, r.dtype, data, device)
                 for k, r in cache_structs(model, cfg, mesh, run_batch,
                                           shape.seq_len, long_ctx).items()}
        before = {k: v.clone() for k, v in cache.items()}
        tokens = torch.randint(0, cfg.vocab, (run_batch, 1), generator=data,
                               device=device, dtype=torch.int32)
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
            for k, v in cache.items():
                _finite(f"cache {k}", v)
                if k in ("k", "v"):
                    slot = pos % v.shape[2]
                    diff = (v != before[k])
                    if bool(diff[:, :, :slot].any()) or \
                            bool(diff[:, :, slot + 1:].any()):
                        raise AssertionError(f"run: cache {k} changed "
                                             f"away from pos {pos}")
                    if not bool(diff[:, :, slot].any()):
                        raise AssertionError(f"run: cache {k} did not "
                                             f"change at pos {pos}")
                elif k.startswith("cross_") and not torch.equal(
                        v, before[k]):
                    raise AssertionError(f"run: cache {k} changed")
            checks[:] = ["logits finite", "cache finite"]
            written = [k for k in cache if k in ("k", "v")]
            if written:
                checks.append(f"{'/'.join(written)} written at pos {pos} "
                              f"only")
            if any(k.startswith("cross_") for k in cache):
                checks.append("cross K/V unchanged")
    on_card = device.type == "cuda"
    with FlopCounterMode(display=False) as counter:
        one()                                      # the untimed warm-up
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    times = [_timed(one, device) for _ in range(run_reps)]
    peak = torch.cuda.max_memory_allocated() if on_card else None
    check()
    a = roofline.analytic_cell_model(
        cfg, dataclasses.replace(shape, global_batch=run_batch))
    out = dict(run_batch=run_batch,
               run_s=statistics.median(times) if on_card else None,
               run_times_s=times if on_card else None,
               run_flops=int(counter.get_total_flops()), peak_bytes=peak,
               run_bound_s=max(a["flops"] / roofline.PEAK_FLOPS,
                               a["hbm_bytes"] / roofline.HBM_BW),
               run_bound_by=("flops" if a["flops"] / roofline.PEAK_FLOPS
                             >= a["hbm_bytes"] / roofline.HBM_BW
                             else "bytes"),
               run_checks=checks)
    return out


# ---------------------------------------------------------------------------
# a cell, and the command line
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_name: Union[str, ShapeCell], *,
               multi_pod: bool = False, keep_hlo: bool = False,
               overrides: Optional[Dict] = None,
               mesh_shape: Optional[tuple] = None,
               device: DeviceLike = None, run: bool = False,
               run_reps: int = _RUN_REPS) -> Dict[str, Any]:
    """One cell's record (module docstring).  ``overrides`` applies
    ``dataclasses.replace`` on the config and ``mesh_shape`` re-factors
    the mesh into (data, model) or (pod, data, model), as the
    reference's.  ``shape_name`` may be a ``ShapeCell`` (a reduced cell
    for a quick run).  ``keep_hlo`` does nothing: there is no HLO.
    ``device=None`` means ``"cuda"`` and raises without a card.
    ``run_reps`` is the number of timed passes of a run."""
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
        reason = _run_rule(mesh)
        if reason is not None:
            rec["run_reason"] = reason
        else:
            rec.update(run_cell(cfg, shape, mesh, dev, run_reps))
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
