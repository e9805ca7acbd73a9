"""Checkpointing: atomic, keep-k, resumable, in the reference's layout.

Counterpart of ``repro/train/checkpoint.py``.  Layout:
``<dir>/step_<N>/arrays.npz`` + ``meta.json`` (step, the sorted array
keys, the caller's metadata).  Writes go to ``<dir>/.tmp_<N>``, then one
atomic ``os.rename``, then the directory is pruned to the newest
``keep`` steps: a preempted writer never corrupts the latest checkpoint.
``AsyncCheckpointer`` writes on a background thread; the copy to the
host happens in ``submit``, before it returns, so a train step that
then updates the tensors in place cannot reach the saved values.

The arrays are keyed by the reference's tree paths joined with ``/``,
layers stacked on a leading axis (``params/blocks/attn/wq/w``,
``opt/m/...``, ``opt/count``; the hybrid's ``tail`` by index), so either
package restores the other's checkpoints.  ``state_tree`` turns the
port's per-layer parameters and optimizer state into that tree,
``state_like`` gives its shapes without copying, and ``load_state``
writes a restored tree back into the live tensors.  The reference's
``meta.json`` also carries its JAX ``treedef`` string, which its
``restore`` never reads; it is not written here.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import convert

__all__ = ["save", "restore", "all_steps", "latest_step",
           "AsyncCheckpointer", "state_tree", "state_like", "load_state"]

Tree = Any


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    """``/``-joined paths of nested dicts and lists -> host arrays."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + (str(key),))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
        else:
            flat["/".join(path)] = (convert.host_copy(node)
                                    if isinstance(node, torch.Tensor)
                                    else np.asarray(node))

    walk(tree, ())
    return flat


def _to_host(tree: Tree) -> Tree:
    """``tree`` with every tensor leaf copied to the host as numpy."""
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return convert.host_copy(tree)
    return tree


def save(ckpt_dir: str, step: int, tree: Tree,
         metadata: Optional[Dict] = None, keep: int = 3) -> str:
    """Atomic checkpoint write of ``tree`` (nested dicts / lists of
    tensors or arrays); prunes to the newest ``keep`` steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = dict(metadata or {}, step=step, keys=sorted(flat.keys()))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    for s in sorted(all_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def restore(ckpt_dir: str, like: Tree, step: Optional[int] = None
            ) -> Tuple[int, Tree, Dict]:
    """Restore into the structure of ``like`` (nested dicts / lists whose
    leaves have ``.shape`` and ``.dtype``: arrays, tensors or
    ``state_like``'s records) -> (step, tree of numpy arrays, meta).
    Shapes are validated; dtypes are cast to ``like``'s."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    arrays = np.load(os.path.join(d, "arrays.npz"))

    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        key = "/".join(path)
        arr = arrays[key]
        want = getattr(node, "shape", None)
        if want is not None and tuple(arr.shape) != tuple(want):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(want)}")
        dt = getattr(node, "dtype", None)
        return arr.astype(_np_dtype(dt), copy=False) if dt is not None \
            else arr

    return step, walk(like, ()), meta


# ---------------------------------------------------------------------------
# the port's training state <-> the reference's tree
# ---------------------------------------------------------------------------

class _Like:
    """A shape and dtype, standing in for an array in ``restore``'s
    ``like``."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), _np_dtype(dtype)


def _moment_leaves(moments: Mapping[str, Any]) -> Dict[str, Any]:
    """``{name: tensor}`` or ``{name: {"codes", "scale"}}`` (8-bit) as
    flat ``.``-joined keys."""
    flat = {}
    for k, v in moments.items():
        if isinstance(v, Mapping):
            for part, t in v.items():
                flat[f"{k}.{part}"] = t
        else:
            flat[k] = v
    return flat


def state_tree(params: Mapping[str, torch.Tensor],
               opt_state: Mapping[str, Any]) -> Dict:
    """``{"params": ..., "opt": {"m", "v", "count"}}`` in the reference's
    layout (layers stacked), as host numpy copies taken now."""
    nest = convert.lm_params_from_state_dict
    return {"params": nest(params),
            "opt": {"m": nest(_moment_leaves(opt_state["m"])),
                    "v": nest(_moment_leaves(opt_state["v"])),
                    "count": convert.host_copy(opt_state["count"])}}


def state_like(params: Mapping[str, torch.Tensor],
               opt_state: Mapping[str, Any]) -> Dict:
    """The shapes and dtypes of ``state_tree(params, opt_state)``,
    without copying anything (``restore``'s ``like``)."""
    def like(t):
        return _Like(t.shape, t.dtype)

    def stack(leaves):
        return _Like((len(leaves),) + leaves[0].shape, leaves[0].dtype)

    def nest(flat):
        return convert.nest_layers({k: like(v) for k, v in flat.items()},
                                   stack=stack)

    return {"params": nest(dict(params)),
            "opt": {"m": nest(_moment_leaves(opt_state["m"])),
                    "v": nest(_moment_leaves(opt_state["v"])),
                    "count": like(opt_state["count"])}}


@torch.no_grad()
def load_state(tree: Mapping, params: Mapping[str, torch.Tensor],
               opt_state: Mapping[str, Any]) -> None:
    """Write a restored ``{"params", "opt"}`` tree (either package's
    layout) into the live parameter and optimizer tensors, in place."""
    def fill(flat_tensors, sub):
        arrays = convert.lm_layers_from_params(sub)
        if sorted(arrays) != sorted(flat_tensors):
            raise ValueError("checkpoint keys differ from the state's: "
                             f"{sorted(set(arrays) ^ set(flat_tensors))}")
        for k, t in flat_tensors.items():
            t.copy_(torch.from_numpy(arrays[k]))

    fill(dict(params), tree["params"])
    fill(_moment_leaves(opt_state["m"]), tree["opt"]["m"])
    fill(_moment_leaves(opt_state["v"]), tree["opt"]["v"])
    opt_state["count"].copy_(torch.as_tensor(np.asarray(
        tree["opt"]["count"])))


class AsyncCheckpointer:
    """Background-thread writer; ``wait()`` drains before exit or
    preemption.  ``submit`` copies the tree to the host before it
    returns."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, meta = item
            try:
                save(self.ckpt_dir, step, tree, meta, self.keep)
            except BaseException as e:       # surfaced on next wait()
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree: Tree,
               metadata: Optional[Dict] = None) -> None:
        self._q.put((step, _to_host(tree), metadata))

    def wait(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join()
