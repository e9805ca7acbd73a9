"""Fault tolerance: a supervised train loop with checkpoint / restart,
preemption handling and straggler detection.

Counterpart of ``repro/train/fault_tolerance.py``; the mechanisms are
the reference's:

* **restart**: ``resume_or_init`` restores the newest checkpoint (atomic
  writes guarantee a consistent one) into the live parameters and
  optimizer state; a run re-invoked with the same arguments continues
  where the last checkpoint left off.
* **preemption**: SIGTERM sets a flag; the loop checkpoints at the next
  step boundary and exits cleanly.
* **stragglers**: per-step wall time is tracked with an EMA; a step
  slower than ``straggler_factor`` x the EMA is logged as a straggler
  event.

Checkpoints hold logical state only (whole arrays in the reference's
layout, ``train.checkpoint.state_tree``), so either package resumes the
other's run.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, Iterator, List, Optional

from . import checkpoint as ckpt

__all__ = ["SupervisorConfig", "TrainSupervisor"]


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_steps: int = 200
    straggler_factor: float = 3.0
    ema_decay: float = 0.9
    handle_sigterm: bool = True


class TrainSupervisor:
    """Drives ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` over ``data_iter``; ``params`` is the model's
    ``{name: parameter}`` and ``opt_state`` ``adam_init``'s, both updated
    in place by the step."""

    def __init__(self, cfg: SupervisorConfig, train_step: Callable,
                 data_iter: Iterator, *, async_ckpt: bool = True):
        self.cfg = cfg
        self.train_step = train_step
        self.data = data_iter
        self.preempted = False
        self.straggler_events: List[int] = []
        self.metrics_log: List[Dict[str, float]] = []
        self._ckpt = (ckpt.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep)
                      if async_ckpt else None)
        if cfg.handle_sigterm:
            try:
                signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:
                pass                      # not on the main thread (tests)

    def _on_sigterm(self, signum, frame):
        self.preempted = True

    def _save(self, step: int, params, opt_state):
        tree = ckpt.state_tree(params, opt_state)     # host copy, now
        if self._ckpt is not None:
            self._ckpt.submit(step, tree, {"mesh_note": "logical-state-only"})
        else:
            ckpt.save(self.cfg.ckpt_dir, step, tree, keep=self.cfg.keep)

    def resume_or_init(self, params, opt_state):
        """Restore the latest checkpoint, if there is one, into ``params``
        and ``opt_state`` (in place) -> (step, params, opt_state); step 0
        and the arguments untouched when there is none."""
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return 0, params, opt_state
        step, tree, _ = ckpt.restore(self.cfg.ckpt_dir,
                                     ckpt.state_like(params, opt_state))
        ckpt.load_state(tree, params, opt_state)
        return step, params, opt_state

    def run(self, params, opt_state, *, start_step: int = 0):
        """Run to ``max_steps`` (or preemption) -> (step, params,
        opt_state, metrics_log)."""
        cfg = self.cfg
        step = start_step
        ema: Optional[float] = None
        while step < cfg.max_steps and not self.preempted:
            batch = next(self.data)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            loss = float(metrics["loss"])           # waits for the step
            dt = time.perf_counter() - t0
            if ema is not None and dt > cfg.straggler_factor * ema:
                self.straggler_events.append(step)
            ema = dt if ema is None else \
                cfg.ema_decay * ema + (1 - cfg.ema_decay) * dt
            step += 1
            self.metrics_log.append(
                {"step": step, "loss": loss,
                 "grad_norm": float(metrics["grad_norm"]),
                 "lr": float(metrics["lr"]), "step_time_s": dt})
            if step % cfg.ckpt_every == 0 or step == cfg.max_steps:
                self._save(step, params, opt_state)
        if self.preempted:
            self._save(step, params, opt_state)   # graceful preemption save
        if self._ckpt is not None:
            self._ckpt.wait()
        return step, params, opt_state, self.metrics_log
