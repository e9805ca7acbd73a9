"""Training launcher: real training on one device, with checkpoint /
restart through the supervisor.

Counterpart of ``repro/launch/train.py`` (its ``--dryrun`` compile on the
production mesh is the LM dry-run, not ported yet), with ``--device``
(``cuda`` by default; ``cpu`` asks for the host):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 100 --batch 8 --seq 256 --ckpt-dir DIR
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --steps 20 --device cpu

The weights are drawn from ``seed`` by a ``torch.Generator`` on the
device, the batches from ``seed`` by numpy (``SyntheticStream``, the
reference's draws).  A run re-invoked with the same ``--ckpt-dir``
resumes from its newest checkpoint.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional, Sequence

import torch

from ..configs import get_config, get_smoke_config
from ..device import DeviceLike, resolve_device
from ..models import build_model
from ..train import (AdamConfig, SupervisorConfig, SyntheticStream,
                     TrainSupervisor, adam_init, make_train_step,
                     model_params)

__all__ = ["run_training", "main"]


def run_training(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
                 ckpt_every: int = 50, seed: int = 0, lr: float = 3e-4,
                 mesh=None, log_every: int = 10,
                 device: DeviceLike = None):
    """Train ``cfg``'s model for ``steps`` on ``device`` (``None`` means
    ``"cuda"``), checkpointing every ``ckpt_every`` steps and at the end
    into ``ckpt_dir`` (resuming from it when it holds a checkpoint) ->
    (step, params, opt_state, metrics log).  ``mesh`` is accepted for the
    reference's signature: on one device nothing is placed."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    opt_cfg = AdamConfig(lr=lr, total_steps=steps,
                         warmup_steps=max(steps // 20, 1),
                         use_8bit=cfg.opt_8bit)
    params = model_params(model)
    opt_state = adam_init(params, opt_cfg)
    step_fn = make_train_step(model, cfg, opt_cfg)
    data = iter(SyntheticStream(cfg, batch, seq, seed=seed))
    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                         max_steps=steps),
        step_fn, data)
    start, params, opt_state = sup.resume_or_init(params, opt_state)
    if start:
        print(f"[resume] from step {start}")
    step, params, opt_state, log = sup.run(params, opt_state,
                                           start_step=start)
    for m in log:
        if m["step"] % log_every == 0 or m["step"] == step:
            print(f"step {m['step']:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                  f"({m['step_time_s']*1e3:.0f} ms)")
    if sup.straggler_events:
        print(f"[straggler] slow steps at {sup.straggler_events}")
    return step, params, opt_state, log


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, microbatch=min(cfg.microbatch, args.batch))
    return run_training(cfg, steps=args.steps, batch=args.batch,
                        seq=args.seq, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every, lr=args.lr,
                        device=args.device)


if __name__ == "__main__":
    main()
