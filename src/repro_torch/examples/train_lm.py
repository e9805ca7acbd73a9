"""End-to-end training example on the port (the reference's
``examples/train_lm.py``): the data pipeline's hypergraph dedup stage,
the supervised train loop with checkpoints, then a resume.

The default config is small enough for the host in minutes; ``--params
100m`` is the ~100M-parameter one (same code path).

  PYTHONPATH=src python -m repro_torch.examples.train_lm          # card
  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
      --steps 40

``main`` returns the dedup result, the loss log and the resumed run's
start step.  A temporary checkpoint directory is made and removed unless
``ckpt_dir`` is given.
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.launch.train import run_training
from repro_torch.models.common import ArchConfig
from repro_torch.train import checkpoint, dedup_corpus


def make_config(size: str) -> ArchConfig:
    if size == "100m":
        return ArchConfig(name="demo-100m", family="dense", n_layers=10,
                          d_model=640, n_heads=10, n_kv_heads=5, d_ff=2560,
                          vocab=32000, attn_chunk=0, microbatch=2,
                          scan_layers=True, remat=False)
    return ArchConfig(name="demo-5m", family="dense", n_layers=4,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                      vocab=2048, attn_chunk=0, microbatch=2,
                      scan_layers=True, remat=False)


def dedup_stage(vocab: int):
    """40 seeded documents plus 10 near-duplicates of the first 10 (their
    first 4 tokens redrawn) -> (documents, kept, components)."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, vocab, 96) for _ in range(40)]
    docs += [d.copy() for d in docs[:10]]          # inject near-dups
    for d in docs[40:]:
        d[:4] = rng.integers(0, vocab, 4)
    kept, comp = dedup_corpus(docs, s=8, k=4)
    return docs, kept, comp


def main(device: str = "cuda", steps: int = 120, batch: int = 4,
         seq: int = 64, params: str = "5m", ckpt_dir=None) -> dict:
    cfg = make_config(params)
    print(f"config: {cfg.name}  ~{cfg.n_params()/1e6:.1f}M params")

    # --- data-pipeline dedup stage (the paper's engine in production) ----
    docs, kept, comp = dedup_stage(cfg.vocab)
    print(f"dedup stage: {len(docs)} docs -> {len(kept)} kept "
          f"({len(docs) - len(kept)} s-reachable near-dups dropped)")

    # --- train with checkpoint / resume ----------------------------------
    own = ckpt_dir is None
    ckpt_dir = tempfile.mkdtemp(prefix="train_lm_") if own else ckpt_dir
    try:
        every = max(steps // 3, 10)
        step, _, _, log = run_training(cfg, steps=steps, batch=batch,
                                       seq=seq, ckpt_dir=ckpt_dir,
                                       ckpt_every=every, device=device)
        first = np.mean([m["loss"] for m in log[:5]]) if log else np.nan
        last = np.mean([m["loss"] for m in log[-5:]]) if log else np.nan
        print(f"loss: first-5 {first:.3f} -> last-5 {last:.3f}")
        # the same command again resumes from the newest checkpoint
        saved = checkpoint.all_steps(ckpt_dir)
        resumed, _, _, _ = run_training(cfg, steps=steps, batch=batch,
                                        seq=seq, ckpt_dir=ckpt_dir,
                                        ckpt_every=every, device=device)
        print(f"resumed from step {saved[-1]} -> step {resumed} "
              f"(checkpoints {saved})")
    finally:
        if own:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"kept": kept, "comp": comp, "losses": [m["loss"] for m in log],
            "step": step, "checkpoints": saved, "resumed_step": resumed}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--params", choices=["5m", "100m"], default="5m")
    ap.add_argument("--ckpt-dir", type=str, default=None)
    args = ap.parse_args()
    main(device=args.device, steps=args.steps, batch=args.batch,
         seq=args.seq, params=args.params, ckpt_dir=args.ckpt_dir)
