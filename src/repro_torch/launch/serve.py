"""Serving launcher: batched prefill + greedy decode on one device.

Counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device`` (``cuda`` by default; ``cpu`` asks for the host):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --batch 4 --prompt-len 16 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --smoke --device cpu

Every family serves: ``--arch falcon-mamba-7b`` (``ssm``) and
``recurrentgemma-2b`` (``hybrid``) through their recurrent states,
``whisper-large-v3`` (``encdec``) with seeded stand-in frames encoded
once into the cross K/V (``prefill_cross``) before the prompt.  The
weights are random, drawn from ``--seed`` by a ``torch.Generator`` on
the device; the prompts, then the frames, from ``--seed`` by numpy (one
stream, as the reference draws them).  Times are host clock
around work that ends in a device synchronise; nothing is compiled, so
they include no compile.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import DeviceLike, resolve_device
from ..models import build_model
from ..models.common import ArchConfig
from ..serve.kvcache import greedy_decode, prefill_with_decode

__all__ = ["build", "serve", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cfg: ArchConfig, *, seed: int = 0, device: DeviceLike = None):
    """``cfg``'s model on ``device`` with weights drawn from ``seed``."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return model.init(gen)


def serve(model, *, batch: int = 4, prompt_len: int = 16, gen: int = 32,
          seed: int = 0) -> Dict:
    """Prefill ``batch`` seeded prompts of ``prompt_len`` tokens through
    the KV cache (``init_cache``'s bf16), then decode ``gen`` greedy
    tokens.  An ``encdec`` model first encodes seeded frames
    [batch, enc_frames, d_model] into the cache's cross K/V
    (``prefill_cross``, counted in the prefill time).  Returns the tokens
    [batch, gen] (host int32), the prompts, the frames (``None`` for the
    other families) and the times."""
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(dev)
    frames = None
    if cfg.family == "encdec":
        frames = torch.from_numpy(rng.normal(
            size=(batch, cfg.enc_frames, cfg.d_model)).astype(
                np.float32)).to(dev)
    cache = model.init_cache(batch, prompt_len + gen)

    _sync(dev)
    t0 = time.perf_counter()
    if frames is not None:
        cache = model.prefill_cross(cache, frames)
    last_logits, cache = prefill_with_decode(model, cache, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    toks, cache = greedy_decode(model, cache, last_logits, prompt_len, gen)
    toks = toks.cpu().numpy()
    t_gen = time.perf_counter() - t0
    return dict(arch=cfg.name, batch=batch, prompt=prompt_len, gen=gen,
                prefill_s=t_prefill, decode_s=t_gen,
                tokens_per_s=gen * batch / t_gen, tokens=toks,
                prompts=prompts.cpu().numpy(), frames=frames)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg, seed=args.seed, device=args.device)
    res = serve(model, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, seed=args.seed)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={model.device}")
    print(f"prefill: {res['prefill_s']*1e3:.1f} ms   decode: "
          f"{res['decode_s']*1e3:.1f} ms ({res['tokens_per_s']:.1f} tok/s)")
    print("sample tokens:", res["tokens"][0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
