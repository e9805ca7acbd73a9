"""Serving example: batched requests through prefill + greedy decode, on
the port (the reference's ``examples/serve_lm.py``).

A queue of variable-length "requests" on a reduced qwen3-family model is
left-padded into one batch, prefilled through the KV cache, then decoded
greedily with the shared cache.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm              # card
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

``main`` returns the prompts and tokens it printed.  ``state_dict``
loads given weights in place of the seeded draw, and ``compute_dtype``
overrides the config's (the tests hold the tokens to the reference's on
the reference's own weights).
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import greedy_decode, prefill_with_decode


def main(device: str = "cuda", requests: int = 6, max_prompt: int = 24,
         gen: int = 24, state_dict=None, compute_dtype=None) -> dict:
    dev = resolve_device(device)
    cfg = get_smoke_config("qwen3_1_7b")
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = build_model(cfg, device=dev)
    if state_dict is None:
        model.init(torch.Generator(device=dev).manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    rng = np.random.default_rng(0)

    # a batch of variable-length requests, left-padded to one shape
    lens = rng.integers(4, max_prompt + 1, requests)
    pad = int(lens.max())
    prompts = np.zeros((requests, pad), np.int32)
    for i, ln in enumerate(lens):
        prompts[i, pad - ln:] = rng.integers(1, cfg.vocab, ln)
    print(f"serving {requests} requests, prompt lens {lens.tolist()}, "
          f"padded to {pad}, generating {gen} tokens each")

    cache = model.init_cache(requests, pad + gen)
    t0 = time.perf_counter()
    last_logits, cache = prefill_with_decode(
        model, cache, torch.from_numpy(prompts).to(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_pre = time.perf_counter() - t0

    t0 = time.perf_counter()
    toks, _ = greedy_decode(model, cache, last_logits, pad, gen)
    toks = toks.cpu().numpy()
    t_dec = time.perf_counter() - t0

    thru = requests * gen / t_dec
    print(f"prefill {t_pre*1e3:.0f} ms   decode {t_dec*1e3:.0f} ms "
          f"({thru:.0f} tok/s)")
    for i in range(min(3, requests)):
        print(f"  request {i}: ...{prompts[i, -4:].tolist()} -> "
              f"{toks[i][:8].tolist()}...")
    return {"prompts": prompts, "tokens": toks}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    args = ap.parse_args()
    main(device=args.device, requests=args.requests,
         max_prompt=args.max_prompt, gen=args.gen)
