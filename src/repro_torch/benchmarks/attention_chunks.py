"""The chunked attention of the LM models (``models/layers._sdpa_chunked``)
alone, at one config's attention shapes: its time and the peak memory it
adds above its inputs, for a forward without gradients (prefill) and a
forward plus backward (training).

It imports only ``repro_torch.configs`` and ``repro_torch.models.layers``,
so run by path it measures whichever ``repro_torch`` is first on
``PYTHONPATH``: two versions of the function compare in one process
layout, each in its own process.  ``--against FILE`` reads another run's
JSON and adds the largest absolute difference of the sampled outputs.

On the card the times are CUDA events, the median of 3 after one
warm-up, and the peak is ``torch.cuda.max_memory_allocated``
over those calls less the bytes allocated before them; on the host
(``--device cpu``) the times are the host clock and the peak is
``None``.  Inputs are bf16 normal values from seed 0, batch 1.

  PYTHONPATH=src python src/repro_torch/benchmarks/attention_chunks.py \\
      --arch qwen3-1.7b --seq 32768 --out build/attn.json
  PYTHONPATH=src python src/repro_torch/benchmarks/attention_chunks.py \\
      --arch qwen3-1.7b --seq 4096 --backward
  PYTHONPATH=src python src/repro_torch/benchmarks/attention_chunks.py \\
      --arch qwen3-1.7b --smoke --seq 64 --chunk 16 --device cpu
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import layers

SAMPLES = 256        # output entries kept for --against
REPEATS = 3


def _inputs(cfg, seq: int, device: torch.device, grad: bool):
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = []
    for heads in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads):
        t = torch.randn(1, seq, heads, cfg.hd, generator=gen)
        out.append(t.to(device=device, dtype=torch.bfloat16)
                   .requires_grad_(grad))
    return out


def sample_of(out: torch.Tensor) -> List[float]:
    """``SAMPLES`` entries of ``out`` at evenly spaced flat indices (in
    integers: float32 positions round past 2^24 entries)."""
    flat = out.float().flatten()
    idx = torch.arange(SAMPLES, device=out.device) * (flat.numel() - 1) \
        // (SAMPLES - 1)
    return flat[idx].tolist()


def measure(arch: str, seq: int, *, backward: bool = False,
            chunk: Optional[int] = None, smoke: bool = False,
            device: str = "cuda") -> Dict[str, Any]:
    """One config's chunked causal attention at ``[1, seq]``: times,
    the peak above the inputs and a strided sample of the output."""
    cfg = (get_smoke_config if smoke else get_config)(arch)
    chunk = chunk or cfg.attn_chunk
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    q, k, v = _inputs(cfg, seq, dev, backward)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    weights = torch.linspace(-1.0, 1.0, q.numel(), device=dev).reshape(
        q.shape)

    def one():
        if backward:
            out = layers._sdpa_chunked(q, k, v, n_rep, causal=True, window=0,
                                       chunk_q=chunk, chunk_k=chunk)
            (out.float() * weights).sum().backward()
            q.grad = k.grad = v.grad = None
            return out.detach()
        with torch.no_grad():
            return layers._sdpa_chunked(q, k, v, n_rep, causal=True,
                                        window=0, chunk_q=chunk,
                                        chunk_k=chunk)

    out = one()                                    # the warm-up
    sample = sample_of(out)
    del out
    times: List[float] = []
    peak = None
    if on_card:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            one()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        peak = torch.cuda.max_memory_allocated(dev) - base
    else:
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            one()
            times.append(time.perf_counter() - t0)
    return dict(
        arch=arch, smoke=smoke, seq=seq, chunk=chunk,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        backward=backward, device=dev.type,
        q_chunks_per_step=getattr(layers, "Q_CHUNKS_PER_STEP", 1),
        time_s=statistics.median(times), times_s=times,
        peak_bytes_above_inputs=peak, sample=sample)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's smoke widths")
    ap.add_argument("--seq", type=int, default=32768)
    ap.add_argument("--chunk", type=int, default=None,
                    help="q and kv chunk (default: the config's attn_chunk)")
    ap.add_argument("--backward", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tag", default="", help="a label kept in the JSON")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    ap.add_argument("--against", default=None,
                    help="another run's JSON: add max_abs_diff of samples")
    args = ap.parse_args(argv)
    rec = measure(args.arch, args.seq, backward=args.backward,
                  chunk=args.chunk, smoke=args.smoke, device=args.device)
    rec["tag"] = args.tag
    if args.against:
        with open(args.against) as f:
            other = json.load(f)["sample"]
        rec["max_abs_diff"] = max(abs(a - b)
                                  for a, b in zip(rec["sample"], other))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)
    print(json.dumps({k: v for k, v in rec.items() if k != "sample"}),
          flush=True)
    return rec


if __name__ == "__main__":
    main()
