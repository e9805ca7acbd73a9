#!/usr/bin/env python3
"""The LM dry-run's closed-form collectives against XLA's count, at smoke
widths on the reference's 16 x 16 mesh (the table of
``docs/ARCHITECTURE_TORCH.md``).

    PYTHONPATH=src python3 tools/lm_collective_ratios.py

For each (arch, shape) row the reference's ``lower_cell`` runs with the
SMOKE config's fields as ``overrides`` in a subprocess that sees 512
forced host devices (it reads XLA's executed collectives from the
compiled HLO), and the port's ``lower_cell`` runs here on ``meta``
records.  Prints one Markdown row per cell: port bytes over reference
bytes of ``collective_executed`` by kind (``port only`` where XLA moves
none, ``0 / 0`` where neither does) and in total.  CPU only; a few
minutes, most of it the reference's compiles.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

ROWS = [("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
        ("qwen3-1.7b", "decode_32k"), ("qwen2-moe-a2.7b", "train_4k"),
        ("qwen2-moe-a2.7b", "prefill_32k"), ("qwen2-moe-a2.7b", "decode_32k"),
        ("llava-next-mistral-7b", "prefill_32k"),
        ("falcon-mamba-7b", "train_4k"), ("falcon-mamba-7b", "decode_32k"),
        ("recurrentgemma-2b", "train_4k"),
        ("whisper-large-v3", "prefill_32k")]
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_REFERENCE = """
import dataclasses, json
from repro.configs import get_smoke_config
from repro.launch.dryrun import lower_cell
out = []
for arch, shape in ROWS:
    sm = get_smoke_config(arch)
    ov = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)}
    out.append(lower_cell(arch, shape, overrides=ov)["collective_executed"])
print("RECORDS" + json.dumps(out))
"""


def reference_records():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    out = subprocess.run([sys.executable, "-c",
                          f"ROWS = {ROWS!r}\n" + _REFERENCE], env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.split("RECORDS")[-1])


def port_records():
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    out = []
    for arch, shape in ROWS:
        sm = get_smoke_config(arch)
        ov = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)}
        out.append(dryrun.lower_cell(arch, shape, overrides=ov,
                                     device="cpu")["collective_executed"])
    return out


def ratio(port: int, ref: int) -> str:
    if ref == 0:
        return "0 / 0" if port == 0 else "port only"
    return f"{port / ref:.3f}"


def main() -> None:
    for (arch, shape), ref, port in zip(ROWS, reference_records(),
                                        port_records()):
        cells = [ratio(port["bytes"][k], ref["bytes"][k]) for k in KINDS]
        total = port["total_bytes"] / ref["total_bytes"]
        print(f"| `{arch}` | `{shape}` | " + " | ".join(cells)
              + f" | {total:.4f} |", flush=True)


if __name__ == "__main__":
    main()
