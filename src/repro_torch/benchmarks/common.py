"""What every benchmark script of the port shares: where its JSON goes,
the ``env`` block that names the device it ran on, the ``--device`` /
``--out`` arguments, and host copies of answers.

The scripts write ``build/bench_torch/BENCH_<name>.json`` under the
checkout by default, never the reference's ``BENCH_*.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["OUT_DIR", "default_out", "env_block", "write_doc", "to_host",
           "add_common_args"]

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "bench_torch"


def default_out(name: str) -> str:
    """``build/bench_torch/BENCH_<name>.json`` under the checkout."""
    return str(OUT_DIR / f"BENCH_{name}.json")


def _power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def env_block(device: DeviceLike) -> Dict[str, object]:
    """The device a run used: its type and name, the card's power limit
    (``nvidia-smi``; None on the host) and the torch version."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    return {"device": dev.type,
            "device_name": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
            "nvidia_smi": _power_limit() if cuda else None,
            "torch": torch.__version__,
            "cuda": torch.version.cuda if cuda else None}


def write_doc(doc: Dict, out_path: str) -> None:
    path = pathlib.Path(out_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    print(f"wrote {out_path}")


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def add_common_args(ap: argparse.ArgumentParser, name: str) -> None:
    """``--device`` (default ``cuda``; ``cpu`` runs on the host) and
    ``--out`` (default ``build/bench_torch/BENCH_<name>.json``)."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out(name))
