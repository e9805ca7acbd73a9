"""Device resolution and the capability probe behind the tests' skip marks.

``resolve_device`` is the one rule every device-landing entry point shares
(``DeviceSnapshot.from_padded`` / ``from_hlindex``, ``build_engine``,
``HLIndexEngine.build``): ``None`` means ``"cuda"``, and a CUDA request on
a host without a CUDA device raises instead of carrying on on the CPU.

``gpu_probe`` reports what the host offers (CUDA device, ``nvcc``) — the
counterpart of the reference's ``interpret_available()`` probe — so tests
that need the card can skip with a reason, decided inside the test or a
fixture, never at import time.
"""
from __future__ import annotations

import os
import shutil
import warnings
from typing import Dict, Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "host_to_device", "find_nvcc", "gpu_probe"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the host (nothing falls back to the CPU on its own)")
    return dev


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``device`` that never shares the memory of a
    read-only host array.

    A restored engine's arrays are read-only views into its checkpoint
    file's ``np.memmap`` (``repro_torch.store``).  A tensor ignores that
    flag, so an in-place write through one that shares those pages would
    kill the process instead of raising.  A read-only ``a`` is therefore
    copied: on the CPU into fresh memory, on a CUDA device by the
    host->device copy itself (the shared CPU view lives only for that
    copy).  A writable ``a`` takes the usual ``from_numpy(a).to(device)``
    route, which shares ``a`` on the CPU as before."""
    a = np.asarray(a)
    if a.flags.writeable:
        return torch.from_numpy(a).to(device)
    if device.type == "cpu":
        return torch.from_numpy(a.copy())
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array "
                                "is not writable", category=UserWarning)
        return torch.from_numpy(a).to(device)


def find_nvcc() -> Optional[str]:
    """Path of the CUDA compiler, or ``None``: ``$CUDA_HOME/bin/nvcc``,
    then ``nvcc`` on ``PATH``, then the toolkit's default location."""
    candidates = []
    root = os.environ.get("CUDA_HOME")
    if root:
        candidates.append(os.path.join(root, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


def gpu_probe() -> Dict[str, object]:
    """What the host offers for the hand-written kernels: a CUDA device
    (and its name) and a CUDA compiler to build them with."""
    has_cuda = bool(torch.cuda.is_available())
    return {
        "cuda": has_cuda,
        "device_name": torch.cuda.get_device_name(0) if has_cuda else None,
        "nvcc": find_nvcc(),
    }
