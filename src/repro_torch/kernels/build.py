"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into a shared library that ``ctypes`` loads —
no PyTorch headers, so a build takes seconds.  Nothing is built when the
package is imported: ``load_library`` runs at a kernel's first launch, and
``build_libraries`` compiles several sources at once (one ``nvcc`` process
each, all started together).  ``launch`` is how a wrapper enqueues its
kernel: on PyTorch's current stream, raising on a refused launch.
``tma_operand`` is the operand format of the tensor-core kernels
(``csrc/tc_gemm.cuh``), in one place for both wrappers.

Libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``) under a name that carries the content
hash of the source and of every shared header in ``csrc/`` (``*.cuh``),
and the compile flags, so an edited source or header is rebuilt and a
stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

from ..device import find_nvcc

__all__ = ["NVCC_FLAGS", "CSRC_DIR", "default_build_dir", "build_libraries",
           "load_library", "launch", "BUILD_LOG", "TMA_ROW_MULTIPLE",
           "tma_extent", "tma_operand"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> what nvcc printed (registers / shared memory per kernel)
BUILD_LOG: Dict[str, str] = {}

# bf16 values per 16 bytes: TMA reads rows whose stride is a multiple of it
TMA_ROW_MULTIPLE = 8

_LOADED: Dict[str, ctypes.CDLL] = {}
# held while a library is built and loaded: a service's admission thread
# and the caller's thread may both reach a kernel's first launch
_LOAD_LOCK = threading.Lock()


def default_build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout
    (``src/repro_torch/kernels/build.py`` is three levels below it)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _library_path(name: str, build_dir: Path) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    if not source.is_file():
        raise FileNotFoundError(f"no kernel source {source}")
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"{name}-{digest.hexdigest()[:16]}.so"


def _start_nvcc(nvcc: str, name: str, target: Path) -> subprocess.Popen:
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_libraries(names: Iterable[str],
                    build_dir: Optional[Path] = None) -> Dict[str, Path]:
    """Compile every named source that is not built yet, in parallel, and
    return name -> library path.  Raises ``RuntimeError`` with the
    compiler's output if ``nvcc`` is missing or a source does not compile."""
    build_dir = Path(build_dir) if build_dir is not None else default_build_dir()
    paths = {name: _library_path(name, build_dir) for name in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build CUDA kernels {sorted(todo)}: nvcc not found "
            f"(looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin)")
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {n: _start_nvcc(nvcc, n, p) for n, p in todo.items()}
    failures = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        tmp = todo[name].with_suffix(f".{os.getpid()}.tmp")
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, todo[name])      # atomic: no half-written library
    if failures:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built at first use and
    loaded once per process, from any thread.  The caller sets
    ``argtypes`` / ``restype``."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                path = build_libraries([name])[name]
                lib = ctypes.CDLL(str(path))
                _LOADED[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def _entry_point(name: str, symbol: str, argtypes: tuple):
    """``symbol`` of library ``name`` with its C signature declared: the
    given argument types, then the stream; returns a CUDA error code."""
    fn = getattr(load_library(name), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, symbol: str, argtypes: Sequence, device: torch.device,
           args: Sequence, what: str) -> None:
    """Enqueue one kernel: call ``symbol`` of library ``name`` with ``args``
    and the current PyTorch stream of ``device`` (built and loaded at the
    first call).  Never waits for the kernel; raises ``RuntimeError`` if the
    launch was refused (``what`` names the call in the message)."""
    fn = _entry_point(name, symbol, tuple(argtypes))
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")


def tma_extent(n: int) -> int:
    """``n`` rounded up to a multiple of ``TMA_ROW_MULTIPLE``."""
    return -(-n // TMA_ROW_MULTIPLE) * TMA_ROW_MULTIPLE


def tma_operand(x: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """``x`` (contiguous, 0/1) as a tensor-core kernel's operand: bf16 (exact
    for 0/1), its last ``dims`` dimensions rounded up by ``tma_extent`` with
    zeros past the old edge, its base 16-byte aligned.  No copy where ``x``
    is such a tensor already."""
    shape = tuple(x.shape)
    padded = shape[:-dims] + tuple(tma_extent(d) for d in shape[-dims:])
    if padded == shape:
        out = x.to(torch.bfloat16)
    else:
        out = torch.zeros(padded, dtype=torch.bfloat16, device=x.device)
        out[tuple(slice(0, d) for d in shape)] = x
    if out.data_ptr() % 16:            # TMA reads from 16-byte aligned bases
        out = out.clone()
    return out
