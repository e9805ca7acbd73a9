"""PyTorch / CUDA port of the HL-index hypergraph reachability system.

A second package beside the JAX reference (``repro``): host-side index
construction in numpy, device-side label tensors and batched joins in
PyTorch, and the TPU kernels re-written by hand as CUDA C++ for Hopper
(``repro_torch/kernels/csrc``).  The package imports ``torch`` and
``numpy`` only; the public surface is ``repro_torch.api``.

Device rule: every entry point that lands data on a device takes
``device=None``, and ``None`` means ``"cuda"``.  Without a CUDA device the
call raises unless the caller passes ``device="cpu"`` explicitly — nothing
falls back to the CPU on its own.
"""

__all__ = ["api", "convert", "device"]
