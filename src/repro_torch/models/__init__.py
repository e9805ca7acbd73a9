"""LM substrate: the assigned architecture pool.

Counterpart of ``repro/models`` for the transformer families (``dense``,
``moe``, ``vlm``: ``TransformerLM``).  ``MambaLM``, ``GriffinLM`` and
``WhisperModel`` are not ported yet; ``build_model`` says so.
"""
from .common import ArchConfig
from .registry import build_model
from .transformer import TransformerLM
from . import layers

__all__ = ["ArchConfig", "build_model", "TransformerLM", "layers"]
