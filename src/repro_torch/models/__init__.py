"""LM substrate: the assigned architecture pool.

Counterpart of ``repro/models``: ``TransformerLM`` (``dense``, ``moe``,
``vlm``), ``MambaLM`` (``ssm``), ``GriffinLM`` (``hybrid``) and
``WhisperModel`` (``encdec``), built by family with ``build_model``.
"""
from .common import ArchConfig
from .registry import build_model
from .transformer import TransformerLM
from .mamba import MambaLM
from .rglru import GriffinLM
from .whisper import WhisperModel
from . import layers

__all__ = ["ArchConfig", "build_model", "TransformerLM", "MambaLM",
           "GriffinLM", "WhisperModel", "layers"]
