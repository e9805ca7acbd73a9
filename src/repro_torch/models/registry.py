"""Model registry: family -> implementation class.

Counterpart of ``repro/models/registry.py``: the transformer families
(``dense``, ``moe``, ``vlm``) build ``TransformerLM``, ``ssm`` builds
``MambaLM``, ``hybrid`` ``GriffinLM`` and ``encdec`` ``WhisperModel``.
"""
from __future__ import annotations

from ..device import DeviceLike
from .common import ArchConfig
from .mamba import MambaLM
from .rglru import GriffinLM
from .transformer import TransformerLM
from .whisper import WhisperModel

__all__ = ["build_model", "FAMILIES"]

FAMILIES = {
    "dense": TransformerLM,
    "moe": TransformerLM,
    "vlm": TransformerLM,
    "ssm": MambaLM,
    "hybrid": GriffinLM,
    "encdec": WhisperModel,
}


def build_model(cfg: ArchConfig, *, device: DeviceLike = None):
    """The model of ``cfg``'s family on ``device`` (``None`` means
    ``"cuda"``), parameters unset (``init(generator)`` draws them)."""
    try:
        cls = FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r} for arch {cfg.name}")
    return cls(cfg, device=device)
