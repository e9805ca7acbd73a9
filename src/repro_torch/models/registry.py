"""Model registry: family -> implementation class.

Counterpart of ``repro/models/registry.py``.  The transformer families
(``dense``, ``moe``, ``vlm``) build ``TransformerLM``; Mamba (``ssm``),
RG-LRU (``hybrid``) and Whisper (``encdec``) are not ported yet
(ROADMAP A12b-2) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from ..device import DeviceLike
from .common import ArchConfig
from .transformer import TransformerLM

__all__ = ["build_model", "FAMILIES", "NOT_PORTED"]

FAMILIES = {
    "dense": TransformerLM,
    "moe": TransformerLM,
    "vlm": TransformerLM,
}

# the reference's classes for the families still to port
NOT_PORTED = {"ssm": "MambaLM", "hybrid": "GriffinLM",
               "encdec": "WhisperModel"}


def build_model(cfg: ArchConfig, *, device: DeviceLike = None):
    """The model of ``cfg``'s family on ``device`` (``None`` means
    ``"cuda"``), parameters unset (``init(generator)`` draws them)."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.family} models ({NOT_PORTED[cfg.family]}, arch "
            f"{cfg.name}) are not ported yet: ROADMAP A12b-2")
    try:
        cls = FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r} for arch {cfg.name}")
    return cls(cfg, device=device)
