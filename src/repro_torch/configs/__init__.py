"""Assigned architecture configs (exact specs from the public pool) plus
reduced smoke variants and the paper-core reachability workloads.

``get_config(name)`` returns the full config; ``get_smoke_config(name)``
returns a same-family reduction that runs a forward/train step on CPU.

Counterpart of ``repro/configs``: the same ten modules, ids and aliases,
field for field.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.common import ArchConfig

ARCH_IDS: List[str] = [
    "llava_next_mistral_7b",
    "falcon_mamba_7b",
    "qwen2_5_14b",
    "qwen2_7b",
    "qwen3_1_7b",
    "minitron_8b",
    "whisper_large_v3",
    "qwen2_moe_a2_7b",
    "arctic_480b",
    "recurrentgemma_2b",
]

# canonical dashed ids from the assignment -> module names
ALIASES: Dict[str, str] = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-1.7b": "qwen3_1_7b",
    "minitron-8b": "minitron_8b",
    "whisper-large-v3": "whisper_large_v3",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "arctic-480b": "arctic_480b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.SMOKE


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
