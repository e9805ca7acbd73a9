"""The assigned input-shape cells and per-arch applicability.

LM transformer shapes are seq_len × global_batch; ``decode_*``/``long_*``
lower serve_step (one new token against a seq_len KV cache), NOT
train_step.  ``long_500k`` needs sub-quadratic attention: it runs only
for the SSM/hybrid archs; pure full-attention archs skip it (recorded —
see DESIGN.md §4)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..models.common import ArchConfig

__all__ = ["ShapeCell", "SHAPES", "cell_applicable", "all_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# families with sub-quadratic sequence mixing (run long_500k)
_SUBQUADRATIC = {"ssm", "hybrid"}


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in _SUBQUADRATIC:
        return False, ("skip: pure full-attention arch — 500k-token decode "
                       "requires sub-quadratic mixing (DESIGN.md §4)")
    return True, ""


def all_cells(arch_ids: List[str], get_config) -> List[Tuple[str, str, bool, str]]:
    """[(arch, shape, applicable, reason)] for the full 40-cell table."""
    out = []
    for a in arch_ids:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = cell_applicable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
