"""Launchers: mesh construction, the closure dry-run, serving.

Counterpart of ``repro/launch``.  The exports are the reference's; the
closure dry-run (``closure_dryrun``) and the serving launcher (``serve``)
run as ``python -m repro_torch.launch.<name>``.
"""
from .mesh import make_production_mesh, make_test_mesh
from .shapes import SHAPES, ShapeCell, cell_applicable, all_cells

__all__ = ["make_production_mesh", "make_test_mesh", "SHAPES", "ShapeCell",
           "cell_applicable", "all_cells"]
