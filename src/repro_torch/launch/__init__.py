"""Launchers: mesh construction, the dry-runs, training, serving.

Counterpart of ``repro/launch``.  The exports are the reference's.  The
LM dry-run (``dryrun``), the closure dry-run (``closure_dryrun``), the
training launcher (``train``) and the serving launcher (``serve``) run as
``python -m repro_torch.launch.<name>``.  No ``XLA_FLAGS`` rule applies:
nothing here starts JAX, and the production meshes are logical
(``core/mesh.py``), so any module may be imported from any process.
"""
from .mesh import make_production_mesh, make_test_mesh
from .shapes import SHAPES, ShapeCell, cell_applicable, all_cells

__all__ = ["make_production_mesh", "make_test_mesh", "SHAPES", "ShapeCell",
           "cell_applicable", "all_cells"]
