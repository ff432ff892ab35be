from .annular import bloch_expand, extend_mesh
from .core import Mesh, SymInfo, find_simplices, unique_simplices
from .generate import annular_halfcell, box_mesh, cylinder_points, rijke_mesh
from .refine import compose_prolongations, octosplit, p1_prolongation

__all__ = ["Mesh", "SymInfo", "find_simplices", "unique_simplices",
           "box_mesh", "cylinder_points", "rijke_mesh", "annular_halfcell",
           "extend_mesh", "bloch_expand", "octosplit", "p1_prolongation",
           "compose_prolongations"]
