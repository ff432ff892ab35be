from .core import Mesh, find_simplices, unique_simplices
from .generate import box_mesh, cylinder_points, rijke_mesh
from .refine import compose_prolongations, octosplit, p1_prolongation

__all__ = ["Mesh", "find_simplices", "unique_simplices", "box_mesh",
           "cylinder_points", "rijke_mesh", "octosplit", "p1_prolongation",
           "compose_prolongations"]
