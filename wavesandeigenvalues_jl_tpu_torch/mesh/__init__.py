from .annular import bloch_expand, extend_mesh
from .core import (Mesh, SymInfo, color_domains, find_simplices,
                   unique_simplices)
from .generate import annular_halfcell, box_mesh, cylinder_points, rijke_mesh
from .io import read_ansys, read_mesh, read_msh2, read_msh4, read_nastran
from .refine import compose_prolongations, octosplit, p1_prolongation
from .vtk import vtk_write, vtk_write_tri

__all__ = ["Mesh", "SymInfo", "find_simplices", "unique_simplices",
           "read_mesh", "read_msh2", "read_msh4", "read_nastran",
           "read_ansys", "octosplit", "vtk_write", "vtk_write_tri",
           "extend_mesh", "color_domains", "box_mesh", "cylinder_points",
           "rijke_mesh", "annular_halfcell", "bloch_expand",
           "p1_prolongation", "compose_prolongations"]
