"""Point evaluation of FEM solution fields.

Host numpy, copied from the JAX package's ``fem/getters.py``.
Counterpart of the reference's helmholtz getters
(src/FEM/helmholtz_getters.jl): infer the element order
from the solution-vector length, locate the containing tetrahedron, and
evaluate shape functions / directional derivatives at arbitrary physical
points.
"""
from __future__ import annotations

import numpy as np

from ..mesh.core import Mesh
from . import elements as fel
from .assembly import TET_EDGES


def infer_order(mesh: Mesh, sol_len: int):
    """Element order from solution length (helmholtz_getters.jl:47-68):
    #points → 1 (P1); #points+#edges → 2 (P2); 4·#points+#faces →
    'herm' (cubic Hermite)."""
    if sol_len == mesh.n_points:
        return 1
    mesh.collect_lines()
    if sol_len == mesh.n_points + len(mesh.lines):
        return 2
    from .assembly import aggregate_elements
    _, _, herm_dim = aggregate_elements(mesh, "herm")
    if sol_len == herm_dim:
        return "herm"
    raise ValueError(f"cannot infer element order from solution length "
                     f"{sol_len} (points: {mesh.n_points}, "
                     f"P2 DOFs: {mesh.n_points + len(mesh.lines)}, "
                     f"Hermite DOFs: {herm_dim})")


def aggregate_element(mesh: Mesh, tet_idx: int, order) -> np.ndarray:
    """Global DOF indices of one tetrahedron
    (aggregate_element, helmholtz_getters.jl:72-118)."""
    tet = mesh.tetrahedra[tet_idx]
    if order == 1:
        return tet.copy()
    if order == 2:
        edges = np.array([[tet[i], tet[j]] for i, j in TET_EDGES])
        return np.concatenate(
            [tet, mesh.edge_indices(edges) + mesh.n_points])
    if order == "herm":
        from .assembly import aggregate_elements
        _, tet_dofs, _ = aggregate_elements(mesh, "herm")
        return tet_dofs[tet_idx]
    raise ValueError(f"unsupported order {order}")


def get_p(mesh: Mesh, sol: np.ndarray, x, tet_idx: int | None = None):
    """Field value p(x) of a FEM solution vector at physical point x
    (get_p, helmholtz_getters.jl:7-23)."""
    sol = np.asarray(sol)
    order = infer_order(mesh, len(sol))
    if tet_idx is None:
        tet_idx = mesh.find_tetrahedron_containing_point(x)
    dofs = aggregate_element(mesh, tet_idx, order)
    N = fel.shape_values_at_point(mesh.points, mesh.tetrahedra[tet_idx],
                                  order, x)
    return (N * sol[dofs]).sum()


def get_n_grad_p(mesh: Mesh, sol: np.ndarray, x, n,
                 tet_idx: int | None = None):
    """Directional derivative n·∇p at physical point x
    (get_n_grad_p, helmholtz_getters.jl:31-45)."""
    sol = np.asarray(sol)
    order = infer_order(mesh, len(sol))
    if tet_idx is None:
        tet_idx = mesh.find_tetrahedron_containing_point(x)
    dofs = aggregate_element(mesh, tet_idx, order)
    g = fel.tet_grad_at_point(mesh.points, mesh.tetrahedra[tet_idx],
                              order, n, x)
    return (g * sol[dofs]).sum()


__all__ = ["get_p", "get_n_grad_p", "infer_order", "aggregate_element"]
