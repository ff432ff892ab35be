"""Global DOF aggregation and gather–kernel–scatter assembly (host numpy,
copied from the JAX package's ``fem/assembly.py``, P1 and P2).

Replaces the reference's per-element COO append loops
(Helmholtz.jl:405-525) with: one vectorized DOF-numbering pass
(aggregate_elements, FEM.jl:84-166), batched element-kernel evaluation
([ne,k,k] tensors from :mod:`.elements`), and a single duplicate-summing
scatter into CSR."""
from __future__ import annotations

import numpy as np

from ..mesh.core import Mesh
from ..utils.config import CDTYPE

TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
TRI_EDGES = [(0, 1), (0, 2), (1, 2)]


def aggregate_elements(mesh: Mesh, order: str = "lin"):
    """Global DOF index lists per element and total DOF count
    (aggregate_elements, FEM.jl:84-166).

    order 'lin': P1 (DOF = points); 'quad': P2 (points, then one DOF per
    edge of ``mesh.lines``, filled in by ``collect_lines``).  Returns
    (tri_dofs [nt, k2], tet_dofs [ne, k3], dim).

    The P2 numbering is cached on the mesh, keyed by a connectivity
    fingerprint (DOF numbering depends only on connectivity)."""
    n_pts = mesh.n_points
    if order == "lin":
        return mesh.triangles.copy(), mesh.tetrahedra.copy(), n_pts
    if order != "quad":
        raise NotImplementedError(
            f"element order {order!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 7; the port assembles 'lin' and 'quad')")
    fp = (order, n_pts, len(mesh.lines), len(mesh.triangles),
          len(mesh.int_triangles), len(mesh.tetrahedra))
    cache = getattr(mesh, "_dof_cache", None)
    if cache is None or cache[0] != fp:
        out = _aggregate_quad(mesh)
        # fingerprint AFTER building (collect_lines fills in the lines)
        fp = (order, n_pts, len(mesh.lines), len(mesh.triangles),
              len(mesh.int_triangles), len(mesh.tetrahedra))
        mesh._dof_cache = cache = (fp, out)
    tri_dofs, tet_dofs, dim = cache[1]
    return tri_dofs.copy(), tet_dofs.copy(), dim


def _aggregate_quad(mesh: Mesh):
    n_pts = mesh.n_points
    mesh.collect_lines()
    t = mesh.tetrahedra
    tet_dofs = np.empty((len(t), 10), dtype=np.int64)
    tet_dofs[:, :4] = t
    for k, (i, j) in enumerate(TET_EDGES):
        tet_dofs[:, 4 + k] = mesh.edge_indices(t[:, [i, j]]) + n_pts
    tri = mesh.triangles
    tri_dofs = np.empty((len(tri), 6), dtype=np.int64)
    tri_dofs[:, :3] = tri
    for k, (i, j) in enumerate(TRI_EDGES):
        tri_dofs[:, 3 + k] = mesh.edge_indices(tri[:, [i, j]]) + n_pts
    return tri_dofs, tet_dofs, n_pts + len(mesh.lines)


def scatter_matrix_coo(dofs: np.ndarray, E: np.ndarray):
    """Raw COO triplets of [ne,k,k] element matrices."""
    ne, k = dofs.shape
    rows = np.repeat(dofs, k, axis=1).ravel()
    cols = np.tile(dofs, (1, k)).ravel()
    return rows, cols, E.reshape(-1).astype(CDTYPE)


def scatter_vector(dofs: np.ndarray, E: np.ndarray, dim: int) -> np.ndarray:
    """Assemble [ne,k] element vectors into a dense length-dim vector."""
    out = np.zeros(dim, dtype=CDTYPE)
    np.add.at(out, dofs.ravel(), E.ravel().astype(CDTYPE))
    return out


def rank_one_coo(I, S, J, G):
    """COO of the rank-one product (outer, Helmholtz.jl:19-33): entries
    S_i·G_j at (I_i, J_j) for every pair."""
    I = np.asarray(I)
    J = np.asarray(J)
    S = np.asarray(S, dtype=CDTYPE)
    G = np.asarray(G, dtype=CDTYPE)
    rows = np.repeat(I, len(J))
    cols = np.tile(J, len(I))
    vals = (S[:, None] * G[None, :]).ravel()
    return rows, cols, vals


__all__ = ["aggregate_elements", "scatter_matrix_coo", "scatter_vector",
           "rank_one_coo", "TET_EDGES", "TRI_EDGES"]
