"""Global DOF aggregation and gather–kernel–scatter assembly (host numpy,
copied from the JAX package's ``fem/assembly.py``: P1, P2 and cubic
Hermite).

Replaces the reference's per-element COO append loops
(Helmholtz.jl:405-525) with: one vectorized DOF-numbering pass
(aggregate_elements, FEM.jl:84-166), batched element-kernel evaluation
([ne,k,k] tensors from :mod:`.elements`), and a single duplicate-summing
scatter into CSR."""
from __future__ import annotations

import numpy as np

from ..mesh.core import Mesh
from ..ops.sparse import CSR
from ..utils.config import CDTYPE

TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
TRI_EDGES = [(0, 1), (0, 2), (1, 2)]


def aggregate_elements(mesh: Mesh, order: str = "lin"):
    """Global DOF index lists per element and total DOF count
    (aggregate_elements, FEM.jl:84-166).

    order 'lin': P1 (DOF = points); 'quad': P2 (points + edge midpoints);
    'herm': cubic Hermite (4 point banks + face bubbles).
    Returns (tri_dofs [nt, k2], tet_dofs [ne, k3], dim).

    P2/Hermite numberings are cached on the mesh (keyed by a connectivity
    fingerprint — DOF numbering depends only on connectivity, so point
    motion, e.g. during shape sensitivities, keeps the cache valid)."""
    n_pts = mesh.n_points
    if order == "lin":
        return mesh.triangles.copy(), mesh.tetrahedra.copy(), n_pts
    fp = (order, n_pts, len(mesh.lines), len(mesh.triangles),
          len(mesh.int_triangles), len(mesh.tetrahedra))
    cache = getattr(mesh, "_dof_cache", None)
    if cache is None or cache[0] != fp:
        out = _aggregate_uncached(mesh, order)
        # fingerprint AFTER building (collect_lines / int_triangles fill in)
        fp = (order, n_pts, len(mesh.lines), len(mesh.triangles),
              len(mesh.int_triangles), len(mesh.tetrahedra))
        mesh._dof_cache = cache = (fp, out)
    tri_dofs, tet_dofs, dim = cache[1]
    return tri_dofs.copy(), tet_dofs.copy(), dim


def _aggregate_uncached(mesh: Mesh, order: str):
    n_pts = mesh.n_points
    if order == "quad":
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
    if order == "herm":
        return _aggregate_hermite(mesh)
    raise ValueError(f"element order {order!r} not supported "
                     "(available: 'lin', 'quad', 'herm')")


TET_FACES = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]


def _aggregate_hermite(mesh: Mesh):
    """Hermite DOF numbering (FEM.jl:117-166): per vertex one value DOF and
    three global-gradient DOFs in banks of n_pts, then one bubble DOF per
    face (surface triangles first, then interior faces);
    dim = 4·n_pts + n_faces."""
    from ..mesh.core import find_simplices

    n_pts = mesh.n_points
    t = mesh.tetrahedra
    faces = np.concatenate([t[:, list(f)] for f in TET_FACES])
    surf_idx = find_simplices(mesh.triangles, faces)
    if mesh.int_triangles is None or len(mesh.int_triangles) == 0:
        from ..mesh.core import unique_simplices
        missing = faces[surf_idx < 0]
        mesh.int_triangles, _ = unique_simplices(missing)
    int_idx = find_simplices(mesh.int_triangles, faces)
    n_surf = len(mesh.triangles)
    face_dof = np.where(surf_idx >= 0, surf_idx,
                        n_surf + int_idx) + 4 * n_pts
    if np.any((surf_idx < 0) & (int_idx < 0)):
        raise ValueError("tetrahedron face not found in surface or "
                         "interior triangle store")
    ne = len(t)
    tet_dofs = np.empty((ne, 20), dtype=np.int64)
    for d in range(4):
        tet_dofs[:, 4 * d:4 * (d + 1)] = t + d * n_pts
    tet_dofs[:, 16:20] = face_dof.reshape(4, ne).T

    tri = mesh.triangles
    tri_dofs = np.empty((len(tri), 13), dtype=np.int64)
    for d in range(4):
        tri_dofs[:, 3 * d:3 * (d + 1)] = tri + d * n_pts
    tri_dofs[:, 12] = np.arange(len(tri)) + 4 * n_pts
    dim = 4 * n_pts + n_surf + len(mesh.int_triangles)
    return tri_dofs, tet_dofs, dim


def scatter_matrix(dofs: np.ndarray, E: np.ndarray, dim: int) -> CSR:
    """Assemble [ne,k,k] element matrices into a dim×dim CSR (duplicate
    entries summed)."""
    ne, k = dofs.shape
    rows = np.repeat(dofs, k, axis=1).ravel()
    cols = np.tile(dofs, (1, k)).ravel()
    return CSR.from_coo(rows, cols, E.reshape(-1).astype(CDTYPE), (dim, dim))


def scatter_matrix_coo(dofs: np.ndarray, E: np.ndarray):
    """Raw COO triplets (for Bloch splitting before sparsification)."""
    ne, k = dofs.shape
    rows = np.repeat(dofs, k, axis=1).ravel()
    cols = np.tile(dofs, (1, k)).ravel()
    return rows, cols, E.reshape(-1).astype(CDTYPE)


def scatter_rect_coo(row_dofs: np.ndarray, col_dofs: np.ndarray,
                     E: np.ndarray):
    """COO triplets for rectangular element blocks E [ne, ki, kj] with
    independent row/col DOF lists (create_indices two-arg form, used by the
    mixed-space APE assembly, APE.jl:105-106)."""
    ne, ki = row_dofs.shape
    kj = col_dofs.shape[1]
    rows = np.repeat(row_dofs, kj, axis=1).ravel()
    cols = np.tile(col_dofs, (1, ki)).ravel()
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


__all__ = ["aggregate_elements", "scatter_matrix", "scatter_matrix_coo",
           "scatter_rect_coo", "scatter_vector", "rank_one_coo",
           "TET_EDGES", "TRI_EDGES"]
