"""P1 finite elements on tetrahedra, in plain NumPy and SciPy.

The element matrices are the closed forms of linear Lagrange elements:

* mass  ∫ φ_i φ_j dV   = V/20 · (1 + δ_ij)
* stiffness ∫ c² ∇φ_i·∇φ_j dV = c² V ∇λ_i·∇λ_j   (c constant per tet)
* boundary mass ∫ c φ_i φ_j dA = c A/12 · (1 + δ_ij)
* source ∫ φ_i dV = V/4

assembled by summing duplicates into a SciPy CSR matrix.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def tet_geometry(points: np.ndarray, tets: np.ndarray):
    """(volumes [nt], barycentric gradients [nt, 4, 3])."""
    p = np.moveaxis(points[:, tets], 0, 2)            # [nt, 4, 3]
    J = (p[:, 1:] - p[:, :1])                          # [nt, 3, 3] rows e_k
    vol = np.abs(np.linalg.det(J)) / 6.0
    Jinv = np.linalg.inv(J)                            # columns: ∇λ_1..3
    g = np.moveaxis(Jinv, 1, 2)                        # [nt, 3, 3] rows ∇λ_k
    grads = np.concatenate([-g.sum(axis=1, keepdims=True), g], axis=1)
    return vol, grads


def tri_areas(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    p = np.moveaxis(points[:, tris], 0, 2)            # [nf, 3, 3]
    return 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0],
                                         p[:, 2] - p[:, 0]), axis=1)


def assemble(elems: np.ndarray, E: np.ndarray, n: int) -> sp.csr_matrix:
    """Sum element matrices E [ne, k, k] over the element DOFs [ne, k]."""
    k = elems.shape[1]
    rows = np.repeat(elems, k, axis=1).ravel()
    cols = np.tile(elems, (1, k)).ravel()
    return sp.coo_matrix((E.ravel(), (rows, cols)), shape=(n, n)).tocsr()


def mass(points, tets, n):
    vol, _ = tet_geometry(points, tets)
    E = vol[:, None, None] / 20.0 * (np.ones((4, 4)) + np.eye(4))
    return assemble(tets, E, n)


def stiffness(points, tets, c2, n):
    vol, g = tet_geometry(points, tets)
    E = (c2 * vol)[:, None, None] * np.einsum("eik,ejk->eij", g, g)
    return assemble(tets, E, n)


def boundary_mass(points, tris, c, n):
    area = tri_areas(points, tris)
    E = (c * area)[:, None, None] / 12.0 * (np.ones((3, 3)) + np.eye(3))
    return assemble(tris, E, n)


def source(points, tets, n) -> np.ndarray:
    vol, _ = tet_geometry(points, tets)
    out = np.zeros(n)
    np.add.at(out, tets.ravel(), np.repeat(vol / 4.0, 4))
    return out


def containing_tet(points, tets, x, tol=1e-10) -> int:
    """The first tetrahedron (in the given order) whose barycentric
    coordinates of x are all ≥ -tol."""
    x = np.asarray(x, float)
    p = np.moveaxis(points[:, tets], 0, 2)             # [nt, 4, 3]
    T = np.moveaxis(p[:, :3] - p[:, 3:], 1, 2)         # [nt, 3, 3]
    lam = np.linalg.solve(T, (x - p[:, 3])[:, :, None])[:, :, 0]
    lam = np.concatenate([lam, 1.0 - lam.sum(axis=1, keepdims=True)], 1)
    hits = np.nonzero(np.all(lam >= -tol, axis=1))[0]
    if len(hits) == 0:
        raise ValueError(f"point {x} lies in no tetrahedron")
    return int(hits[0])


__all__ = ["tet_geometry", "tri_areas", "assemble", "mass", "stiffness",
           "boundary_mass", "source", "containing_tet"]
