"""The thermoacoustic Helmholtz family, assembled in plain SciPy.

    L(ω) = K + ω² M + ω Y C + n e^{-iωτ} Q

with K = -∫c²∇φ_i·∇φ_j, M = ∫φ_iφ_j, C = -i∫_outlet c φ_iφ_j and the n–τ
flame Q = s gᵀ: s_i = ∫_flame φ_i, g_j = -(γ-1)/ρ · Q̄/(U V_flame) ·
∇φ_j·n_ref in the tetrahedron holding the reference point.  No code of
the program is used.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import fem


class RefFamily:
    """Terms (matrix, coefficient(ω, params), dcoefficient/dω)."""

    def __init__(self, n: int, terms, params: dict):
        self.n = n
        self.terms = terms
        self.params = dict(params)

    def matrix(self, omega, params=None, deriv=0) -> sp.csr_matrix:
        """L(ω) (deriv 0) or dL/dω (deriv 1) at ``params`` (overriding the
        family's), complex128 CSR."""
        p = {**self.params, **(params or {})}
        A = None
        for M, coef, dcoef in self.terms:
            c = (coef if deriv == 0 else dcoef)(complex(omega), p)
            A = c * M if A is None else A + c * M
        return A.tocsr().astype(np.complex128)

    def weight(self, params=None) -> sp.csr_matrix:
        """The mass matrix M (``params`` are not used)."""
        return self.terms[1][0].astype(np.complex128).tocsr()


def helmholtz_family(mesh: dict, c_tet: np.ndarray, Y: float,
                     flame: dict | None = None) -> RefFamily:
    """The family on ``mesh`` (arrays of :mod:`.meshes`): interior wave
    operator, the Outlet admittance Y and, if given, an n–τ flame
    ``{"gamma", "rho", "q_over_u", "x_ref", "n_ref", "n", "tau"}`` over
    the Flame domain."""
    pts, tets = mesh["points"], mesh["tetrahedra"]
    n = pts.shape[1]
    K = -fem.stiffness(pts, tets, np.asarray(c_tet) ** 2, n)
    M = fem.mass(pts, tets, n)
    sel = mesh["domains"]["Outlet"]["simplices"]
    # speed of sound on a boundary face: its tetrahedron's
    owner = mesh["triangle_owner"][sel]
    C = -1j * fem.boundary_mass(pts, mesh["triangles"][sel],
                                np.asarray(c_tet)[owner], n)
    terms = [(K, lambda w, p: 1.0, lambda w, p: 0.0),
             (M, lambda w, p: w * w, lambda w, p: 2 * w),
             (C, lambda w, p: w * p["Y"], lambda w, p: p["Y"])]
    params = {"Y": Y}
    if flame is not None:
        ft = tets[mesh["domains"]["Flame"]["simplices"]]
        vol, _ = fem.tet_geometry(pts, ft)
        nlocal = ((flame["gamma"] - 1) / flame["rho"] * flame["q_over_u"]
                  / vol.sum())
        s = fem.source(pts, ft, n)
        ref = tets[fem.containing_tet(pts, tets, flame["x_ref"])]
        _, g = fem.tet_geometry(pts, ref[None])
        gv = np.zeros(n)
        np.add.at(gv, ref, -nlocal * (g[0] @ np.asarray(flame["n_ref"])))
        Q = sp.csr_matrix(s[:, None]) @ sp.csr_matrix(gv[None, :])
        terms.append((Q, lambda w, p: p["n"] * np.exp(-1j * w * p["tau"]),
                      lambda w, p: p["n"] * (-1j * p["tau"])
                      * np.exp(-1j * w * p["tau"])))
        params.update(n=flame["n"], tau=flame["tau"])
    return RefFamily(n, terms, params)


__all__ = ["RefFamily", "helmholtz_family"]
