"""Thermoacoustic Helmholtz discretization front-end (host numpy).

Copied from the JAX package's ``models/helmholtz.py`` for the descriptor
kinds of the flagship Rijke problem.  ``discretize(mesh, dscrp, C)``
assembles the parameterized operator family

    L(ω, …) = K + ω C + ω² M + n·exp(−iωτ)·Q  (+ aux weighting)

as the reference's Helmholtz.discretize (src/Helmholtz.jl:54-581).
dscrp maps a domain name to (kind, data) with the ported kinds

  :interior                   wave operator M + K on a volume
  :admittance  (sym, val)     boundary damping ωY·C
  :flame       (γ, ρ, Q02U0, [ref_idx,] x_ref, n_ref, :n, :τ, n, τ)  n-τ flame

on P1 (``order="lin"``) or P2 (``order="quad"``) Lagrange elements, and
with ``b=`` the Bloch-reduced family of an annular unit cell
(:mod:`..fem.bloch`).  The other kinds, Hermite elements and the forcing
vector are ROADMAP.md Queue 1 item 7 and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..fem import assembly as fea
from ..fem import elements as fel
from ..fem.bloch import BlochContext
from ..mesh.core import Mesh
from ..nlevp.algebra import exp_delay, pow1, pow2
from ..nlevp.family import AUX_OPERATOR, OperatorFamily, Term
from ..ops.sparse import CSR
from ..utils.config import CDTYPE


def _speed_of_sound(mesh: Mesh, C):
    """Per-element speed of sound: constant per tet (len == #tets) or
    P1-interpolated from vertices (len == #points)
    (Helmholtz.jl:59-74)."""
    C = np.asarray(C, dtype=np.float64)
    if len(C) == len(mesh.tetrahedra):
        if mesh.tri2tet is None:
            mesh.link_triangles_to_tetrahedra()
        return C, C[mesh.tri2tet]
    if len(C) == mesh.n_points:
        return C[mesh.tetrahedra], C[mesh.triangles]
    raise ValueError("speed-of-sound array must have one entry per "
                     "tetrahedron or per mesh point")


def discretize(mesh: Mesh, dscrp: Dict, C, order: str = "lin",
               b: Optional[str] = None, mass_weighting: bool = True,
               source: bool = False, output: bool = False):
    """Assemble the Helmholtz operator family (Helmholtz.jl:54-581);
    timed under the ``helmholtz.discretize`` phase (utils/timing.py)."""
    from ..utils.timing import phase
    if source:
        raise NotImplementedError(
            "the forcing vector is not ported yet (ROADMAP.md Queue 1 "
            "item 7: remaining front-ends)")
    with phase("helmholtz.discretize"):
        return _discretize_impl(mesh, dscrp, C, order, b, mass_weighting)


def _discretize_impl(mesh: Mesh, dscrp: Dict, C, order: str,
                     b: Optional[str], mass_weighting: bool):
    """Assembly body (Helmholtz.jl:54-581).  ``b`` activates
    Bloch-periodic assembly on a unit-cell mesh (requires mesh.dos; see
    :mod:`..fem.bloch`)."""
    porder = {"lin": 1, "quad": 2}.get(order)
    if porder is None:
        raise NotImplementedError(
            f"element order {order!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 7; the port assembles 'lin' and 'quad')")
    tri_dofs, tet_dofs, dim = fea.aggregate_elements(mesh, order)
    pts = mesh.points
    C_tet, C_tri = _speed_of_sound(mesh, C)

    L = OperatorFamily(["ω", "λ"], [0.0, complex("inf")])

    bloch = None
    if b is not None:
        bloch = BlochContext(mesh, order, b)
        dim = bloch.reduced_dim(dim)
        L.params[b] = 0.0

    def push_matrix(rows, cols, vals, funcs, args, txt, mat):
        if bloch is None:
            M = CSR.from_coo(rows, cols, vals, (dim, dim))
            L.push(Term(M, tuple(funcs), tuple(args), txt, mat))
            return
        for (r, c, v), f, a, t in bloch.blochify(rows, cols, vals):
            M = CSR.from_coo(r, c, v, (dim, dim))
            if M.nnz or not f:
                L.push(Term(M, tuple(funcs) + f, tuple(args) + a, txt + t,
                            mat))

    for domain, (kind, data) in dscrp.items():
        dd = mesh.domains[domain]
        sidx = np.asarray(dd["simplices"], dtype=np.int64)
        if kind == "interior":
            make = ["M", "K"]
        elif kind == "admittance" and len(data) == 2:
            make = ["C"]
            adm_sym, adm_val = data
            L.params.setdefault(adm_sym, complex(adm_val))
            boundary_funcs = (pow1, pow1)
            boundary_args = (("ω",), (adm_sym,))
            boundary_txt = f"ω*{adm_sym}"
        elif kind == "flame" and len(data) in (9, 10):
            make = ["Q"]
            ref_idx = None
            if len(data) == 9:
                gamma, rho, nglobal, x_ref, n_ref, n_sym, tau_sym, \
                    n_val, tau_val = data
            else:
                gamma, rho, nglobal, ref_idx, x_ref, n_ref, n_sym, \
                    tau_sym, n_val, tau_val = data
            L.params.setdefault(n_sym, complex(n_val))
            L.params.setdefault(tau_sym, complex(tau_val))
            flame_funcs = (pow1, exp_delay)
            flame_args = ((n_sym,), ("ω", tau_sym))
            flame_txt = f"{n_sym}*exp(-iω{tau_sym})"
            nlocal = (gamma - 1) / rho * nglobal / mesh.compute_size(domain)
            if ref_idx is None:
                ref_idx = mesh.find_tetrahedron_containing_point(x_ref)
            if ref_idx in set(sidx.tolist()):
                print("Warning: reference point inside the heat-release "
                      "domain (short-circuited FTF!)")
        else:
            raise NotImplementedError(
                f"descriptor {kind!r} with {len(data)} data items is not "
                "ported yet (ROADMAP.md Queue 1: remaining front-ends)")

        for opr in make:
            if opr == "M":
                E = fel.tet_mass(pts, mesh.tetrahedra[sidx], porder)
                rows, cols, vals = fea.scatter_matrix_coo(tet_dofs[sidx], E)
                push_matrix(rows, cols, vals, (pow2,), (("ω",),), "ω^2", "M")
            elif opr == "K":
                c = C_tet[sidx]
                c2 = c ** 2 if c.ndim == 1 else c
                E = -fel.tet_stiffness(pts, mesh.tetrahedra[sidx], porder, c2)
                rows, cols, vals = fea.scatter_matrix_coo(tet_dofs[sidx], E)
                push_matrix(rows, cols, vals, (), (), "", "K")
            elif opr == "C":
                c = C_tri[sidx]
                E = fel.tri_mass(pts, mesh.triangles[sidx], porder, c)
                E = -1j * E
                rows, cols, vals = fea.scatter_matrix_coo(tri_dofs[sidx], E)
                push_matrix(rows, cols, vals, boundary_funcs, boundary_args,
                            boundary_txt, "C")
            elif opr == "Q":
                S = fel.tet_source(pts, mesh.tetrahedra[sidx], porder)
                I = tet_dofs[sidx].ravel()
                Sv = S.ravel().astype(CDTYPE)
                ref_tet = mesh.tetrahedra[ref_idx]
                G = fel.tet_grad_at_point(pts, ref_tet, porder, n_ref, x_ref)
                G = -nlocal * G.astype(CDTYPE)
                Jd = tet_dofs[ref_idx]
                rows, cols, vals = fea.rank_one_coo(I, Sv, Jd, G)
                push_matrix(rows, cols, vals, flame_funcs, flame_args,
                            flame_txt, "Q")

    # mass weighting / aux term (Helmholtz.jl:528-574); forced on for Bloch
    if mass_weighting or bloch is not None:
        E = fel.tet_mass(pts, mesh.tetrahedra, porder)
        rows, cols, vals = fea.scatter_matrix_coo(tet_dofs, E)
        if bloch is not None:
            rows, cols, vals = (np.concatenate(x) for x in zip(
                *bloch.blochify_weight(rows, cols, vals)))
        M = CSR.from_coo(rows, cols, -vals, (dim, dim))
        if bloch is not None:
            D = bloch.axis_penalty(M, dim)
            if D is not None:
                L.push(D)
        L.push(Term(M, (pow1,), (("λ",),), "-λ", AUX_OPERATOR))
    return L


__all__ = ["discretize"]
