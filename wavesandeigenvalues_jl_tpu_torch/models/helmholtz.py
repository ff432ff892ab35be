"""Thermoacoustic Helmholtz discretization front-end (host numpy).

Copied from the JAX package's ``models/helmholtz.py``, every descriptor
kind.  ``discretize(mesh, dscrp, C)`` assembles the parameterized operator
family

    L(ω, …) = K + ω C + ω² M + n·exp(−iωτ)·Q  (+ aux weighting)

from a model-description dict as the reference's Helmholtz.discretize
(src/Helmholtz.jl:54-581).  dscrp maps a domain name to (kind, data) with
kinds
  :interior                      wave operator M + K on a volume
  :mass / :stiff                 individual operators (custom coeff funcs)
  :admittance  (sym, val) | (Y(ω,k),) | (A,B,C,D)   boundary damping ωY·C
  :speaker     (sym, val, [admittance…])            boundary forcing vector
  :flame       (γ, ρ, Q02U0, [ref_idx,] x_ref, n_ref, :n, :τ, n, τ)  n-τ flame
               (γ, ρ, Q02U0, x_ref, n_ref, FTF)    custom FTF(ω,k)
               (γ, ρ, Q02U0, x_ref, n_ref)         plain :FTF parameter
  :flameresponse (γ, ρ, Q02U0, x_ref, n_ref, :ε, ε)
  :fancyflame  (γ, ρ, Q02U0, x_ref, n_ref, :n, :τ, :a, n, τ, a)  (also lists)
A domain of any other kind is ignored, as in the JAX package.  Elements:
P1 (``order="lin"``), P2 (``"quad"``) or cubic Hermite (``"herm"``); with
``b=`` the Bloch-reduced family of an annular unit cell
(:mod:`..fem.bloch`).

The assembly path is gather → batched element kernels → duplicate-summing
scatter (see :mod:`..fem.assembly`), not a per-element loop.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..fem import assembly as fea
from ..fem import elements as fel
from ..fem.bloch import BlochContext
from ..mesh.core import Mesh
from ..nlevp.algebra import (ScalarFunc, SumNExpAZ2MZIT, Wrapped,
                             exp_az2mzit, exp_delay, generate_stsp_z,
                             generate_z_g_z, pow1, pow2)
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
    with phase("helmholtz.discretize"):
        return _discretize_impl(mesh, dscrp, C, order, b, mass_weighting,
                                source, output)


def _discretize_impl(mesh: Mesh, dscrp: Dict, C, order: str,
                     b: Optional[str], mass_weighting: bool,
                     source: bool, output: bool):
    """Assembly body (Helmholtz.jl:54-581).

    Returns the family L; with ``source=True`` also the parameterized
    forcing vector family.  ``b`` activates Bloch-periodic assembly on a
    unit-cell mesh (requires mesh.dos; see :mod:`..fem.bloch`)."""
    porder = {"lin": 1, "quad": 2, "herm": "herm"}.get(order)
    if porder is None:
        raise ValueError("order must be 'lin', 'quad' or 'herm'")
    tri_dofs, tet_dofs, dim = fea.aggregate_elements(mesh, order)
    pts = mesh.points
    C_tet, C_tri = _speed_of_sound(mesh, C)

    L = OperatorFamily(["ω", "λ"], [0.0, complex("inf")])
    rhs = OperatorFamily(["ω"], [0.0])
    rhs.auxval = ""

    bloch = None
    if b is not None:
        bloch = BlochContext(mesh, order, b)
        dim = bloch.reduced_dim(dim)
        L.params[b] = 0.0

    def push_matrix(rows, cols, vals, funcs, args, txt, mat):
        if bloch is not None:
            for (r, c, v), f, a, t in bloch.blochify(rows, cols, vals):
                M = CSR.from_coo(r, c, v, (dim, dim))
                if M.nnz or not f:
                    L.push(Term(M, tuple(funcs) + f, tuple(args) + a,
                                txt + t, mat))
        else:
            M = CSR.from_coo(rows, cols, vals, (dim, dim))
            L.push(Term(M, tuple(funcs), tuple(args), txt, mat))

    for domain, (kind, data) in dscrp.items():
        dd = mesh.domains[domain]
        sidx = np.asarray(dd["simplices"], dtype=np.int64)
        make = []
        stiff_funcs, stiff_args, stiff_txt = (), (), ""
        boundary_funcs = boundary_args = None
        boundary_txt = ""
        flame_funcs = flame_args = None
        flame_txt = ""
        speak_sym = None

        if kind == "interior":
            make = ["M", "K"]
        elif kind == "mass":
            make = ["M"]
        elif kind == "stiff":
            make = ["K"]
            stiff_funcs, stiff_args, stiff_txt = data
            for args_ in stiff_args:
                for a_ in args_:
                    L.params.setdefault(a_, 0.0)
        elif kind in ("admittance", "speaker"):
            make = []
            if kind == "speaker":
                make.append("m")
                speak_sym, speak_val = data[0], data[1]
                rhs.params[speak_sym] = complex(speak_val)
                data = data[2:]
            if len(data) > 0:
                make.append("C")
                if len(data) == 2:
                    adm_sym, adm_val = data
                    L.params.setdefault(adm_sym, complex(adm_val))
                    if kind == "speaker":
                        rhs.params.setdefault(adm_sym, complex(adm_val))
                    boundary_funcs = (pow1, pow1)
                    boundary_args = (("ω",), (adm_sym,))
                    boundary_txt = f"ω*{adm_sym}"
                elif len(data) == 1:
                    boundary_funcs = (generate_z_g_z(data[0]),)
                    boundary_args = (("ω",),)
                    boundary_txt = "ω*Y(ω)"
                elif len(data) == 4:
                    Ass, Bss, Css, Dss = data
                    boundary_funcs = (generate_z_g_z(
                        generate_stsp_z(Ass, Bss, Css, Dss)),)
                    boundary_args = (("ω",),)
                    boundary_txt = "ω*C_s(iωI-A)^-1B"
        elif kind in ("flame", "flameresponse", "fancyflame"):
            make = ["Q"]
            ref_idx = None
            if kind == "flame":
                if len(data) == 9:
                    gamma, rho, nglobal, x_ref, n_ref, n_sym, tau_sym, \
                        n_val, tau_val = data
                    isntau = True
                elif len(data) == 10:
                    gamma, rho, nglobal, ref_idx, x_ref, n_ref, n_sym, \
                        tau_sym, n_val, tau_val = data
                    isntau = True
                elif len(data) == 6:
                    gamma, rho, nglobal, x_ref, n_ref, FTF = data
                    isntau = False
                    f = FTF if isinstance(FTF, ScalarFunc) else Wrapped(FTF)
                    flame_funcs = (f,)
                    flame_args = (("ω",),)
                    flame_txt = f.symbol(("ω",))
                elif len(data) == 5:
                    gamma, rho, nglobal, x_ref, n_ref = data
                    isntau = False
                    L.params.setdefault("FTF", 0.0)
                    flame_funcs = (pow1,)
                    flame_args = (("FTF",),)
                    flame_txt = "FTF"
                else:
                    raise ValueError("flame data length mismatch")
                if isntau:
                    L.params.setdefault(n_sym, complex(n_val))
                    L.params.setdefault(tau_sym, complex(tau_val))
                    flame_funcs = (pow1, exp_delay)
                    flame_args = ((n_sym,), ("ω", tau_sym))
                    flame_txt = f"{n_sym}*exp(-iω{tau_sym})"
            elif kind == "flameresponse":
                gamma, rho, nglobal, x_ref, n_ref, eps_sym, eps_val = data
                L.params.setdefault(eps_sym, complex(eps_val))
                flame_funcs = (pow1,)
                flame_args = ((eps_sym,),)
                flame_txt = f"{eps_sym}"
            else:  # fancyflame (Helmholtz.jl:363-399)
                gamma, rho, nglobal, x_ref, n_ref, n_sym, tau_sym, a_sym, \
                    n_val, tau_val, a_val = data
                if np.isscalar(n_val) or isinstance(n_val, complex):
                    L.params.setdefault(n_sym, complex(n_val))
                    L.params.setdefault(tau_sym, complex(tau_val))
                    L.params.setdefault(a_sym, complex(a_val))
                    flame_funcs = (pow1, exp_az2mzit)
                    flame_args = ((n_sym,), ("ω", tau_sym, a_sym))
                    flame_txt = f"{n_sym}*exp({a_sym}ω²-iω{tau_sym})"
                else:
                    arg = ["ω"]
                    txts = []
                    for ns, ts, as_, nv, tv, av in zip(
                            n_sym, tau_sym, a_sym, n_val, tau_val, a_val):
                        L.params[ns] = complex(nv)
                        L.params[ts] = complex(tv)
                        L.params[as_] = complex(av)
                        arg += [ns, ts, as_]
                        txts.append(f"{ns}*exp({as_}ω²-iω{ts})")
                    flame_funcs = (SumNExpAZ2MZIT(len(n_sym)),)
                    flame_args = (tuple(arg),)
                    flame_txt = "[" + "+".join(txts) + "]"
            nlocal = (gamma - 1) / rho * nglobal / mesh.compute_size(domain)
            if ref_idx is None:
                ref_idx = mesh.find_tetrahedron_containing_point(x_ref)
            if ref_idx in set(sidx.tolist()):
                print("Warning: reference point inside the heat-release "
                      "domain (short-circuited FTF!)")
        else:
            make = []

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
                push_matrix(rows, cols, vals, stiff_funcs, stiff_args,
                            stiff_txt, "K")
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
            elif opr == "m":
                c = C_tri[sidx]
                E = fel.tri_source(pts, mesh.triangles[sidx], porder, c)
                vec = fea.scatter_vector(tri_dofs[sidx], E, dim) / 1j
                V = CSR.from_dense(vec[:, None])
                funcs = tuple(boundary_funcs or ()) + (pow1,)
                args = tuple(boundary_args or ()) + ((speak_sym,),)
                rhs.push(Term(V, funcs, args, "speaker", "m"))

    # mass weighting / aux term (Helmholtz.jl:528-574)
    if mass_weighting or bloch is not None:
        E = fel.tet_mass(pts, mesh.tetrahedra, porder)
        rows, cols, vals = fea.scatter_matrix_coo(tet_dofs, E)
        if bloch is not None:
            (r0, c0, v0), (rp, cp, vp), (rm, cm, vm) = \
                bloch.blochify_weight(rows, cols, vals)
            rows = np.concatenate([r0, rp, rm])
            cols = np.concatenate([c0, cp, cm])
            vals = np.concatenate([v0, vp, vm])
        M = CSR.from_coo(rows, cols, -vals, (dim, dim))
        if bloch is not None:
            D = bloch.axis_penalty(M, dim)
            if D is not None:
                L.push(D)
        L.push(Term(M, (pow1,), (("λ",),), "-λ", AUX_OPERATOR))

    if source:
        return L, rhs
    return L


__all__ = ["discretize"]
