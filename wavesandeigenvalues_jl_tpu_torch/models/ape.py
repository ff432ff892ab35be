"""Linearized acoustic perturbation equations (APE) about a mean flow.

Host numpy, copied from the JAX package's ``models/ape.py``.  Counterpart
of the reference's APE module (src/APE.jl:10-321): a mixed P2-velocity /
P1-pressure discretization of the APE system with eigenvalue symbol ``s``,

    s·M x + Y·B x + K x + v·U x = 0,

where x = [p, u_x, u_y, u_z] stacks the P1 pressure DOFs (block 0) and
the three P2 velocity components.  Terms:

  M  (·s)   ρ-weighted velocity mass + pressure mass           (term I+III)
  B  (·Y)   boundary admittance on the pressure trace          (APE.jl:70-95)
  K  (·1)   pressure-gradient / velocity-divergence coupling   (terms II+IV)
  U  (·v)   mean-flow convection + mean-flow-gradient terms    (terms V+VI)
  __aux__   −λ·(grid mass) residual weighting                  (APE.jl:166-192)

All element evaluations are batched over the whole tetrahedron set
(gather → einsum kernels → duplicate-summing scatter), not per-element
loops.

``compute_potflow_field`` solves the potential-flow Poisson problem with
volume-flow boundary conditions (APE.jl:215-321): order "const" uses P1
elements and returns per-tetrahedron velocities; order "lin" uses cubic
Hermite elements whose gradient DOFs give nodal velocities directly.  Its
Poisson solve is the JAX package's default one: SuperLU on the host.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..fem import assembly as fea
from ..fem import elements as fel
from ..mesh.core import Mesh
from ..nlevp.algebra import pow1
from ..nlevp.family import AUX_OPERATOR, OperatorFamily, Term
from ..ops.sparse import CSR
from ..utils.config import CDTYPE

#: default ambient gas properties (air at one atmosphere, APE.jl:16-18)
AMBIENT_P = 101325.0
AMBIENT_RHO = 1.225
AMBIENT_GAMMA = 1.4


def _admittance_symbol(domain: str) -> str:
    """Parameter symbol for a boundary domain (APE.jl:71-75 hardwires
    Inlet→Y_in / Outlet→Y_out; other names get Y_<domain>)."""
    if domain == "Inlet":
        return "Y_in"
    if domain == "Outlet":
        return "Y_out"
    return f"Y_{domain}"


def discretize(mesh: Mesh, dscrp: Dict, U: Optional[np.ndarray] = None,
               P: float = AMBIENT_P, rho: float = AMBIENT_RHO,
               gamma: float = AMBIENT_GAMMA, output: bool = False):
    """Assemble the APE operator family (APE.discretize, APE.jl:10-194).

    ``dscrp`` maps boundary domain names to volume-flow values (the
    admittance normalization uses the domain surface size).  ``U`` is the
    3×N_points mean-flow field (e.g. from :func:`compute_potflow_field`);
    ``U=None`` assembles the quiescent (no-mean-flow) system without the
    convection term.

    DOF layout (APE.jl:14,48-57): pressure P1 on [0, N_pts); velocity
    component d on [N_pts + d·B, N_pts + (d+1)·B) with B = N_pts + N_lines
    P2 DOFs per component; dim = N_pts + 3·B."""
    from ..utils.timing import phase
    if output:
        print("Discretize APE...")
    with phase("ape.discretize"):
        return _discretize_impl(mesh, dscrp, U, P, rho, gamma, output)


def _discretize_impl(mesh, dscrp, U, P, rho, gamma, output):
    mesh.collect_lines()
    _, tet_q, blk = fea.aggregate_elements(mesh, "quad")
    n_pts = mesh.n_points
    dim = n_pts + 3 * blk
    pts = mesh.points
    tets = mesh.tetrahedra

    L = OperatorFamily(["s", "λ"], [0.0, complex("inf")])

    def voff(d: int) -> int:
        return n_pts + d * blk

    # ---- term I + III: mass (·s) and the identical __aux__ grid mass -----
    Mv = rho * fel.tet_mass(pts, tets, 2)
    Mp = fel.tet_mass(pts, tets, 1)
    rows, cols, vals = [], [], []
    for d in range(3):
        r, c, v = fea.scatter_matrix_coo(tet_q + voff(d), Mv)
        rows.append(r), cols.append(c), vals.append(v)
    r, c, v = fea.scatter_matrix_coo(tets, Mp)
    rows.append(r), cols.append(c), vals.append(v)
    rows, cols, vals = (np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals))
    M = CSR.from_coo(rows, cols, vals, (dim, dim))
    L.push(Term(M, (pow1,), (("s",),), "s", "M"))

    # ---- boundary admittance on the pressure trace (APE.jl:70-95) ---------
    cbar = np.sqrt(gamma * P / rho)
    for dom, val in dscrp.items():
        ysym = _admittance_symbol(dom)
        L.params[ysym] = -cbar / (val / mesh.compute_size(dom))
        sidx = np.asarray(mesh.domains[dom]["simplices"], dtype=np.int64)
        E = cbar * fel.tri_mass(pts, mesh.triangles[sidx], 1)
        r, c, v = fea.scatter_matrix_coo(mesh.triangles[sidx], E)
        B = CSR.from_coo(r, c, v, (dim, dim))
        L.push(Term(B, (pow1,), ((ysym,),), ysym, "B"))

    # ---- terms II + IV: grad-p / div-u coupling (APE.jl:99-126) ------------
    rows, cols, vals = [], [], []
    for d in range(3):
        # term II: u-equation row, pressure column: ∫ φi^{P2} ∂φj^{P1}/∂x_d
        E = fel.tet_deriv(pts, tets, 2, 1, d)
        r, c, v = fea.scatter_rect_coo(tet_q + voff(d), tets, E)
        rows.append(r), cols.append(c), vals.append(v)
        # term IV: p-equation row, u column: −γP ∫ ∂φi^{P1}/∂x_d φj^{P2}
        E4 = -gamma * P * np.swapaxes(E, 1, 2)
        r, c, v = fea.scatter_rect_coo(tets, tet_q + voff(d), E4)
        rows.append(r), cols.append(c), vals.append(v)
    rows, cols, vals = (np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals))
    K = CSR.from_coo(rows, cols, vals, (dim, dim))
    L.push(Term(K, (), (), "", "K"))

    # ---- terms V + VI: mean flow (APE.jl:131-162) --------------------------
    if U is not None:
        U = np.asarray(U, dtype=np.float64)
        if U.shape != (3, n_pts):
            raise ValueError("mean-flow field U must be 3×N_points "
                             "(per-vertex); compute_potflow_field(..., "
                             "order='lin') provides this")
        Mv2 = fel.tet_mass(pts, tets, 2)
        rows, cols, vals = [], [], []
        for d in range(3):
            for e in range(3):
                u = U[e][tets]  # [ne, 4] P1 field of component e
                dudx = fel.tet_field_deriv(pts, tets, u, d)  # ∂U_e/∂x_d
                E = rho * (dudx[:, None, None] * Mv2
                           + fel.tet_deriv(pts, tets, 2, 2, d, c=u))
                r, c, v = fea.scatter_rect_coo(tet_q + voff(d),
                                               tet_q + voff(e), E)
                rows.append(r), cols.append(c), vals.append(v)
            # term VI: pressure convection ∫ φi^{P1} U_d ∂φj^{P1}/∂x_d
            u = U[d][tets]
            E = fel.tet_deriv(pts, tets, 1, 1, d, c=u)
            r, c, v = fea.scatter_rect_coo(tets, tets, E)
            rows.append(r), cols.append(c), vals.append(v)
        rows, cols, vals = (np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals))
        L.params["v"] = 1.0
        Um = CSR.from_coo(rows, cols, vals, (dim, dim))
        L.push(Term(Um, (pow1,), (("v",),), "v", "U"))

    # ---- aux residual weighting (APE.jl:166-192) ---------------------------
    L.push(Term(M.scaled(-1.0), (pow1,), (("λ",),), "-λ", AUX_OPERATOR))
    return L


def compute_potflow_field(mesh: Mesh, dscrp: Dict, order: str = "lin",
                          output: bool = False) -> np.ndarray:
    """Potential mean flow from volume-flow boundary conditions
    (compute_potflow_field, APE.jl:215-321).

    Solves the pure-Neumann Poisson problem ∫∇φ·∇ψ = −Σ_dom (q/|Γ|)∫ψ and
    differentiates the potential.  ``dscrp`` maps domain names to volume
    flows (positive = inflow); they must sum to ≈ 0.

    order "const": P1 potential → per-tet constant velocities [3, n_tets].
    order "lin":   cubic-Hermite potential (gradient DOFs are nodal
                   velocities) → per-vertex velocities [3, n_points].
    The pinned system is factored on the host (``factorize(A,
    backend="host")``, scipy), whatever the session's solve backend.
    """
    if order not in ("const", "lin"):
        raise ValueError(f"order {order!r} not supported for potential flow "
                         "(available: 'const', 'lin')")
    if output:
        print(f"Computing potential flow (order={order})...")
    total = sum(dscrp.values())
    scale = max(abs(v) for v in dscrp.values()) if dscrp else 1.0
    if abs(total) > 1e-9 * scale:
        print(f"Warning: volume fluxes do not balance (Σq = {total:g}); "
              "the pure-Neumann problem is inconsistent and the solution "
              "is a least-squares compromise.")
    pts = mesh.points
    tets = mesh.tetrahedra
    felement = "lin" if order == "const" else "herm"
    tri_dofs, tet_dofs, dim = fea.aggregate_elements(mesh, felement)
    porder = 1 if order == "const" else "herm"

    E = fel.tet_stiffness(pts, tets, porder) if order == "const" \
        else fel.tet_stiffness_herm(pts, tets)
    rows, cols, vals = fea.scatter_matrix_coo(tet_dofs, E)

    rhs = np.zeros(dim, dtype=np.float64)
    for dom, val in dscrp.items():
        a = val / mesh.compute_size(dom)
        sidx = np.asarray(mesh.domains[dom]["simplices"], dtype=np.int64)
        if order == "const":
            S = fel.tri_source(pts, mesh.triangles[sidx], 1)
        else:
            S = fel.tri_source_herm(pts, mesh.triangles[sidx])
        np.add.at(rhs, tri_dofs[sidx].ravel(), -a * S.ravel())

    # Pure-Neumann problem: pin DOF 0 (potential defined up to a constant;
    # the velocity = gradient is unaffected).  The reference relies on
    # UMFPACK tolerating the near-singular solve (APE.jl:299).
    keep = (rows != 0) & (cols != 0)
    rows = np.concatenate([rows[keep], [0]])
    cols = np.concatenate([cols[keep], [0]])
    vals = np.concatenate([vals[keep], [1.0 + 0.0j]])
    rhs[0] = 0.0
    A = CSR.from_coo(rows, cols, vals, (dim, dim))

    from ..ops.linsolve import factorize
    phi = factorize(A, backend="host").solve(rhs.astype(CDTYPE)).real

    if order == "const":
        # U_e = Σ_k φ_k ∇λ_k (constant per tet), APE.jl:301-310
        _, Jinv, _ = fel.tet_trafo(pts, tets)
        _, dN1 = fel.tet_basis(1, np.zeros((1, 3)))
        return np.einsum("ek,km,emd->de", phi[tets], dN1[0], Jinv)
    # Hermite: gradient DOFs are the nodal velocities (APE.jl:311-318)
    n_pts = mesh.n_points
    return np.stack([phi[n_pts:2 * n_pts], phi[2 * n_pts:3 * n_pts],
                     phi[3 * n_pts:4 * n_pts]])


__all__ = ["discretize", "compute_potflow_field",
           "AMBIENT_P", "AMBIENT_RHO", "AMBIENT_GAMMA"]
