"""Eigenvalue shape sensitivities over surface vertices.

Host numpy, copied from the JAX package's ``models/shape.py``.
Counterpart of the reference's shape_sensitivity.jl
(src/shape_sensitivity.jl): the gradient of an eigenvalue
ω with respect to displacing each surface mesh point in each coordinate
direction.

Two methods, sharing the reduced re-assembly trick (only simplices
adjacent to the moved point are re-discretized):

- :func:`discrete_adjoint_shape_sensitivity` — central-FD derivative of
  the *operator*, contracted with the direct/adjoint eigenpair:
  sens = −v_adj'·(∂L/∂x)(ω0)·v  (shape_sensitivity.jl:16-137).
- :func:`forward_finite_differences_shape_sensitivity` — re-solves the
  perturbed eigenproblem per point (shape_sensitivity.jl:242-339) with
  ``householder`` on ``device`` (the session's solve backend).

On annular unit-cell (Bloch) meshes the displacement happens in the local
cylindrical basis with the Bloch-image point co-displaced
(shape_sensitivity.jl:75-107); axis points are skipped.

The point loop is embarrassingly parallel (surface points × 3
directions); the loop body touches only O(1) elements per point.
"""
from __future__ import annotations

import copy
from typing import Dict

import numpy as np

from ..mesh.core import Mesh
from ..nlevp.family import OperatorFamily, Term
from ..nlevp.solvers import householder
from ..ops import linsolve
from ..ops.sparse import CSR
from ..utils.config import CDTYPE
from .helmholtz import discretize


# ---------------------------------------------------------------------------
# surface topology helpers


def get_surface_point_masks(mesh: Mesh):
    """(surface_points, tri_mask, tet_mask): surface point indices plus,
    per point, the adjacent triangle / tetrahedron indices
    (get_surface_points, Meshutils.jl:884-968) — built with two sorted
    incidence passes instead of per-element binary searches."""
    surface_points = np.unique(mesh.triangles)

    def incidence(simplices):
        flat = simplices.ravel()
        elem = np.repeat(np.arange(len(simplices)), simplices.shape[1])
        pos = np.searchsorted(surface_points, flat)
        pos = np.clip(pos, 0, len(surface_points) - 1)
        on_surf = surface_points[pos] == flat
        pos, elem = pos[on_surf], elem[on_surf]
        order = np.argsort(pos, kind="stable")
        pos, elem = pos[order], elem[order]
        starts = np.searchsorted(pos, np.arange(len(surface_points) + 1))
        return [elem[starts[i]:starts[i + 1]]
                for i in range(len(surface_points))]

    return surface_points, incidence(mesh.triangles), incidence(mesh.tetrahedra)


def surface_normal_vectors(mesh: Mesh) -> np.ndarray:
    """Outward per-triangle normals, length = 2·area
    (get_normal_vectors, Meshutils.jl:1030-1069)."""
    if mesh.tri2tet is None:
        mesh.link_triangles_to_tetrahedra()
    p = mesh.points
    tris = mesh.triangles
    a = (p[:, tris[:, 0]] - p[:, tris[:, 2]]).T
    b = (p[:, tris[:, 1]] - p[:, tris[:, 2]]).T
    n = np.cross(a, b)  # [nt, 3]
    tet = mesh.tetrahedra[mesh.tri2tet]
    cen = p[:, tet].mean(axis=2).T
    mid = p[:, tris].mean(axis=2).T
    flip = np.einsum("ij,ij->i", n, mid - cen) < 0
    n[flip] *= -1
    return n.T  # [3, nt]


def get_cylindrics(pnt: np.ndarray) -> np.ndarray:
    """Local cylindrical basis (e_r, e_φ, e_z) at a point
    (get_cylindrics, shape_sensitivity.jl:380-390)."""
    X = np.zeros((3, 3))
    X[:, 2] = (0.0, 0.0, 1.0)
    X[:, 0] = (pnt[0], pnt[1], 0.0)
    X[:, 0] /= np.linalg.norm(X[:, 0])
    X[:, 1] = np.cross(X[:, 2], X[:, 0])
    return X


def blochify_surface_points(mesh: Mesh, surface_points, tri_mask, tet_mask):
    """Merge each Bloch point's masks with its image point's so moving the
    pair re-assembles both sides (blochify_surface_points!,
    shape_sensitivity.jl:366-377)."""
    dos = mesh.dos
    n_pts = mesh.n_points
    lookup = {p: i for i, p in enumerate(surface_points)}
    for i, pnt in enumerate(surface_points):
        b = pnt - dos.naxis
        if 0 <= b < dos.nxbloch:
            img = n_pts - dos.nxbloch + b
            j = lookup.get(img)
            if j is not None:
                tri_mask[i] = np.unique(np.concatenate([tri_mask[i],
                                                        tri_mask[j]]))
                tet_mask[i] = np.unique(np.concatenate([tet_mask[i],
                                                        tet_mask[j]]))


def _reduced_domains(mesh: Mesh, dscrp, tris, tets) -> Dict:
    """Restrict every domain referenced by dscrp to the given adjacent
    simplices (assemble_connected_domain, shape_sensitivity.jl:343-365)."""
    domains = {}
    for dom in dscrp:
        dd = mesh.domains[dom]
        dim = dd["dimension"]
        keep = tris if dim == 2 else tets if dim == 3 else np.zeros(0, np.int64)
        simplices = np.intersect1d(np.asarray(dd["simplices"], np.int64),
                                   keep)
        domains[dom] = {"dimension": dim, "simplices": simplices}
        if "size" in dd:  # flame volume normalization must use FULL domain
            domains[dom]["size"] = dd["size"]
    return domains


def _reduced_mesh(mesh: Mesh, domains: Dict) -> Mesh:
    m = Mesh(mesh.points.copy(), mesh.lines, mesh.triangles,
             mesh.int_triangles, mesh.tetrahedra, domains,
             name="mesh_h", file=mesh.file)
    m.tri2tet = mesh.tri2tet
    m.dos = mesh.dos
    return m


def _sync_params(D: OperatorFamily, L: OperatorFamily):
    for k, v in L.params.items():
        if k in D.params:
            D.params[k] = v


def _is_unit(mesh: Mesh) -> bool:
    return mesh.dos is not None and getattr(mesh.dos, "unit", False)


# ---------------------------------------------------------------------------
# discrete adjoint


def discrete_adjoint_shape_sensitivity(mesh: Mesh, dscrp, C, surface_points,
                                       tri_mask, tet_mask, L, sol,
                                       h: float = 1e-9, output: bool = False):
    """sens[3, n_points]: eigenvalue gradient −v_adj'·(∂L/∂x)(ω0)·v with
    the operator derivative by central FD over reduced re-assembly
    (discrete_adjoint_shape_sensitivity, shape_sensitivity.jl:16-137)."""
    w0 = sol.params[sol.eigval]
    v0 = np.asarray(sol.v, dtype=CDTYPE)
    v0 = v0 / np.sqrt(np.vdot(v0, v0))
    vadj = np.asarray(sol.v_adj, dtype=CDTYPE)
    dL = L(w0, 1)  # ∂L/∂ω at ω0
    vadj = vadj / np.conj(np.vdot(vadj, dL @ v0))

    unit = _is_unit(mesh)
    b = "b" if unit else None
    n_pts = mesh.n_points
    ensure_sizes(mesh, dscrp)

    sens = np.zeros((3, n_pts), dtype=CDTYPE)
    for idx, pnt_idx in enumerate(np.asarray(surface_points)):
        domains = _reduced_domains(mesh, dscrp, tri_mask[idx], tet_mask[idx])
        mesh_h = _reduced_mesh(mesh, domains)
        pnt = mesh.points[:, pnt_idx].copy()

        bloch_idx = None
        if unit:
            bi = pnt_idx - mesh.dos.naxis
            if pnt_idx < mesh.dos.naxis:
                continue  # axis points are fixed
            if 0 <= bi < mesh.dos.nxbloch:
                bloch_idx = n_pts - mesh.dos.nxbloch + bi
                bloch_pnt = mesh.points[:, bloch_idx].copy()
            X = get_cylindrics(pnt)

        for crdnt in range(3):
            def displace(sign):
                mesh_h.points[:, pnt_idx] = pnt
                if unit:
                    mesh_h.points[:, pnt_idx] += sign * h * X[:, crdnt]
                    if bloch_idx is not None:
                        Xb = get_cylindrics(bloch_pnt)
                        mesh_h.points[:, bloch_idx] = (
                            bloch_pnt + sign * h * Xb[:, crdnt])
                else:
                    mesh_h.points[crdnt, pnt_idx] += sign * h
                D = discretize(mesh_h, dscrp, C, mass_weighting=False, b=b)
                _sync_params(D, L)
                return D(w0)

            Dm = (displace(+1) - displace(-1)).scaled(1.0 / (2 * h))
            mesh_h.points[:, pnt_idx] = pnt
            if bloch_idx is not None:
                mesh_h.points[:, bloch_idx] = bloch_pnt
            sens[crdnt, pnt_idx] = -np.vdot(vadj, Dm @ v0)
        if output:
            print(f"DA sensitivity {idx + 1}/{len(surface_points)}")
    return sens


def ensure_sizes(mesh: Mesh, dscrp):
    """Cache full-domain sizes so reduced re-assembly keeps the flame's
    1/V_flame normalization exact."""
    for dom, (kind, _) in dscrp.items():
        if kind in ("flame", "flameresponse", "fancyflame"):
            mesh.compute_size(dom)


# ---------------------------------------------------------------------------
# forward finite differences


def forward_finite_differences_shape_sensitivity(mesh: Mesh, dscrp, C,
                                                 surface_points, tri_mask,
                                                 tet_mask, L, sol,
                                                 h: float = 1e-9,
                                                 output: bool = False, *,
                                                 device="cuda"):
    """Pure-FD sensitivities: perturb the operator family term-wise by
    (L(x+h)−L(x−h)) and re-solve the eigenproblem from ω0
    (forward_finite_differences_shape_sensitivity,
    shape_sensitivity.jl:242-339)."""
    w0 = sol.params[sol.eigval]
    unit = _is_unit(mesh)
    b = "b" if unit else None
    n_pts = mesh.n_points
    ensure_sizes(mesh, dscrp)
    n_iter = len(surface_points)
    if unit:
        n_iter -= mesh.dos.nxbloch  # trailing image points follow their pair

    sens = np.zeros((3, n_pts), dtype=CDTYPE)
    for idx in range(n_iter):
        pnt_idx = int(np.asarray(surface_points)[idx])
        domains = _reduced_domains(mesh, dscrp, tri_mask[idx], tet_mask[idx])
        pnt = mesh.points[:, pnt_idx].copy()
        if unit and pnt_idx < mesh.dos.naxis:
            continue
        for crdnt in range(3):
            mesh_r = _reduced_mesh(mesh, domains)
            mesh_l = _reduced_mesh(mesh, domains)
            if unit:
                X = get_cylindrics(pnt)
                mesh_r.points[:, pnt_idx] += h * X[:, crdnt]
                mesh_l.points[:, pnt_idx] -= h * X[:, crdnt]
                bi = pnt_idx - mesh.dos.naxis
                if 0 <= bi < mesh.dos.nxbloch:
                    bidx = n_pts - mesh.dos.nxbloch + bi
                    Xb = get_cylindrics(mesh.points[:, bidx])
                    mesh_r.points[:, bidx] += h * Xb[:, crdnt]
                    mesh_l.points[:, bidx] -= h * Xb[:, crdnt]
            else:
                mesh_r.points[crdnt, pnt_idx] += h
                mesh_l.points[crdnt, pnt_idx] -= h
            D_r = discretize(mesh_r, dscrp, C, mass_weighting=True, b=b)
            D_l = discretize(mesh_l, dscrp, C, mass_weighting=True, b=b)
            G = OperatorFamily(["ω", "λ"], [0.0, complex("inf")])
            G.params = copy.deepcopy(L.params)
            if len(D_r.terms) != len(L.terms):
                raise RuntimeError("term mismatch in FD shape sensitivity")
            for t, tr, tl in zip(L.terms, D_r.terms, D_l.terms):
                if t.operator == "__aux__" or t.symbol == "__aux__":
                    coeff = t.coeff
                else:
                    coeff = t.coeff + (tr.coeff - tl.coeff)
                G.terms.append(Term(coeff, t.funcs, t.params, t.symbol,
                                    t.operator))
            new_sol, _, flag = householder(G, w0, maxiter=5, output=False,
                                           nev=3, order=3, device=device)
            sens[crdnt, pnt_idx] = (new_sol.params[new_sol.eigval] - w0) / (2 * h)
        if output:
            print(f"FD sensitivity {idx + 1}/{n_iter}")
    return sens


# ---------------------------------------------------------------------------
# postprocessing


def normalize_sensitivity(surface_points, normal_vectors, tri_mask, sens):
    """Distribute point sensitivities onto adjacent triangles weighted by
    directed volume flow, per unit area (normalize_sensitivity,
    shape_sensitivity.jl:145-179).  Returns [3, n_triangles]."""
    nt = normal_vectors.shape[1]
    A = np.linalg.norm(normal_vectors, axis=0) / 2
    normed = np.zeros((3, nt), dtype=CDTYPE)
    for crdnt in range(3):
        V = np.abs(normal_vectors[crdnt]) / 6
        for i, pnt in enumerate(np.asarray(surface_points)):
            tris = np.asarray(tri_mask[i], dtype=np.int64)
            vol = np.abs(V[tris]).sum()
            if vol == 0:
                continue
            ok = A[tris] > 0
            t = tris[ok]
            normed[crdnt, t] += (sens[crdnt, pnt] / A[t]
                                 * np.abs(V[t]) / vol)
    return normed


def bound_mass_normalize(surface_points, normal_vectors, tri_mask, mesh,
                         sens, *, device="cuda"):
    """Solve the surface-mass-matrix system B·s̃ = s per direction
    (bound_mass_normalize, shape_sensitivity.jl:186-222).  Returns
    [3, n_points] with values on surface points.  B is factored on the
    session's solve backend and ``device``."""
    Mref = np.array([[1 / 12, 1 / 24, 1 / 24],
                     [1 / 24, 1 / 12, 1 / 24],
                     [1 / 24, 1 / 24, 1 / 12]])
    surface_points = np.asarray(surface_points)
    lookup = np.full(mesh.n_points, -1, dtype=np.int64)
    lookup[surface_points] = np.arange(len(surface_points))
    tris = lookup[mesh.triangles]  # [nt, 3] in surface numbering
    w = np.linalg.norm(normal_vectors, axis=0)
    rows = np.repeat(tris, 3, axis=1).ravel()
    cols = np.tile(tris, (1, 3)).ravel()
    vals = (Mref[None, :, :] * w[:, None, None]).ravel().astype(CDTYPE)
    B = CSR.from_coo(rows, cols, vals,
                     (len(surface_points), len(surface_points)))
    fac = linsolve.factorize(B, device=device)
    nsens = np.zeros_like(np.asarray(sens))
    for i in range(3):
        nsens[i, surface_points] = fac.solve(sens[i, surface_points])
    return nsens


def normal_sensitivity(normal_vectors, normed_sens):
    """Project per-triangle sensitivities onto unit normals
    (normal_sensitivity, shape_sensitivity.jl:230-239)."""
    n = normal_vectors / np.linalg.norm(normal_vectors, axis=0,
                                        keepdims=True)
    return np.einsum("ct,ct->t", np.conj(n).astype(CDTYPE), normed_sens)


__all__ = ["discrete_adjoint_shape_sensitivity",
           "forward_finite_differences_shape_sensitivity",
           "normalize_sensitivity", "bound_mass_normalize",
           "normal_sensitivity", "get_surface_point_masks",
           "surface_normal_vectors", "get_cylindrics",
           "blochify_surface_points"]
