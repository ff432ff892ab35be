"""FEM element kernels for P1/P2 and cubic Hermite simplices — batched
over all elements.

Host numpy, copied from the JAX package's ``fem/elements.py``, complete.
The reference ships ~2600 lines of hand-expanded closed-form local matrices
(src/FEM/FEM.jl).  Here every kernel is a single einsum over precomputed
reference-element quadrature tables, batched across the whole element set
at once (one [ne, k, k] tensor per operator instead of ne small-matrix
calls).  The quadrature (collapsed Duffy/Gauss tensor rule, exact to
degree 2n-3 on the tet / 2n-2 on the tri for n points per axis) is chosen
per kernel to cover the integrand degree (5 for P1/P2 c-weighted mass, 4
for stiffness/convection, 7 for Hermite), so results agree with the
reference's symbolic tables to machine precision.

Local DOF ordering matches aggregate_elements (FEM.jl:84-166):
  tet  P1: [v1 v2 v3 v4]
  tet  P2: [v1..v4, e12 e13 e14 e23 e24 e34]
  tri  P1: [v1 v2 v3]
  tri  P2: [v1 v2 v3, e12 e13 e23]
with barycentric coordinates (x, y, z, a=1-x-y-z) assigned to vertices
(1,2,3,4) as in the reference shape functions f1/f2 (FEM.jl:2611-2633).
"""
from __future__ import annotations

from functools import lru_cache
import numpy as np


# ---------------------------------------------------------------------------
# reference-element quadrature (generated, exact to degree 7)


@lru_cache(maxsize=None)
def _gauss01(n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1) / 2, w / 2


@lru_cache(maxsize=None)
def tet_quadrature(n: int = 4):
    """Collapsed (Duffy) tensor rule on the unit tetrahedron
    {x,y,z>0, x+y+z<1}.  The collapse Jacobian (1-u)²(1-v) raises the
    per-axis degree, so n points per axis are exact for total degree
    2n-3 only (verified numerically; n=4 → degree 5)."""
    g, w = _gauss01(n)
    pts, wts = [], []
    for i, (u, wu) in enumerate(zip(g, w)):
        for j, (v, wv) in enumerate(zip(g, w)):
            for k, (t, wt) in enumerate(zip(g, w)):
                x = u
                y = v * (1 - u)
                z = t * (1 - u) * (1 - v)
                jac = (1 - u) ** 2 * (1 - v)
                pts.append((x, y, z))
                wts.append(wu * wv * wt * jac)
    return np.asarray(pts), np.asarray(wts)


@lru_cache(maxsize=None)
def tri_quadrature(n: int = 4):
    """Collapsed tensor rule on the unit triangle {x,y>0, x+y<1};
    exact for total degree 2n-2 (the (1-u) Jacobian costs one degree)."""
    g, w = _gauss01(n)
    pts, wts = [], []
    for u, wu in zip(g, w):
        for v, wv in zip(g, w):
            x = u
            y = v * (1 - u)
            pts.append((x, y))
            wts.append(wu * wv * (1 - u))
    return np.asarray(pts), np.asarray(wts)


# ---------------------------------------------------------------------------
# reference shape functions (barycentric λ = (x, y, z, 1-x-y-z))


def tet_basis(order: int, pts: np.ndarray):
    """Values N[q, k] and reference gradients dN[q, k, 3] at points [q, 3]."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    a = 1 - x - y - z
    one = np.ones_like(x)
    zero = np.zeros_like(x)
    if order == 1:
        N = np.stack([x, y, z, a], axis=1)
        dN = np.stack([
            np.stack([one, zero, zero], 1),
            np.stack([zero, one, zero], 1),
            np.stack([zero, zero, one], 1),
            np.stack([-one, -one, -one], 1)], axis=1)
        return N, dN
    if order == 2:
        lam = [x, y, z, a]
        dlam = [np.stack([one, zero, zero], 1), np.stack([zero, one, zero], 1),
                np.stack([zero, zero, one], 1), np.stack([-one, -one, -one], 1)]
        edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        N = [(2 * l - 1) * l for l in lam]
        dN = [(4 * l - 1)[:, None] * dl for l, dl in zip(lam, dlam)]
        for i, j in edges:
            N.append(4 * lam[i] * lam[j])
            dN.append(4 * (lam[i][:, None] * dlam[j] + lam[j][:, None] * dlam[i]))
        return np.stack(N, 1), np.stack(dN, 1)
    raise ValueError(f"unsupported tet order {order}")


def tri_basis(order: int, pts: np.ndarray):
    x, y = pts[:, 0], pts[:, 1]
    a = 1 - x - y
    if order == 1:
        return np.stack([x, y, a], axis=1)
    if order == 2:
        lam = [x, y, a]
        edges = [(0, 1), (0, 2), (1, 2)]
        N = [(2 * l - 1) * l for l in lam]
        for i, j in edges:
            N.append(4 * lam[i] * lam[j])
        return np.stack(N, 1)
    raise ValueError(f"unsupported tri order {order}")


# ---------------------------------------------------------------------------
# batched geometry (CooTrafo, FEM.jl:2-21)


def tet_trafo(points: np.ndarray, tets: np.ndarray):
    """J[ne,3,3] with columns x_i - x_4, inverse, |det| (CooTrafo)."""
    p = points
    v4 = p[:, tets[:, 3]]
    # J[e] columns are edge vectors: [ne, 3(coord), 3(col)]
    J = np.empty((tets.shape[0], 3, 3))
    for c in range(3):
        J[:, :, c] = (p[:, tets[:, c]] - v4).T
    Jinv = np.linalg.inv(J)
    det = np.linalg.det(J)
    return J, Jinv, det


def tri_trafo(points: np.ndarray, tris: np.ndarray):
    """Surface triangle trafo: 3rd column = unit normal; |det| = 2·area."""
    p = points
    v3 = p[:, tris[:, 2]]
    e1 = (p[:, tris[:, 0]] - v3).T
    e2 = (p[:, tris[:, 1]] - v3).T
    n = np.cross(e1, e2)
    nn = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / nn
    J = np.stack([e1, e2, n], axis=2)
    Jinv = np.linalg.inv(J)
    det = np.linalg.det(J)
    return J, Jinv, det


# ---------------------------------------------------------------------------
# batched operator kernels
#
# Every kernel is written as   per-element geometry ⊗ precomputed exact
# integration tensor  →  one [ne, ·] × [·, k·k] BLAS matmul — the layout that
# is memory-minimal on host.
# The integration tensors contract the quadrature axis once at table-build
# time; P1 coefficient fields enter *exactly* through their vertex values
# (weight Σ c_k λ_k, squared for the cc1 stiffness), not via sampling.


@lru_cache(maxsize=None)
def _tet_mass_tables(order: int):
    """T0[i,j] = ∫ φiφj and Tc[k, i·j] = ∫ λk φiφj on the reference tet."""
    pts, w = tet_quadrature(4)
    N, _ = tet_basis(order, pts)
    N1, _ = tet_basis(1, pts)
    T0 = np.einsum("q,qi,qj->ij", w, N, N)
    Tc = np.einsum("q,qk,qi,qj->kij", w, N1, N, N)
    k = N.shape[1]
    return T0, Tc.reshape(4, k * k), k


@lru_cache(maxsize=None)
def _tet_stiff_tables(order: int):
    """T0[m·o, i·j] = ∫ dNi_m dNj_o and Tc[k·l·m·o, i·j] = ∫ λkλl dNi_m dNj_o
    (reference-gradient tensors; contracted with JinvJinvᵀ per element)."""
    pts, w = tet_quadrature(4)
    _, dN = tet_basis(order, pts)
    N1, _ = tet_basis(1, pts)
    T0 = np.einsum("q,qim,qjo->moij", w, dN, dN)
    Tc = np.einsum("q,qk,ql,qim,qjo->klmoij", w, N1, N1, dN, dN)
    k = dN.shape[1]
    return T0.reshape(9, k * k), Tc.reshape(16 * 9, k * k), k


@lru_cache(maxsize=None)
def _tri_mass_tables(order: int):
    pts, w = tri_quadrature(4)
    N = tri_basis(order, pts)
    N1 = tri_basis(1, pts)
    T0 = np.einsum("q,qi,qj->ij", w, N, N)
    Tc = np.einsum("q,qk,qi,qj->kij", w, N1, N, N)
    k = N.shape[1]
    return T0, Tc.reshape(3, k * k), k


def tet_mass(points, tets, order: int, c=None) -> np.ndarray:
    """[ne,k,k] mass matrices ∫ (c²-weighted optional) φi φj
    (s43v1u1 / s43v2u2 / *c1 variants, FEM.jl:704-940).

    ``c`` of shape [ne] (constant per element — multiplies directly) or
    [ne, 4] (P1-interpolated field; integrand weight Σ c_k λ_k)."""
    if order == "herm":
        return tet_mass_herm(points, tets, c)
    T0, Tc, k = _tet_mass_tables(order)
    _, _, det = tet_trafo(points, tets)
    absdet = np.abs(det)
    if c is None:
        return absdet[:, None, None] * T0[None]
    c = np.asarray(c)
    if c.ndim == 1:
        return (absdet * c)[:, None, None] * T0[None]
    M = (absdet[:, None] * c) @ Tc  # [ne,4] @ [4,k²]
    return M.reshape(-1, k, k)


def tet_stiffness(points, tets, order: int, c2=None) -> np.ndarray:
    """[ne,k,k] stiffness ∫ c² ∇φi·∇φj (s43nv1nu1[cc1], s43nv2nu2[cc1],
    FEM.jl:1745-2400).  ``c2``: None, [ne] (c² constant), or [ne,4]
    (per-vertex c, weight (Σ c_k λ_k)²)."""
    if order == "herm":
        return tet_stiffness_herm(points, tets, c2)
    T0, Tc, k = _tet_stiff_tables(order)
    _, Jinv, det = tet_trafo(points, tets)
    absdet = np.abs(det)
    A = np.einsum("emn,eon->emo", Jinv, Jinv).reshape(-1, 9)  # Jinv Jinvᵀ
    if c2 is None:
        K = (absdet[:, None] * A) @ T0
        return K.reshape(-1, k, k)
    c2 = np.asarray(c2)
    if c2.ndim == 1:
        K = ((absdet * c2)[:, None] * A) @ T0
        return K.reshape(-1, k, k)
    # per-vertex c: weight (Σ c_k λ_k)² = Σ_{kl} c_k c_l λ_k λ_l  (exact)
    cc = np.einsum("ek,el->ekl", c2, c2).reshape(-1, 16)
    G = np.einsum("e,ep,em->epm", absdet, cc, A).reshape(-1, 16 * 9)
    return (G @ Tc).reshape(-1, k, k)


def tri_mass(points, tris, order: int, c=None) -> np.ndarray:
    """[ne,k,k] boundary mass ∫ c φi φj over surface triangles
    (s33v1u1[c1], s33v2u2[c1], FEM.jl:435-560)."""
    if order == "herm":
        return tri_mass_herm(points, tris, c)
    T0, Tc, k = _tri_mass_tables(order)
    _, _, det = tri_trafo(points, tris)
    absdet = np.abs(det)
    if c is None:
        return absdet[:, None, None] * T0[None]
    c = np.asarray(c)
    if c.ndim == 1:
        return (absdet * c)[:, None, None] * T0[None]
    M = (absdet[:, None] * c) @ Tc
    return M.reshape(-1, k, k)


def tet_source(points, tets, order: int) -> np.ndarray:
    """[ne,k] volume source vectors ∫ φi (s43v1/s43v2, FEM.jl:2429-2436)."""
    if order == "herm":
        return tet_source_herm(points, tets)
    pts, w = tet_quadrature(3)
    N, _ = tet_basis(order, pts)
    _, _, det = tet_trafo(points, tets)
    v = np.einsum("q,qi->i", w, N)
    return np.abs(det)[:, None] * v[None]


def tri_source(points, tris, order: int, c=None) -> np.ndarray:
    """[ne,k] wall source ∫ c φi (s33v1[c1]/s33v2[c1], FEM.jl:2557-2608)."""
    if order == "herm":
        return tri_source_herm(points, tris, c)
    pts, w = tri_quadrature(3)
    N = tri_basis(order, pts)
    N1 = tri_basis(1, pts)
    _, _, det = tri_trafo(points, tris)
    absdet = np.abs(det)
    if c is None:
        v = np.einsum("q,qi->i", w, N)
        return absdet[:, None] * v[None]
    c = np.asarray(c)
    if c.ndim == 1:
        v = np.einsum("q,qi->i", w, N)
        return (absdet * c)[:, None] * v[None]
    cq = np.einsum("ek,qk->eq", c, N1)
    return np.einsum("e,eq,q,qi->ei", absdet, cq, w, N, optimize=True)


# ---------------------------------------------------------------------------
# cubic Hermite elements (20-DOF tet / 13-DOF surface tri, FEM.jl:171-336,
# 452-533, 740-762, 1876-2282, 2437-2440, 2565-2608)
#
# Reference DOF order (matches aggregate_elements, FEM.jl:117-166):
#   tet: [val@v1..v4 | ∂x@v1..v4 | ∂y@v1..v4 | ∂z@v1..v4 | val@f1..f4]
#   tri: [val@v1..v3 | ∂x@v1..v3 | ∂y@v1..v3 | ∂z@v1..v3 | val@centroid]
# with f_i the centroid of the face opposite vertex i.  The basis is built
# on the reference simplex with *reference-coordinate* derivative DOFs via a
# Vandermonde solve over the 20 (resp. 10) cubic monomials — this uniquely
# determines the same polynomials as the reference's closed forms (fh,
# FEM.jl:2634-2670) — and per-element matrices are conjugated with the
# Jacobian blocks so the stored DOFs are *global* gradients
# (recombine_hermite, FEM.jl:171-336).


@lru_cache(maxsize=None)
def _tet_monomials():
    return [(i, j, k) for i in range(4) for j in range(4) for k in range(4)
            if i + j + k <= 3]


@lru_cache(maxsize=None)
def _tri_monomials():
    return [(i, j) for i in range(4) for j in range(4) if i + j <= 3]


def _mono_eval_3d(exps, pts):
    """values [q, m] and gradients [q, m, 3] of 3-D monomials at pts."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    V = np.empty((len(pts), len(exps)))
    G = np.empty((len(pts), len(exps), 3))
    for m, (i, j, k) in enumerate(exps):
        V[:, m] = x ** i * y ** j * z ** k
        G[:, m, 0] = i * x ** max(i - 1, 0) * y ** j * z ** k
        G[:, m, 1] = j * x ** i * y ** max(j - 1, 0) * z ** k
        G[:, m, 2] = k * x ** i * y ** j * z ** max(k - 1, 0)
    return V, G


def _mono_eval_2d(exps, pts):
    x, y = pts[:, 0], pts[:, 1]
    V = np.empty((len(pts), len(exps)))
    G = np.empty((len(pts), len(exps), 2))
    for m, (i, j) in enumerate(exps):
        V[:, m] = x ** i * y ** j
        G[:, m, 0] = i * x ** max(i - 1, 0) * y ** j
        G[:, m, 1] = j * x ** i * y ** max(j - 1, 0)
    return V, G


@lru_cache(maxsize=None)
def _herm_tet_coeffs() -> np.ndarray:
    """[20 dof, 20 mono] coefficient matrix of the reference-tet Hermite
    basis: row r holds the monomial coefficients of shape function N_r."""
    exps = _tet_monomials()
    verts = np.array([[1.0, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]])
    cents = np.array([(verts[[1, 2, 3]]).mean(0), (verts[[0, 2, 3]]).mean(0),
                      (verts[[0, 1, 3]]).mean(0), (verts[[0, 1, 2]]).mean(0)])
    Vv, Gv = _mono_eval_3d(exps, verts)
    Vc, _ = _mono_eval_3d(exps, cents)
    D = np.concatenate([Vv, Gv[:, :, 0], Gv[:, :, 1], Gv[:, :, 2], Vc])
    return np.linalg.inv(D).T


@lru_cache(maxsize=None)
def _herm_tri_coeffs() -> np.ndarray:
    """[10 dof, 10 mono] 2-D cubic Hermite basis on the reference triangle;
    DOF order [val@v1..3, ∂x@v1..3, ∂y@v1..3, val@centroid].  (The in-plane
    trace of the tet element: normal-derivative DOFs have identically zero
    trace and are inserted as zero functions by the callers.)"""
    exps = _tri_monomials()
    verts = np.array([[1.0, 0], [0, 1], [0, 0]])
    cent = verts.mean(0, keepdims=True)
    Vv, Gv = _mono_eval_2d(exps, verts)
    Vc, _ = _mono_eval_2d(exps, cent)
    D = np.concatenate([Vv, Gv[:, :, 0], Gv[:, :, 1], Vc])
    return np.linalg.inv(D).T


@lru_cache(maxsize=None)
def _herm_tet_tables():
    """Hermite basis values [q,20] and reference gradients [q,20,3] at the
    tet quadrature points."""
    pts, w = tet_quadrature(5)
    C = _herm_tet_coeffs()
    V, G = _mono_eval_3d(_tet_monomials(), pts)
    return pts, w, V @ C.T, np.einsum("qmd,nm->qnd", G, C)


@lru_cache(maxsize=None)
def _herm_tri_tables():
    """13-DOF triangle basis values [q,13] at the tri quadrature points
    (normal-derivative DOF columns are zero)."""
    pts, w = tri_quadrature(5)
    C = _herm_tri_coeffs()
    V, _ = _mono_eval_2d(_tri_monomials(), pts)
    N10 = V @ C.T  # [q, 10] in order [v(3), dx(3), dy(3), cent]
    N = np.zeros((len(pts), 13))
    N[:, 0:3] = N10[:, 0:3]
    N[:, 3:6] = N10[:, 3:6]     # ref-∂x DOFs
    N[:, 6:9] = N10[:, 6:9]     # ref-∂y DOFs
    N[:, 9:12] = 0.0            # ref-normal-derivative DOFs: zero trace
    N[:, 12] = N10[:, 9]
    return pts, w, N


def herm_tet_eval(loc: np.ndarray):
    """Hermite basis values [q,20] / ref-gradients [q,20,3] at arbitrary
    reference coordinates (for point getters; fh, FEM.jl:2634-2670)."""
    C = _herm_tet_coeffs()
    V, G = _mono_eval_3d(_tet_monomials(), np.atleast_2d(loc))
    return V @ C.T, np.einsum("qmd,nm->qnd", G, C)


def _herm_recomb_tet(J: np.ndarray) -> np.ndarray:
    """[ne,20,20] change-of-basis R so global-gradient-DOF element matrices
    are A = R M_ref Rᵀ (recombine_hermite, FEM.jl:171-336).  Row of global
    ∂x_d DOF at vertex v picks ref ∂ξ_m DOFs with weight J[d,m]=∂x_d/∂ξ_m."""
    ne = J.shape[0]
    R = np.zeros((ne, 20, 20))
    idx = np.arange(4)
    R[:, idx, idx] = 1.0
    R[:, 16 + idx, 16 + idx] = 1.0
    for d in range(3):
        for m in range(3):
            R[:, 4 + 4 * d + idx, 4 + 4 * m + idx] = J[:, d, m, None]
    return R


def _herm_recomb_tri(J: np.ndarray) -> np.ndarray:
    """[ne,13,13] triangle recombination; J from tri_trafo (3rd column =
    unit normal), so global gradient DOFs include the out-of-plane part."""
    ne = J.shape[0]
    R = np.zeros((ne, 13, 13))
    idx = np.arange(3)
    R[:, idx, idx] = 1.0
    R[:, 12, 12] = 1.0
    for d in range(3):
        for m in range(3):
            R[:, 3 + 3 * d + idx, 3 + 3 * m + idx] = J[:, d, m, None]
    return R


def tet_mass_herm(points, tets, c=None) -> np.ndarray:
    """[ne,20,20] Hermite mass matrices ∫ (c·) φi φj
    (s43vhuh[c1], FEM.jl:740-762,892-940)."""
    pts, w, N, _ = _herm_tet_tables()
    J, _, det = tet_trafo(points, tets)
    absdet = np.abs(det)
    R = _herm_recomb_tet(J)
    if c is None:
        M0 = np.einsum("q,qi,qj->ij", w, N, N)
        M = absdet[:, None, None] * M0[None]
    else:
        c = np.asarray(c)
        if c.ndim == 1:
            M0 = np.einsum("q,qi,qj->ij", w, N, N)
            M = (absdet * c)[:, None, None] * M0[None]
        else:
            N1, _ = tet_basis(1, pts)
            Tc = np.einsum("q,qk,qi,qj->kij", w, N1, N, N).reshape(4, -1)
            M = ((absdet[:, None] * c) @ Tc).reshape(-1, 20, 20)
    return np.matmul(np.matmul(R, M), R.swapaxes(1, 2))


def tet_stiffness_herm(points, tets, c2=None) -> np.ndarray:
    """[ne,20,20] Hermite stiffness ∫ (c²·) ∇φi·∇φj
    (s43nvhnuh, FEM.jl:1876-2282; s43nvhnuhcc1, s43nvhnuhcc1.jl)."""
    pts, w, _, dN = _herm_tet_tables()
    J, Jinv, det = tet_trafo(points, tets)
    absdet = np.abs(det)
    A = np.einsum("emn,eon->emo", Jinv, Jinv).reshape(-1, 9)
    if c2 is None:
        T0 = np.einsum("q,qim,qjo->moij", w, dN, dN).reshape(9, -1)
        K = ((absdet[:, None] * A) @ T0).reshape(-1, 20, 20)
    else:
        c2 = np.asarray(c2)
        if c2.ndim == 1:
            T0 = np.einsum("q,qim,qjo->moij", w, dN, dN).reshape(9, -1)
            K = (((absdet * c2)[:, None] * A) @ T0).reshape(-1, 20, 20)
        else:
            N1, _ = tet_basis(1, pts)
            Tc = np.einsum("q,qk,ql,qim,qjo->klmoij", w, N1, N1, dN, dN,
                           optimize=True).reshape(16 * 9, -1)
            cc = np.einsum("ek,el->ekl", c2, c2).reshape(-1, 16)
            G = np.einsum("e,ep,em->epm", absdet, cc, A).reshape(-1, 16 * 9)
            K = (G @ Tc).reshape(-1, 20, 20)
    R = _herm_recomb_tet(J)
    return np.matmul(np.matmul(R, K), R.swapaxes(1, 2))


def tet_source_herm(points, tets) -> np.ndarray:
    """[ne,20] Hermite volume source ∫ φi (s43vh, FEM.jl:2437-2440)."""
    pts, w, N, _ = _herm_tet_tables()
    J, _, det = tet_trafo(points, tets)
    v = np.einsum("q,qi->i", w, N)
    R = _herm_recomb_tet(J)
    return np.abs(det)[:, None] * np.einsum("eik,k->ei", R, v)


def tri_mass_herm(points, tris, c=None) -> np.ndarray:
    """[ne,13,13] Hermite boundary mass ∫ (c·) φi φj
    (s33vhuh[c1], FEM.jl:452-533)."""
    pts, w, N = _herm_tri_tables()
    J, _, det = tri_trafo(points, tris)
    absdet = np.abs(det)
    R = _herm_recomb_tri(J)
    if c is None:
        M0 = np.einsum("q,qi,qj->ij", w, N, N)
        M = absdet[:, None, None] * M0[None]
    else:
        c = np.asarray(c)
        if c.ndim == 1:
            M0 = np.einsum("q,qi,qj->ij", w, N, N)
            M = (absdet * c)[:, None, None] * M0[None]
        else:
            N1 = tri_basis(1, pts)
            Tc = np.einsum("q,qk,qi,qj->kij", w, N1, N, N).reshape(3, -1)
            M = ((absdet[:, None] * c) @ Tc).reshape(-1, 13, 13)
    return np.matmul(np.matmul(R, M), R.swapaxes(1, 2))


def tri_source_herm(points, tris, c=None) -> np.ndarray:
    """[ne,13] Hermite wall source ∫ (c·) φi
    (s33vh[c1], FEM.jl:2565-2608)."""
    pts, w, N = _herm_tri_tables()
    J, _, det = tri_trafo(points, tris)
    absdet = np.abs(det)
    R = _herm_recomb_tri(J)
    if c is None:
        v = np.einsum("q,qi->i", w, N)
        return absdet[:, None] * np.einsum("eik,k->ei", R, v)
    c = np.asarray(c)
    if c.ndim == 1:
        v = np.einsum("q,qi->i", w, N)
        return (absdet * c)[:, None] * np.einsum("eik,k->ei", R, v)
    N1 = tri_basis(1, pts)
    cq = np.einsum("ek,qk->eq", c, N1)
    v = np.einsum("e,eq,q,qi->ei", absdet, cq, w, N, optimize=True)
    return np.einsum("eik,ek->ei", R, v)


def tet_deriv(points, tets, test_order: int, trial_order: int, d: int,
              c=None) -> np.ndarray:
    """[ne, k_test, k_trial] convection/coupling matrices
    ∫ (c·) φi^{test} ∂φj^{trial}/∂x_d  over each tetrahedron
    (s43v1du1[c1], s43v2du1, s43v2du2c1 and their transposes s43dv1u1 /
    s43dv1u2, FEM.jl:1299-1457).

    ``c``: None, [ne] (constant per element), or [ne, 4] (P1-interpolated
    per-vertex field)."""
    pts, w = tet_quadrature(4)
    Nt, _ = tet_basis(test_order, pts)
    _, dNu = tet_basis(trial_order, pts)
    N1, _ = tet_basis(1, pts)
    _, Jinv, det = tet_trafo(points, tets)
    absdet = np.abs(det)
    # physical d-derivative of trial basis: g[e,q,j] = dNu[q,j,m]·Jinv[e,m,d]
    g = np.einsum("qjm,em->eqj", dNu, Jinv[:, :, d])
    if c is None:
        K = np.einsum("q,qi,eqj->eij", w, Nt, g, optimize=True)
        return absdet[:, None, None] * K
    c = np.asarray(c)
    if c.ndim == 1:
        K = np.einsum("q,qi,eqj->eij", w, Nt, g, optimize=True)
        return (absdet * c)[:, None, None] * K
    cq = np.einsum("ek,qk->eq", c, N1)
    return np.einsum("e,eq,q,qi,eqj->eij", absdet, cq, w, Nt, g, optimize=True)


def tet_field_deriv(points, tets, c, d: int) -> np.ndarray:
    """[ne] constant physical d-derivative of a P1 per-vertex field ``c``
    ([ne, 4] gathered values; s43diffc1, FEM.jl:338-341):
    ∂c/∂x_d = Σ_k c_k ∂λ_k/∂x_d (constant on each element)."""
    _, Jinv, _ = tet_trafo(points, tets)
    _, dN1 = tet_basis(1, np.zeros((1, 3)))
    c = np.asarray(c)
    return np.einsum("ek,km,em->e", c, dN1[0], Jinv[:, :, d])


def tet_grad_at_point(points, tet: np.ndarray, order: int, n_ref, x_ref):
    """Directional-derivative row: n_ref·∇φi evaluated at physical point
    x_ref inside one tetrahedron (s43nv1rx/s43nv2rx, FEM.jl:2442-2516).
    Returns [k] vector."""
    p = points
    v4 = p[:, tet[3]]
    J = np.stack([p[:, tet[0]] - v4, p[:, tet[1]] - v4, p[:, tet[2]] - v4],
                 axis=1)
    Jinv = np.linalg.inv(J)
    loc = Jinv @ (np.asarray(x_ref, dtype=np.float64) - v4)
    n_ref = np.asarray(n_ref, dtype=np.float64)
    if order == "herm":
        _, dN = herm_tet_eval(loc[None, :])
        r = np.einsum("im,mn,n->i", dN[0], Jinv, n_ref)
        return _herm_recomb_tet(J[None])[0] @ r
    _, dN = tet_basis(order, loc[None, :])
    # physical gradient = dN @ Jinv;  row_i = (dN_i @ Jinv) · n_ref
    return np.einsum("im,mn,n->i", dN[0], Jinv, n_ref)


def shape_values_at_point(points, tet: np.ndarray, order: int, x_ref):
    """Shape-function values at a physical point (f1/f2, FEM.jl:2611-2633)."""
    p = points
    v4 = p[:, tet[3]]
    J = np.stack([p[:, tet[0]] - v4, p[:, tet[1]] - v4, p[:, tet[2]] - v4],
                 axis=1)
    Jinv = np.linalg.inv(J)
    loc = Jinv @ (np.asarray(x_ref, dtype=np.float64) - v4)
    if order == "herm":
        N, _ = herm_tet_eval(loc[None, :])
        return _herm_recomb_tet(J[None])[0] @ N[0]
    N, _ = tet_basis(order, loc[None, :])
    return N[0]


__all__ = ["tet_quadrature", "tri_quadrature", "tet_basis", "tri_basis",
           "tet_trafo", "tri_trafo", "tet_mass", "tet_stiffness", "tri_mass",
           "tet_source", "tri_source", "tet_deriv", "tet_field_deriv",
           "tet_grad_at_point", "shape_values_at_point",
           "tet_mass_herm", "tet_stiffness_herm", "tet_source_herm",
           "tri_mass_herm", "tri_source_herm", "herm_tet_eval"]
