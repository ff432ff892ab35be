"""The port's cubic Hermite elements, point getters and APE front-end
against the JAX package, on the CPU: twins of
tests/test_element_exactness.py, tests/test_mesh_tools.py::test_get_p_*
and tests/test_ape.py, and the Hermite family end to end (a Hermite box
duct above ``FUSED_MAX_DIM`` through the port's slab engine, plain K3 on
the CPU, against JAX host mslp).  Each test runs both packages on the
same seeded numpy inputs and states its tolerance."""
import importlib

import numpy as np
import pytest

import wavesandeigenvalues_jl_tpu.fem.elements as fel_jax
import wavesandeigenvalues_jl_tpu_torch.fem.elements as fel
import wavesandeigenvalues_jl_tpu.nlevp as nlevp_jax
import wavesandeigenvalues_jl_tpu_torch.nlevp as nlevp
from wavesandeigenvalues_jl_tpu.mesh.generate import box_mesh as box_mesh_jax
from wavesandeigenvalues_jl_tpu_torch.mesh.generate import box_mesh

from port_threads import one_thread  # noqa: F401

PKGS = ("wavesandeigenvalues_jl_tpu", "wavesandeigenvalues_jl_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------------------
# element exactness (twins of tests/test_element_exactness.py): the port's
# kernels against brute-force n = 8 quadrature at the JAX test's bars, and
# against the JAX package's kernels on the same inputs to 1e-15 of the
# largest entry (the same numpy operations)

TWIN_RTOL = 1e-15


@pytest.fixture(scope="module")
def geo():
    rng = np.random.default_rng(0)
    base = np.array([[0, 1, 0, 0, 1, 1, 0, 1],
                     [0, 0, 1, 0, 1, 0, 1, 1],
                     [0, 0, 0, 1, 0, 1, 1, 1]], dtype=float)
    pts = base + 0.25 * rng.standard_normal((3, 8))
    tets = np.array([[0, 1, 2, 3], [4, 5, 6, 7]])
    tris = np.array([[0, 1, 2], [1, 2, 4]])
    c4 = rng.uniform(1, 2, (2, 4))
    c3 = rng.uniform(1, 2, (2, 3))
    return pts, tets, tris, c4, c3


def _both(name, *args, **kw):
    """fel.<name>(*args) of the port, checked against the JAX package's
    at TWIN_RTOL of its largest entry; returns the port's."""
    aj = np.asarray(getattr(fel_jax, name)(*args, **kw))
    at = np.asarray(getattr(fel, name)(*args, **kw))
    assert at.shape == aj.shape
    assert np.abs(at - aj).max() <= TWIN_RTOL * max(np.abs(aj).max(), 1e-300)
    return at


def test_quadrature_exactness_degrees():
    from math import factorial
    for n in (3, 4, 5, 8):
        for name in ("tet_quadrature", "tri_quadrature"):
            for a, b in zip(getattr(fel, name)(n), getattr(fel_jax, name)(n)):
                np.testing.assert_array_equal(a, b)
    pts, w = fel.tet_quadrature(4)
    for (i, j, k) in [(5, 0, 0), (2, 2, 1), (1, 1, 3)]:
        q = np.sum(w * pts[:, 0] ** i * pts[:, 1] ** j * pts[:, 2] ** k)
        exact = (factorial(i) * factorial(j) * factorial(k)
                 / factorial(i + j + k + 3))
        assert abs(q - exact) < 1e-14
    pts, w = fel.tri_quadrature(4)
    for (i, j) in [(6, 0), (3, 3)]:
        q = np.sum(w * pts[:, 0] ** i * pts[:, 1] ** j)
        assert abs(q - factorial(i) * factorial(j)
                   / factorial(i + j + 2)) < 1e-14


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("with_c", [False, True])
def test_tet_mass_stiffness_exact(geo, order, with_c):
    pts, tets, tris, c4, c3 = geo
    q, w = fel.tet_quadrature(8)
    N, dN = fel.tet_basis(order, q)
    N1, _ = fel.tet_basis(1, q)
    _, Jinv, det = fel.tet_trafo(pts, tets)
    absdet = np.abs(det)
    c = c4 if with_c else None
    cq = np.einsum("ek,qk->eq", c4, N1) if with_c else np.ones((2, len(w)))
    ref_m = np.einsum("e,eq,q,qi,qj->eij", absdet, cq, w, N, N)
    assert np.abs(_both("tet_mass", pts, tets, order, c) - ref_m).max() \
        < 1e-13
    A = np.einsum("emn,eon->emo", Jinv, Jinv)
    cq2 = cq ** 2 if with_c else cq
    ref_k = np.einsum("e,eq,q,qim,emo,qjo->eij", absdet, cq2, w, dN, A, dN,
                      optimize=True)
    got = _both("tet_stiffness", pts, tets, order, c)
    assert np.abs(got - ref_k).max() < 1e-13 * np.abs(ref_k).max()


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("with_c", [False, True])
def test_tri_mass_source_exact(geo, order, with_c):
    pts, tets, tris, c4, c3 = geo
    q, w = fel.tri_quadrature(8)
    N = fel.tri_basis(order, q)
    N1 = fel.tri_basis(1, q)
    _, _, det = fel.tri_trafo(pts, tris)
    absdet = np.abs(det)
    c = c3 if with_c else None
    cq = np.einsum("ek,qk->eq", c3, N1) if with_c else np.ones((2, len(w)))
    ref_m = np.einsum("e,eq,q,qi,qj->eij", absdet, cq, w, N, N)
    assert np.abs(_both("tri_mass", pts, tris, order, c) - ref_m).max() \
        < 1e-13
    ref_s = np.einsum("e,eq,q,qi->ei", absdet, cq, w, N)
    assert np.abs(_both("tri_source", pts, tris, order, c) - ref_s).max() \
        < 1e-13


@pytest.mark.parametrize("orders", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("with_c", [False, True])
def test_tet_deriv_exact(geo, orders, with_c):
    pts, tets, tris, c4, c3 = geo
    to, tr = orders
    q, w = fel.tet_quadrature(8)
    Nt, _ = fel.tet_basis(to, q)
    _, dNu = fel.tet_basis(tr, q)
    N1, _ = fel.tet_basis(1, q)
    _, Jinv, det = fel.tet_trafo(pts, tets)
    for d in range(3):
        g = np.einsum("qjm,em->eqj", dNu, Jinv[:, :, d])
        cq = np.einsum("ek,qk->eq", c4, N1) if with_c else \
            np.ones((2, len(w)))
        ref = np.einsum("e,eq,q,qi,eqj->eij", np.abs(det), cq, w, Nt, g,
                        optimize=True)
        got = _both("tet_deriv", pts, tets, to, tr, d,
                    c=c4 if with_c else None)
        assert np.abs(got - ref).max() < 1e-13
    # the constant derivative of a P1 field, as APE's term V uses it
    for d in range(3):
        _both("tet_field_deriv", pts, tets, c4, d)


def test_tet_source_exact(geo):
    pts, tets, tris, c4, c3 = geo
    q, w = fel.tet_quadrature(8)
    _, _, det = fel.tet_trafo(pts, tets)
    for order in (1, 2, "herm"):
        got = _both("tet_source", pts, tets, order)
        if order == "herm":
            continue
        N, _ = fel.tet_basis(order, q)
        ref = np.abs(det)[:, None] * np.einsum("q,qi->i", w, N)[None]
        assert np.abs(got - ref).max() < 1e-14


def test_hermite_mass_stiffness_exact(geo):
    """Twin of test_element_exactness.py::test_hermite_mass_stiffness_exact
    (1e-12 of the largest entry against n = 8), and every Hermite kernel
    (with c none, per element and per vertex) against JAX's."""
    pts, tets, tris, c4, c3 = geo
    q, w = fel.tet_quadrature(8)
    N, dN = fel.herm_tet_eval(q)
    N1, _ = fel.tet_basis(1, q)
    J, Jinv, det = fel.tet_trafo(pts, tets)
    absdet = np.abs(det)
    R = fel._herm_recomb_tet(J)
    np.testing.assert_array_equal(R, fel_jax._herm_recomb_tet(J))
    cq = np.einsum("ek,qk->eq", c4, N1)
    M_ref = np.einsum("e,eq,q,qi,qj->eij", absdet, cq, w, N, N,
                      optimize=True)
    M_ref = np.matmul(np.matmul(R, M_ref), R.swapaxes(1, 2))
    got = _both("tet_mass_herm", pts, tets, c4)
    assert np.abs(got - M_ref).max() < 1e-12 * np.abs(M_ref).max()
    A = np.einsum("emn,eon->emo", Jinv, Jinv)
    K_ref = np.einsum("e,eq,q,qim,emo,qjo->eij", absdet, cq ** 2, w, dN, A,
                      dN, optimize=True)
    K_ref = np.matmul(np.matmul(R, K_ref), R.swapaxes(1, 2))
    got = _both("tet_stiffness_herm", pts, tets, c4)
    assert np.abs(got - K_ref).max() < 1e-12 * np.abs(K_ref).max()
    for c in (None, c4[:, 0]):
        _both("tet_mass", pts, tets, "herm", c)
        _both("tet_stiffness", pts, tets, "herm", c)
    for c in (None, c3[:, 0], c3):
        _both("tri_mass", pts, tris, "herm", c)
        _both("tri_source", pts, tris, "herm", c)
    x = pts[:, tets[1]].mean(axis=1) + 0.01
    for order in (1, 2, "herm"):
        _both("shape_values_at_point", pts, tets[1], order, x)
        _both("tet_grad_at_point", pts, tets[1], order, [0.3, -0.8, 0.52], x)


# ---------------------------------------------------------------------------
# point getters (twins of tests/test_mesh_tools.py::test_get_p_*)


def test_get_p_linear_field():
    """Twin of test_get_p_linear_field: exact on a P1 field (np.isclose),
    and the JAX package's values to 1e-15."""
    out = []
    for pkg in PKGS:
        m = _mod(pkg, "mesh.generate").box_mesh(nx=3, ny=3, nz=3)
        getters = _mod(pkg, "fem")
        x, y, z = m.points
        sol = 1.0 + 2.0 * x + 3.0 * y + 4.0 * z
        pt = np.array([0.37, 0.21, 0.55])
        n = np.array([1.0, -1.0, 0.5])
        out.append((getters.get_p(m, sol, pt),
                    getters.get_n_grad_p(m, sol, pt, n)))
    (pj, gj), (p, g) = out
    assert np.isclose(p, 1 + 2 * .37 + 3 * .21 + 4 * .55)
    assert np.isclose(g, 2 - 3 + 2.0)
    assert abs(p - pj) <= 1e-15 * abs(pj) and abs(g - gj) <= 1e-15 * abs(gj)


def test_get_p_quadratic_field():
    """Twin of test_get_p_quadratic_field (P2 field, order inferred from
    the vector's length)."""
    out = []
    f = lambda p: p[0] ** 2 + p[1] * p[2] - 2 * p[2] ** 2 + p[0]  # noqa
    pt = np.array([0.63, 0.44, 0.17])
    n = np.array([0.3, -0.8, 0.52])
    for pkg in PKGS:
        m = _mod(pkg, "mesh.generate").box_mesh(nx=2, ny=2, nz=2)
        fem = _mod(pkg, "fem")
        _, _, dim = fem.aggregate_elements(m, "quad")
        mids = 0.5 * (m.points[:, m.lines[:, 0]] + m.points[:, m.lines[:, 1]])
        sol = f(np.concatenate([m.points, mids], axis=1))
        assert len(sol) == dim
        assert fem.getters.infer_order(m, dim) == 2
        out.append((fem.get_p(m, sol, pt), fem.get_n_grad_p(m, sol, pt, n)))
    (pj, gj), (p, g) = out
    assert np.isclose(p, f(pt))
    assert np.isclose(g, np.array([2 * pt[0] + 1, pt[2],
                                   pt[1] - 4 * pt[2]]) @ n)
    assert abs(p - pj) <= 1e-15 * abs(pj) and abs(g - gj) <= 1e-15 * abs(gj)


# ---------------------------------------------------------------------------
# Hermite numbering and patch tests (twins of tests/test_ape.py)


def _herm_dofs_of(pkg, mesh, f, grad):
    """Hermite DOF vector of an analytic field (values, global gradients,
    face-centroid values), numbered by ``pkg``."""
    fea = _mod(pkg, "fem.assembly")
    _, tet_dofs, dim = fea.aggregate_elements(mesh, "herm")
    pts = mesh.points
    n = mesh.n_points
    u = np.zeros(dim)
    u[:n] = f(pts)
    g = grad(pts)
    for d in range(3):
        u[(d + 1) * n:(d + 2) * n] = g[d]
    t = mesh.tetrahedra
    for fi, fc in enumerate(fea.TET_FACES):
        u[tet_dofs[:, 16 + fi]] = f(pts[:, t[:, list(fc)]].mean(axis=2))
    return u, tet_dofs, dim


def test_hermite_numbering_twin():
    """The Hermite numbering (vertex banks, then surface and interior face
    bubbles) array for array, including interior faces filled in where the
    mesh has none, and the same ``_dof_cache`` re-use."""
    outs = []
    for pkg in PKGS:
        m = _mod(pkg, "mesh.generate").box_mesh(nx=2, ny=1, nz=3)
        m.int_triangles = np.zeros((0, 3), np.int64)
        fea = _mod(pkg, "fem.assembly")
        tri, tet, dim = fea.aggregate_elements(m, "herm")
        assert fea.aggregate_elements(m, "herm")[2] == dim
        assert _mod(pkg, "fem.getters").infer_order(m, dim) == "herm"
        outs.append((tri, tet, dim, m.int_triangles))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


def test_hermite_patch_constant_and_linear():
    """Twin of test_ape.py::test_hermite_patch_constant_and_linear at the
    JAX test's bars."""
    mesh = box_mesh(nx=2, ny=2, nz=2)
    M = fel.tet_mass_herm(mesh.points, mesh.tetrahedra)
    K = fel.tet_stiffness_herm(mesh.points, mesh.tetrahedra)
    pkg = PKGS[1]
    u1, tet_dofs, dim = _herm_dofs_of(
        pkg, mesh, lambda p: np.ones(p.shape[1]), lambda p: np.zeros_like(p))
    ue = u1[tet_dofs]
    assert abs(np.einsum("ei,eij,ej->", ue, M, ue) - 1.0) < 1e-10
    assert np.max(np.abs(np.einsum("eij,ej->ei", K, ue))) < 1e-9
    one = np.ones
    ul, _, _ = _herm_dofs_of(
        pkg, mesh, lambda p: 2 * p[0] - p[1] + 3 * p[2],
        lambda p: np.stack([2 * one(p.shape[1]), -one(p.shape[1]),
                            3 * one(p.shape[1])]))
    ue = ul[tet_dofs]
    assert abs(np.einsum("ei,eij,ej->", ue, K, ue) - 14.0) < 1e-9
    uc, _, _ = _herm_dofs_of(
        pkg, mesh, lambda p: p[0] ** 3,
        lambda p: np.stack([3 * p[0] ** 2, np.zeros(p.shape[1]),
                            np.zeros(p.shape[1])]))
    ue = uc[tet_dofs]
    assert abs(np.einsum("ei,eij,ej->", ue, M, ue) - 1.0 / 7.0) < 1e-10


def test_hermite_tri_trace_consistency():
    """Twin of test_ape.py::test_hermite_tri_trace_consistency."""
    from wavesandeigenvalues_jl_tpu_torch.fem import assembly as fea
    mesh = box_mesh(nx=2, ny=2, nz=2)
    tri_dofs, _, dim = fea.aggregate_elements(mesh, "herm")
    Ms = fel.tri_mass_herm(mesh.points, mesh.triangles)
    u = np.zeros(dim)
    u[:mesh.n_points] = 1.0
    u[4 * mesh.n_points:4 * mesh.n_points + len(mesh.triangles)] = 1.0
    ue = u[tri_dofs]
    assert abs(np.einsum("ei,eij,ej->", ue, Ms, ue) - 6.0) < 1e-9
    S = fel.tri_source_herm(mesh.points, mesh.triangles)
    assert abs(np.einsum("ei,ei->", ue, S) - 6.0) < 1e-9


def test_helmholtz_hermite_duct_mode():
    """Twin of test_ape.py::test_helmholtz_hermite_duct_mode: the port's
    mslp (dense engine, plain K2) on the Hermite rigid duct gives JAX
    host's ω within 1e-8·|ω| and the half-wave mode; the getters on the
    port's mode give the cosine ratios at the JAX test's bars."""
    from wavesandeigenvalues_jl_tpu_torch.fem import get_n_grad_p, get_p
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    from wavesandeigenvalues_jl_tpu.models import discretize as disc_jax
    c = 343.0
    z0 = 2 * np.pi * (c / 2) * 1.03
    sols = []
    for bm, disc, solve, kw in ((box_mesh_jax, disc_jax, nlevp_jax.mslp, {}),
                                (box_mesh, discretize, nlevp.mslp,
                                 {"device": "cpu"})):
        mesh = bm(lx=0.25, ly=0.25, lz=1.0, nx=1, ny=1, nz=4)
        L = disc(mesh, {"Interior": ("interior", ())},
                 c * np.ones(mesh.n_points), order="herm")
        sols.append(solve(L, z0, maxiter=30, tol=1e-9, **kw)[0])
    wj, w = (s.params["ω"] for s in sols)
    assert abs(w - wj) <= 1e-8 * abs(wj)
    assert abs(w.real / 2 / np.pi - c / 2) < 0.005 * c / 2
    v = sols[1].v
    v = v / v[np.argmax(np.abs(v[:mesh.n_points]))]
    pa = get_p(mesh, v, (0.1, 0.1, 0.43))
    pb = get_p(mesh, v, (0.12, 0.1, 0.0))
    assert abs((pa / pb).real - np.cos(np.pi * 0.43)) < 0.02
    ga = get_n_grad_p(mesh, v, (0.1, 0.1, 0.43), (0, 0, 1.0))
    assert abs((ga / pb).real + np.pi * np.sin(np.pi * 0.43)) < 0.15


def test_hermite_duct_slab_mslp():
    """The slice end to end on the Hermite family above FUSED_MAX_DIM: a
    box duct with an outlet penalty (Y = 1e15) and 1,618 DOF through the
    port's slab engine (plain K3 on the CPU) against JAX host mslp: flag 0
    and ω within 1e-8·|ω| (tests/test_fused_slab.py:47's bar); the
    port's SlabPartition gives JAX's m and smax."""
    from wavesandeigenvalues_jl_tpu.models import discretize as disc_jax
    from wavesandeigenvalues_jl_tpu.ops.slab_solve import \
        SlabPartition as PartJ
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local import \
        FUSED_MAX_DIM
    from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
        FusedSlabPencilSolver
    c, dscrp = 343.0, {"Interior": ("interior", ()),
                       "Zmax": ("admittance", ("Y", 1e15))}
    z0 = 2 * np.pi * (c / 4) * 1.02
    Ls = [disc(bm(lx=0.05, ly=0.05, lz=1.0, nx=1, ny=1, nz=50), dscrp,
               c * np.ones(204), order="herm")
          for bm, disc in ((box_mesh_jax, disc_jax), (box_mesh, discretize))]
    Lj, Lt = Ls
    assert Lt.size == Lj.size == 1618 > FUSED_MAX_DIM
    solj, _, flagj = nlevp_jax.mslp(Lj, z0, maxiter=30, tol=1e-9)
    sol, _, flag = nlevp.mslp(Lt, z0, maxiter=30, tol=1e-9, device="cpu")
    solver = Lt._fused_solver[1]
    assert isinstance(solver, FusedSlabPencilSolver)
    Sj = Lj._stack()
    pj = PartJ(Sj.indptr, Sj.indices, Lj.size)
    assert (solver.part.m, solver.part.smax) == (pj.m, pj.smax)
    assert flag == flagj == 0
    wj = solj.params["ω"]
    assert abs(sol.params["ω"] - wj) <= 1e-8 * abs(wj)
    assert abs(wj.real / 2 / np.pi - c / 4) < 0.01 * c / 4


# ---------------------------------------------------------------------------
# potential flow and APE (twins of tests/test_ape.py)


@pytest.mark.parametrize("order", ["const", "lin"])
def test_potflow_uniform_duct(order):
    """Twin of test_ape.py::test_potflow_uniform_duct: U = (0, 0, q/A) at
    the JAX test's bars; the port's against JAX's (both SuperLU; the JAX
    package sums large COO sets in C++, in another order) to 1e-10 of
    q/A."""
    q, A = 0.1, 0.25
    out = []
    for pkg in PKGS:
        mesh = _mod(pkg, "mesh.generate").box_mesh(lx=0.5, ly=0.5, lz=1.0,
                                                   nx=2, ny=2, nz=4)
        out.append(_mod(pkg, "models.ape").compute_potflow_field(
            mesh, {"Zmin": q, "Zmax": -q}, order=order))
    Uj, U = out
    n_cols = len(mesh.tetrahedra) if order == "const" else mesh.n_points
    assert U.shape == Uj.shape == (3, n_cols)
    assert np.allclose(U[2], q / A, atol=1e-8 * q / A + 1e-10)
    assert np.max(np.abs(U[:2])) < 1e-8
    assert np.abs(U - Uj).max() <= 1e-10 * q / A


def _ape_pair(lz, nz, dscrp, U_of=None):
    out = []
    for pkg in PKGS:
        mesh = _mod(pkg, "mesh.generate").box_mesh(lx=0.25, ly=0.25, lz=lz,
                                                   nx=1, ny=1, nz=nz)
        mesh.collect_lines()
        U = None if U_of is None else U_of(mesh)
        out.append((mesh, _mod(pkg, "models.ape").discretize(mesh, dscrp,
                                                             U=U)))
    return out


def _ape_close(Lj, Lt, s=1j * 2000.0):
    """The same terms and operators: L(s) and ∂L/∂s within 1e-12 of the
    largest entry."""
    assert [t.symbol for t in Lt.terms] == [t.symbol for t in Lj.terms]
    assert Lt.params == Lj.params
    for k in (0, 1):
        Aj, At = Lj(s, k).to_dense(), Lt(s, k).to_dense()
        assert np.abs(At - Aj).max() <= 1e-12 * np.abs(Aj).max()


@pytest.fixture
def host_backend():
    """The port on the JAX package's default solve backend, "host" (the
    general engine through SuperLU), restored after the test."""
    from wavesandeigenvalues_jl_tpu_torch.utils.config import \
        set_solve_backend
    prev = set_solve_backend("host")
    yield
    set_solve_backend(prev)


def _slab(L):
    """Route L's order-1 mslp to the port's slab engine (plain K3 on CPU
    tensors), the engine of the APE path on the card."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
        FusedSlabPencilSolver
    L._fused_solver = (L._stack(), FusedSlabPencilSolver(L, "cpu"))
    return L


def test_ape_quiescent_duct_mode():
    """Twin of test_ape.py::test_ape_quiescent_duct_mode: the port's mslp
    through its slab engine (plain K3) gives JAX host's s within
    1e-8·|s|, near iπc, at flag 0.  (The dense engine does not converge
    on this family, in the JAX package as in the port: ROADMAP.md
    Queue 3, F7.)"""
    from wavesandeigenvalues_jl_tpu_torch.models import ape
    (mj, Lj), (m, Lt) = _ape_pair(1.0, 12, {})
    assert Lt.size == m.n_points + 3 * (m.n_points + len(m.lines))
    _ape_close(Lj, Lt)
    c = np.sqrt(ape.AMBIENT_GAMMA * ape.AMBIENT_P / ape.AMBIENT_RHO)
    s0 = 1j * np.pi * c * 1.06
    solj, _, _ = nlevp_jax.mslp(Lj, s0, maxiter=40, tol=1e-9)
    sol, n, flag = nlevp.mslp(_slab(Lt), s0, maxiter=40, tol=1e-9,
                              device="cpu")
    assert flag == 0
    s, sj = sol.params["s"], solj.params["s"]
    assert abs(s - sj) <= 1e-8 * abs(sj)
    assert abs(s.real) < 1e-3 * abs(s)
    assert abs(s.imag - np.pi * c) < 0.01 * np.pi * c


def test_ape_admittance_term_present():
    from wavesandeigenvalues_jl_tpu_torch.models import ape
    (_, Lj), (_, Lt) = _ape_pair(1.0, 4, {"Zmin": 0.1, "Zmax": -0.1})
    _ape_close(Lj, Lt)
    assert "Y_Zmin" in Lt.params and "Y_Zmax" in Lt.params
    cbar = np.sqrt(ape.AMBIENT_GAMMA * ape.AMBIENT_P / ape.AMBIENT_RHO)
    assert np.isclose(Lt.params["Y_Zmin"], -cbar / (0.1 / 0.0625))


def test_ape_mean_flow_term():
    """Twin of test_ape.py::test_ape_mean_flow_term."""
    (_, L0j), (_, L0) = _ape_pair(0.5, 4, {})
    (_, Luj), (_, Lu) = _ape_pair(0.5, 4, {},
                                  lambda m: np.zeros((3, m.n_points)))
    _ape_close(Luj, Lu)
    assert "v" in Lu.params
    s0 = 1j * 2000.0
    assert np.allclose(L0(s0).to_dense(), Lu(s0).to_dense(), atol=1e-12)


def test_ape_uniform_flow_dispersion(host_backend):
    """Twin of test_ape.py::test_ape_uniform_flow_dispersion on the "host"
    backend (the JAX package's default; the port's general engine): the
    convective factor (1 − M²) within 5e-3 (the JAX bar), each s within
    1e-8·|s| of JAX host's; the mean-flow family term for term within
    1e-12."""
    from wavesandeigenvalues_jl_tpu_torch.models import ape
    c = np.sqrt(ape.AMBIENT_GAMMA * ape.AMBIENT_P / ape.AMBIENT_RHO)
    M = 0.2

    def uniform(m):
        U = np.zeros((3, m.n_points))
        U[2] = M * c
        return U

    L0s = [L for _, L in _ape_pair(1.0, 14, {})]
    Lus = [L for _, L in _ape_pair(1.0, 14, {}, uniform)]
    _ape_close(*Lus)
    out = []
    for L0, Lu, solve, kw in zip(L0s, Lus, (nlevp_jax.mslp, nlevp.mslp),
                                 ({}, {"device": "cpu"})):
        s0 = solve(L0, 1j * np.pi * c * 1.03, maxiter=40, tol=1e-10,
                   **kw)[0].params["s"]
        s = solve(Lu, s0 * (1 - M ** 2), maxiter=60, tol=1e-10,
                  **kw)[0].params["s"]
        out.append((s0, s))
    (s0j, sj), (s0, s) = out
    assert abs(s0 - s0j) <= 1e-8 * abs(s0j) and abs(s - sj) <= 1e-8 * abs(sj)
    assert abs(s.imag / s0.imag - (1 - M ** 2)) < 5e-3
    assert abs(s.real) < 1e-3 * abs(s)
