"""The matrix-free panel solver (port ops/panel_solve) and its routes
through matfree_moments, beyn_batched and beyn, against the JAX package on
the CPU.  Twins of the seven tests of tests/test_panel_solve.py, with the
same numpy-seeded inputs: the 1-D gallery Rijke tube crosses over through
the JAX ``save_family`` and the port's ``load_family``; the octosplit
hierarchies are built in both packages.  Each test states its tolerance.

As a script, it holds the port's ShiftedPanelSolver at 55,401 DOF (the
multigrid hierarchy of path F of chip_smoke.py) against the JAX solver's X
for the first two contour nodes, written by
``tools/jax_references.py panel2 JAX.npz``:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_panel_solve.py JAX.npz
"""
import sys
import time

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from wavesandeigenvalues_jl_tpu.mesh.generate import \
    rijke_mesh as rijke_mesh_jax
from wavesandeigenvalues_jl_tpu.mesh.refine import octosplit as octosplit_jax
from wavesandeigenvalues_jl_tpu.mesh.refine import \
    p1_prolongation as p1_prolongation_jax
from wavesandeigenvalues_jl_tpu.models import discretize as discretize_jax
from wavesandeigenvalues_jl_tpu.nlevp import gallery
from wavesandeigenvalues_jl_tpu.nlevp import solvers as solvers_jax
from wavesandeigenvalues_jl_tpu.nlevp.persist import save_family
from wavesandeigenvalues_jl_tpu.ops import panel_solve as panel_jax
from wavesandeigenvalues_jl_tpu.parallel import dist_beyn as dist_beyn_jax
from wavesandeigenvalues_jl_tpu_torch.mesh.generate import box_mesh, rijke_mesh
from wavesandeigenvalues_jl_tpu_torch.mesh.refine import (octosplit,
                                                          p1_prolongation)
from wavesandeigenvalues_jl_tpu_torch.models import discretize
from wavesandeigenvalues_jl_tpu_torch.models.rijke import passive_rijke_setup
from wavesandeigenvalues_jl_tpu_torch.nlevp import load_family, solvers
from wavesandeigenvalues_jl_tpu_torch.ops.linsolve import factorize
from wavesandeigenvalues_jl_tpu_torch.ops.panel_solve import (
    CoarseGrid, MultiGrid, ShiftedPanelSolver, solve_shifted_panel)
from wavesandeigenvalues_jl_tpu_torch.ops.slab_solve import (SlabPartition,
                                                             SlabSolver)
from wavesandeigenvalues_jl_tpu_torch.parallel import (beyn_batched,
                                                       dist_beyn,
                                                       matfree_moments)

torch.set_num_threads(2)

#: the 1-D tube's contour around its first cluster (test_panel_solve.py:60)
GAMMA_1D = [0.5 - 0.5j, 2.5 - 0.5j, 2.5 + 1.0j, 0.5 + 1.0j]


@pytest.fixture(scope="module", autouse=True)
def few_blas_threads():
    """Two BLAS/OpenMP threads while this module runs (other test workers
    share the cores)."""
    with threadpool_limits(2):
        yield


@pytest.fixture(scope="module")
def rijke1d(tmp_path_factory):
    """(JAX gallery.rijke_tube(64), the port's copy through
    save_family/load_family)."""
    L, _grid = gallery.rijke_tube(64)
    path = str(tmp_path_factory.mktemp("panel") / "rijke64.npz")
    save_family(path, L)
    return L, load_family(path)


def _rhs(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _fld(m):
    return m.generate_field(lambda x, y, z: np.where(z < 0, 347.0, 694.0))


DS = {"Interior": ("interior", ()), "Outlet": ("admittance", ("Y", 1e15))}


def _hierarchy(n_rings, nz_cold, nz_hot, levels):
    """Per package ([families coarse → fine], [prolongations coarse →
    fine]) of ``levels`` octosplit levels above the generated mesh."""
    out = []
    for gen, octo, p1, disc in (
            (rijke_mesh_jax, octosplit_jax, p1_prolongation_jax,
             discretize_jax),
            (rijke_mesh, octosplit, p1_prolongation, discretize)):
        m = gen(n_rings=n_rings, nz_cold=nz_cold, nz_hot=nz_hot)
        fams, pros = [disc(m, DS, _fld(m))], []
        for _ in range(levels):
            pros.append(p1(m))
            m = octo(m)
            fams.append(disc(m, DS, _fld(m)))
        out.append((fams, pros))
    return out


def _same_arrays(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and np.array_equal(x, y)


def test_panel_solver_matches_direct(rijke1d):
    """Twin of test_panel_solve.py:23: GMRES panel solves at three shifts
    reach max relres < 1e-10 and the direct solve and the JAX solver's X
    to 1e-8 relative."""
    Lj, Lt = rijke1d
    V = _rhs((Lt.size, 3), 3)
    zs = np.array([0.8 + 0.2j, 1.5 - 0.1j, 2.2 + 0.4j])
    X, info = ShiftedPanelSolver(Lt, bs=16, refine_tol=1e-11,
                                 device="cpu").solve(zs, V)
    Xj, _ = panel_jax.ShiftedPanelSolver(Lj, bs=16,
                                         refine_tol=1e-11).solve(zs, V)
    assert info["max_relres"] < 1e-10 and info["unconverged"] == []
    for j, z in enumerate(zs):
        Xd = np.linalg.solve(Lt(complex(z)).to_dense(), V)
        assert _rel(X[j], Xd) < 1e-8
        assert _rel(X[j], Xj[j]) < 1e-8


def test_panel_solver_per_shift_rhs(rijke1d):
    """Twin of test_panel_solve.py:40: per-shift [S, n, l] right-hand
    sides; A X = B to 1e-8·‖B‖, max relres < 1e-10, JAX's X to 1e-8."""
    Lj, Lt = rijke1d
    B = _rhs((2, Lt.size, 2), 4)
    zs = np.array([1.0 + 0.3j, 1.8 - 0.2j])
    X, info = solve_shifted_panel(Lt, zs, B, bs=16, device="cpu")
    Xj, _ = panel_jax.solve_shifted_panel(Lj, zs, B, bs=16)
    assert info["max_relres"] < 1e-10
    for j, z in enumerate(zs):
        A = Lt(complex(z)).to_dense()
        assert np.allclose(A @ X[j], B[j], rtol=0,
                           atol=1e-8 * np.linalg.norm(B[j]))
        assert _rel(X[j], Xj[j]) < 1e-8


def test_matfree_beyn_matches_host(rijke1d):
    """Twin of test_panel_solve.py:56: beyn_batched through the panel
    GMRES gives JAX host Beyn's modes (the same count, each to 1e-8) and
    the JAX panel Beyn's, with eigenvector residuals < 1e-6."""
    Lj, Lt = rijke1d
    Om_h, _ = solvers_jax.beyn(Lj, GAMMA_1D, l=6, N=32, rtol=1e-12)
    Om_j, _ = dist_beyn_jax.beyn_batched(Lj, GAMMA_1D, l=6, N=32,
                                         rtol=1e-12, dense=False, bs=16)
    Om, P = beyn_batched(Lt, GAMMA_1D, l=6, N=32, rtol=1e-12, dense=False,
                         bs=16, device="cpu")
    assert len(Om) == len(Om_h) == len(Om_j)
    om = np.sort_complex(Om)
    assert np.max(np.abs(om - np.sort_complex(Om_h))) < 1e-8
    assert np.max(np.abs(om - np.sort_complex(Om_j))) < 1e-8
    for k in range(len(Om)):
        v = P[:, k] / np.linalg.norm(P[:, k])
        assert np.linalg.norm(Lt(complex(Om[k])).to_dense() @ v) < 1e-6


def test_two_grid_panel_solver():
    """Twin of test_panel_solve.py:75: the two-grid cycle (CoarseGrid on
    an octosplit pair) reaches max relres < 1e-10; X within 1e-8 of the
    direct solve and of JAX's X; the ELL transfer arrays equal JAX's."""
    (fj, pj), (ft, pt) = _hierarchy(2, 8, 8, 1)
    assert pt[0][3] == (ft[1].size, ft[0].size)
    cg, cgj = CoarseGrid(ft[0], pt[0]), panel_jax.CoarseGrid(fj[0], pj[0])
    _same_arrays((cg.pell_cols, cg.pell_vals, cg.ptell_cols, cg.ptell_vals,
                  cg.crows, cg.ccols),
                 (cgj.pell_cols, cgj.pell_vals, cgj.ptell_cols,
                  cgj.ptell_vals, cgj.crows, cgj.ccols))
    d = ft[1].size
    V = np.zeros((d, 2), np.complex128)
    V[0, 0] = V[1, 1] = 1.0
    zs = 2 * np.pi * np.array([250 + 5j, 600 + 5j])
    kw = dict(bs=64, restart=30, max_restarts=10)
    X, info = ShiftedPanelSolver(ft[1], coarse=cg, device="cpu",
                                 **kw).solve(zs, V)
    Xj, _ = panel_jax.ShiftedPanelSolver(fj[1], coarse=cgj, **kw).solve(zs,
                                                                         V)
    assert info["max_relres"] < 1e-10
    for j, z in enumerate(zs):
        Xd = factorize(ft[1](complex(z)), backend="host").solve(V)
        assert _rel(X[j], Xd) < 1e-8
        assert _rel(X[j], Xj[j]) < 1e-8


def test_matfree_moments_match_host_quadrature(rijke1d):
    """Twin of test_panel_solve.py:109: the panel moments agree with the
    host loop and with JAX's panel moments to 1e-9 relative."""
    Lj, Lt = rijke1d
    V = solvers.initialize_V(Lt.size, 4)
    A_host = solvers.compute_moment_matrices(Lt, GAMMA_1D, V, K=2, N=12)
    A_mf, info = matfree_moments(Lt, GAMMA_1D, V=V, K=2, N=12, bs=16,
                                 device="cpu")
    A_j, _ = dist_beyn_jax.matfree_moments(Lj, GAMMA_1D, V=V, K=2, N=12,
                                           bs=16)
    assert info["max_relres"] < 1e-9 and info["unconverged"] == []
    assert _rel(A_mf, A_host) < 1e-9
    assert _rel(A_mf, A_j) < 1e-9


def test_matfree_moments_checkpoint_resume(rijke1d, tmp_path):
    """Twin of test_panel_solve.py:122: grouped panel moments with a
    checkpoint equal the uninterrupted ones (rtol 1e-10); a run resumed
    from doctored partial sums differs; a changed parameter invalidates
    the checkpoint."""
    _, L = rijke1d
    V = solvers.initialize_V(L.size, 3)
    ck = str(tmp_path / "mf.npz")
    kw = dict(V=V, K=1, N=8, bs=16, device="cpu")
    A_full, _ = matfree_moments(L, GAMMA_1D, **kw)
    A_ck, _ = matfree_moments(L, GAMMA_1D, group=10, checkpoint=ck, **kw)
    assert np.allclose(A_ck, A_full, rtol=1e-10)
    with np.load(ck) as d:
        A_mid, digest = d["A"], str(d["digest"])
    np.savez(ck, A=A_mid * 0, next=32, digest=digest)  # wrong partial sums
    A_res, _ = matfree_moments(L, GAMMA_1D, group=10, checkpoint=ck, **kw)
    assert not np.allclose(A_res, A_full)     # resumed from doctored state
    L.params["τ"] = L.params["τ"] * 1.001
    A_new, _ = matfree_moments(L, GAMMA_1D, group=10, checkpoint=ck, **kw)
    L.params["τ"] = L.params["τ"] / 1.001
    A_ref, _ = matfree_moments(L, GAMMA_1D, **kw)
    assert not np.allclose(A_new, A_ref)


def test_multigrid_panel_solver():
    """Twin of test_panel_solve.py:150: the 3-level V-cycle reaches max
    relres < 1e-10; X within 1e-8 of the direct solve and of JAX's X; the
    MultiGrid ELL arrays (levels and transfers) equal JAX's."""
    (fj, pj), (ft, pt) = _hierarchy(1, 5, 5, 2)
    mg = MultiGrid([ft[1], ft[0]], [pt[1], pt[0]], bs=32)
    mgj = panel_jax.MultiGrid([fj[1], fj[0]], [pj[1], pj[0]], bs=32)
    assert (mg.n_fine, mg.n_coarse) == (mgj.n_fine, mgj.n_coarse)
    for a, b in zip(mg.xfers, mgj.xfers):
        _same_arrays(a, b)
    for a, b in zip(mg.levels, mgj.levels):
        _same_arrays(a[1:5], b[1:5])
        assert np.array_equal(a[0], b[0]) and a[5] == b[5]
    _same_arrays((mg.values, mg.crows, mg.ccols),
                 (mgj.values, mgj.crows, mgj.ccols))
    d = ft[2].size
    V = np.zeros((d, 2), np.complex128)
    V[0, 0] = V[1, 1] = 1.0
    zs = 2 * np.pi * np.array([250 + 5j, 600 + 5j])
    kw = dict(bs=64, restart=20, max_restarts=5)
    solver = ShiftedPanelSolver(ft[2], coarse=mg, device="cpu", **kw)
    X, info = solver.solve(zs, V)
    Xj, _ = panel_jax.ShiftedPanelSolver(fj[2], coarse=mgj,
                                              **kw).solve(zs, V)
    assert info["max_relres"] < 1e-10
    for j, z in enumerate(zs):
        Xd = factorize(ft[2](complex(z)), backend="host").solve(V)
        assert _rel(X[j], Xd) < 1e-8
        assert _rel(X[j], Xj[j]) < 1e-8


def test_routing_to_panel_solver(rijke1d):
    """"auto" with a GMRES keyword, and "auto" on an unfavourable slab
    partition (a 125-DOF box, m = 6 < 8 slabs), build a
    ShiftedPanelSolver, as in the JAX package; "slab" and a favourable
    "auto" a SlabSolver.  The box's panel moments equal the host
    quadrature's to 1e-9."""
    _, Lt = rijke1d
    make = dist_beyn._make_matfree_solver
    assert isinstance(make(Lt, "auto", {"restart": 30}, "cpu"),
                      ShiftedPanelSolver)
    assert isinstance(make(Lt, "gmres", {}, "cpu"), ShiftedPanelSolver)
    m = box_mesh(nx=4, ny=4, nz=4)
    c = m.generate_field(lambda x, y, z: 340.0 + 0 * x, order="lin")
    Lb = discretize(m, {"Interior": ("interior", ()),
                        "Xmax": ("admittance", ("Y", 1e15))}, c)
    solver = make(Lb, "auto", {}, "cpu")
    assert isinstance(solver, ShiftedPanelSolver)
    S = Lb._stack()
    assert SlabPartition(S.indptr, S.indices, Lb.size).m == 6
    assert isinstance(make(Lb, "slab", {}, "cpu"), SlabSolver)
    mr = rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
    Lr = discretize(mr, *passive_rijke_setup(mr))
    assert isinstance(make(Lr, "auto", {}, "cpu"), SlabSolver)
    Gb = [2 * np.pi * (100 - 20j), 2 * np.pi * (300 - 20j),
          2 * np.pi * (300 + 20j), 2 * np.pi * (100 + 20j)]
    V = solvers.initialize_V(Lb.size, 3)
    A_mf, info = matfree_moments(Lb, Gb, V=V, K=1, N=4, device="cpu")
    A_host = solvers.compute_moment_matrices(Lb, Gb, V, K=1, N=4)
    assert info["max_relres"] < 1e-9
    assert _rel(A_mf, A_host) < 1e-9


def test_beyn_gmres_matches_jax(rijke1d):
    """beyn(backend="gmres") against the JAX package's beyn(backend=
    "gmres") and JAX host Beyn on the 1-D tube with the flame on (the leg
    of tests/test_slab_solve.py:120-131 on 64 points): the same count,
    modes within 1e-8 of both."""
    Lj, Lt = rijke1d
    Gg = [0.2 - 1j, 4.0 - 1j, 4.0 + 1j, 0.2 + 1j]
    kw = dict(l=8, N=48, rtol=1e-12, res_tol=1e-8)
    gk = dict(bs=16, tol=1e-10, restart=60, max_restarts=20)
    saved = (Lj.params["n"], Lj.params["τ"], Lt.params["n"], Lt.params["τ"])
    try:
        Lj.params["n"], Lj.params["τ"] = 1.0, 0.5
        Lt.params["n"], Lt.params["τ"] = 1.0, 0.5
        Om_h, _ = solvers_jax.beyn(Lj, Gg, backend="host", **kw)
        Om_j, _ = solvers_jax.beyn(Lj, Gg, backend="gmres", **kw, **gk)
        Om, _, info = solvers.beyn(Lt, Gg, backend="gmres", device="cpu",
                                   return_info=True, **kw, **gk)
    finally:
        Lj.params["n"], Lj.params["τ"], Lt.params["n"], Lt.params["τ"] = \
            saved
    assert len(Om) == len(Om_h) == len(Om_j) >= 1
    assert info["unconverged"] == [] and info["max_relres"] < 1e-10
    om = np.sort_complex(Om)
    assert np.max(np.abs(om - np.sort_complex(Om_h))) < 1e-8
    assert np.max(np.abs(om - np.sort_complex(Om_j))) < 1e-8


def compare_55k(jax_npz):
    """The port's ShiftedPanelSolver with path F's MultiGrid at 55,401 DOF
    on the CPU, on the JAX solver's two shifts and l = 8 probe block:
    prints its relres, restarts, timings and X against the JAX X."""
    ref = np.load(jax_npz)
    meshes = [rijke_mesh(n_rings=3, nz_cold=12, nz_hot=12)]
    for _ in range(2):
        meshes.append(octosplit(meshes[-1]))
    L0, L1, L2 = (discretize(m, *passive_rijke_setup(m)) for m in meshes)
    mg = MultiGrid([L1, L0], [p1_prolongation(m) for m in meshes[1::-1]],
                   bs=64)
    V = solvers.initialize_V(L2.size, 8)
    solver = ShiftedPanelSolver(L2, coarse=mg, device="cpu")
    t0 = time.perf_counter()
    X, info = solver.solve(ref["zs"], V, output=True)
    rel = [_rel(X[j], ref["X"][j]) for j in range(len(ref["zs"]))]
    print(f"n={L2.size}: {time.perf_counter() - t0:.1f} s | max relres "
          f"{info['max_relres']:.3e} (JAX {ref['relres'].max():.3e}) | "
          f"restarts a solve {info['restarts_per_solve']:.3f} (JAX "
          f"{float(ref['restarts']):.3f}) | timings {info['timings']} | X "
          f"against JAX's, relative: {rel}")


if __name__ == "__main__":
    with threadpool_limits(4):
        compare_55k(sys.argv[1])
