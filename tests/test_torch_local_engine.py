"""The port's general local engine against the JAX package's, on the CPU:
the gallery, Householder of any order, Padé updates, the classic
iterations, perturbation theory, the hybrid ``solve`` and the
fused→general fallback.  Twins of tests/test_nlevp_core.py:45,55,96,103,
169,176,203, tests/test_legacy_solvers.py and
tests/test_device_backend.py:75,94,108,170; the "device" backends run
``DeviceLU`` / ``DeviceGMRES`` on CPU tensors (complex128, as JAX's off a
TPU).  Each test runs both packages on the same inputs and states its
tolerance."""
import numpy as np
import pytest

import wavesandeigenvalues_jl_tpu.nlevp as nlevp_jax
import wavesandeigenvalues_jl_tpu.nlevp.fused_local as fused_local_jax
import wavesandeigenvalues_jl_tpu.utils.config as config_jax
import wavesandeigenvalues_jl_tpu_torch.nlevp as nlevp
from wavesandeigenvalues_jl_tpu.mesh.generate import \
    rijke_mesh as rijke_mesh_jax
from wavesandeigenvalues_jl_tpu.models import discretize as discretize_jax
from wavesandeigenvalues_jl_tpu_torch.models.rijke import (
    active_rijke_family, active_rijke_setup)
from wavesandeigenvalues_jl_tpu_torch.nlevp.pencil import PencilSolver
from wavesandeigenvalues_jl_tpu_torch.utils import config

from port_threads import one_thread  # noqa: F401


Z0 = 340 * 2 * np.pi
CLASSIC = ("inveriter", "lancaster", "rf2s", "traceiter", "mehrmann",
           "juniper", "guettel")


class backend:
    """Both packages' session solve backend set to ``name`` inside."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.prev = (config.set_solve_backend(self.name),
                     config_jax.set_solve_backend(self.name))

    def __exit__(self, *exc):
        config.set_solve_backend(self.prev[0])
        config_jax.set_solve_backend(self.prev[1])


def _eig(sol):
    return sol.params[sol.eigval]


@pytest.mark.parametrize("name", ["qep3", "rijke_tube", "orr_sommerfeld",
                                  "biharmonic"])
def test_gallery_matches_jax(name):
    """Each gallery family term for term (matrix, coefficient functions,
    parameter names) and its grids equal JAX's exactly, and L(z) with its
    first derivative at a test point too."""
    args = {"qep3": (), "rijke_tube": (48,), "orr_sommerfeld": (24,),
            "biharmonic": (8,)}[name]
    out = getattr(nlevp.gallery, name)(*args)
    out_j = getattr(nlevp_jax.gallery, name)(*args)
    if name == "qep3":
        out, out_j = (out,), (out_j,)
    L, Lj = out[0], out_j[0]
    for grid, grid_j in zip(out[1:], out_j[1:]):
        np.testing.assert_array_equal(grid, grid_j)
    assert L.params.keys() == Lj.params.keys()
    assert len(L.terms) == len(Lj.terms)
    for t, tj in zip(L.terms, Lj.terms):
        assert (t.symbol, t.operator, t.params) == \
            (tj.symbol, tj.operator, tj.params)
        assert t.signature()[0] == tj.signature()[0]
        np.testing.assert_array_equal(t.coeff.to_dense(),
                                      tj.coeff.to_dense())
    z = 1.1 + 0.2j
    for k in (0, 1):
        np.testing.assert_array_equal(L(z, k).to_dense(),
                                      Lj(z, k).to_dense())


@pytest.mark.parametrize("be", ["host", "device"])
def test_householder_orders_qep(be):
    """Householder of orders 1–5 (orders 2–5 on "device": order 1 there is
    the fused engine) and mslp on the QEP (tests/test_nlevp_core.py:45,55):
    the same eigenvalue to 1e-10, iteration count and flag as JAX on the
    same backend; on "host" mslp and order 1 find 1/3 in ≤ 8 iterations
    with flag 0, and every order lands on a point of the spectrum or
    reports a flag."""
    orders = range(1, 6) if be == "host" else range(2, 6)
    spectrum = np.array([1j, -1j, 1 / 3, 0.5, 1.0])
    with backend(be):
        for order in orders:
            sol, n, flag = nlevp.householder(nlevp.gallery.qep3(), 0.0,
                                             tol=1e-10, maxiter=10,
                                             order=order, device="cpu")
            sol_j, n_j, flag_j = nlevp_jax.householder(
                nlevp_jax.gallery.qep3(), 0.0, tol=1e-10, maxiter=10,
                order=order)
            assert (n, flag) == (n_j, flag_j), order
            assert abs(_eig(sol) - _eig(sol_j)) < 1e-10, order
            if order <= 2 and be == "host":
                assert np.min(np.abs(spectrum - _eig(sol))) < 1e-9
        if be == "host":
            sol, n, flag = nlevp.mslp(nlevp.gallery.qep3(), 0.0, tol=1e-10,
                                      maxiter=10, device="cpu")
            assert abs(_eig(sol) - 1 / 3) < 1e-10 and flag == 0 and n <= 8


@pytest.mark.parametrize("be", ["host", "device"])
def test_classic_iterations_qep(be):
    """inveriter, lancaster, rf2s, traceiter and the aliases mehrmann,
    juniper, guettel on the QEP from 0.3 (tests/test_nlevp_core.py:96):
    within 1e-8 of 1/3, and the same flag and eigenvalue (to 1e-10) as
    JAX on the same backend."""
    with backend(be):
        for name in CLASSIC:
            sol, n, flag = getattr(nlevp, name)(
                nlevp.gallery.qep3(), 0.3, maxiter=30, tol=1e-12,
                device="cpu")
            sol_j, n_j, flag_j = getattr(nlevp_jax, name)(
                nlevp_jax.gallery.qep3(), 0.3, maxiter=30, tol=1e-12)
            assert abs(_eig(sol) - 1 / 3) < 1e-8, name
            assert flag == flag_j, name
            assert abs(_eig(sol) - _eig(sol_j)) < 1e-10, name
    assert sol.v_adj is not None or name != "mehrmann"


@pytest.mark.parametrize("be", ["host", "device"])
def test_several_eigenvalues_and_pade_orders(be):
    """nev > 1 (householder order 1 and 2 with nev = 2: the host Arnoldi
    loop over the backend's factorization) and Padé updates of order
    3 over 2 (padesolve) on the 48-point tube: the same flag, iteration
    count and eigenvalue (1e-12) as JAX on the same backend."""
    cases = [("householder", dict(order=2, nev=2)),
             ("householder", dict(order=1, nev=2)),
             ("padesolve", dict(order=3, num_order=2))]
    with backend(be):
        for name, kw in cases:
            sol, n, flag = getattr(nlevp, name)(
                nlevp.gallery.rijke_tube(48)[0], 1 + 0.3j, tol=1e-11,
                maxiter=30, device="cpu", **kw)
            sol_j, n_j, flag_j = getattr(nlevp_jax, name)(
                nlevp_jax.gallery.rijke_tube(48)[0], 1 + 0.3j, tol=1e-11,
                maxiter=30, **kw)
            assert (flag, n) == (flag_j, n_j) and flag == 0, (name, kw)
            assert abs(_eig(sol) - _eig(sol_j)) < 1e-12, (name, kw)


@pytest.fixture(scope="module")
def rijke96():
    """The legacy solvers' fixture (tests/test_legacy_solvers.py:10-15):
    the 96-point gallery tube and JAX's host mslp eigenvalue."""
    sol, _, flag = nlevp_jax.mslp(nlevp_jax.gallery.rijke_tube(96)[0],
                                  1.0 + 0.3j, maxiter=30, tol=1e-12)
    assert flag in (0, 2)
    return nlevp.gallery.rijke_tube(96)[0], _eig(sol)


@pytest.mark.parametrize("solver", ["padesolve", "nicoud", "picard"])
def test_legacy_solvers(rijke96, solver):
    """padesolve (order 2 over order 1), nicoud and picard (relax 0.5 from
    1.02·ω) on the "device" backend against JAX host mslp, with the JAX
    test's bars: 1e-8 absolute, 1e-7·|ω| and 1e-6·|ω|."""
    L, om_ref = rijke96
    if solver == "padesolve":
        sol, n, flag = nlevp.padesolve(L, 1.0 + 0.3j, maxiter=30, tol=1e-11,
                                       order=2, num_order=1, device="cpu")
        assert flag in (0, 2) and abs(_eig(sol) - om_ref) < 1e-8
        return
    sol, n, flag = getattr(nlevp, solver)(L, om_ref * 1.02, maxiter=80,
                                          tol=1e-10, relax=0.5, device="cpu")
    bar = 1e-7 if solver == "nicoud" else 1e-6
    assert flag >= 0 and abs(_eig(sol) - om_ref) < bar * abs(om_ref)


def test_perturb_norm_matches_perturb(rijke96):
    """The Y-weighted series gives the eigenvalue trajectory of the plain
    one (tests/test_legacy_solvers.py:47) to 1e-8, and both equal JAX's
    host coefficients to 1e-8 relative (the port's series on "device",
    from host mslp eigenpairs in both packages)."""
    L, om_ref = rijke96
    Lj = nlevp_jax.gallery.rijke_tube(96)[0]
    coeffs = {}
    for fn in ("perturb_fast", "perturb_norm"):
        with backend("host"):
            sol, _, _ = nlevp.mslp(L, om_ref, maxiter=10, tol=1e-12,
                                   device="cpu")
            sol_j, _, _ = nlevp_jax.mslp(Lj, om_ref, maxiter=10, tol=1e-12)
        getattr(nlevp, fn)(sol, L, "τ", 6, device="cpu")
        getattr(nlevp_jax, fn)(sol_j, Lj, "τ", 6)
        c, cj = sol.eigval_pert["τ/Taylor"], sol_j.eigval_pert["τ/Taylor"]
        np.testing.assert_allclose(c[1:], cj[1:], rtol=1e-8)
        coeffs[fn] = c
    dtau = 0.005
    f = nlevp.polyval(coeffs["perturb_fast"], dtau)
    assert abs(f - nlevp.polyval(coeffs["perturb_norm"], dtau)) < 1e-8 * abs(f)


@pytest.mark.parametrize("case", ["device_vs_host", "device_gmres"])
def test_mslp_device_backends_gallery(case):
    """tests/test_device_backend.py:75,94: the port's mslp on "device"
    (n = 1, τ = 0.5, 60 points) and on "device_gmres" (40 points) gives
    JAX's host eigenvalue to 1e-9 / 1e-8, the bars of those tests (which
    hold JAX's device runs to the same values).  Order-1 mslp takes the
    fused engine on either backend, in both packages."""
    pts, bar, be = ((60, 1e-9, "device") if case == "device_vs_host"
                    else (40, 1e-8, "device_gmres"))
    kw = dict(tol=1e-12 if pts == 60 else 1e-11, maxiter=30)

    def family(g):
        L, _ = g.rijke_tube(pts)
        if pts == 60:
            L.params["n"], L.params["τ"] = 1.0, 0.5
        return L

    with backend("host"):
        sol_h, _, flag_h = nlevp_jax.mslp(family(nlevp_jax.gallery),
                                          1 + 0.3j, **kw)
    with backend(be):
        sol, _, flag = nlevp.mslp(family(nlevp.gallery), 1 + 0.3j,
                                  device="cpu", **kw)
    assert flag >= 0 and flag_h >= 0
    assert abs(_eig(sol) - _eig(sol_h)) < bar


def test_perturb_device_backend_gallery():
    """tests/test_device_backend.py:108: the τ series to order 6 with L(0,0)
    factored on "device" equals the host series to 1e-7 relative, in the
    port and against JAX's host series."""
    L, _ = nlevp.gallery.rijke_tube(48)
    L.params["n"], L.params["τ"] = 1.0, 0.4
    with backend("host"):
        sol, _, flag = nlevp.mslp(L, 1.0 + 0.3j, tol=1e-12, maxiter=30,
                                  device="cpu")
        nlevp.perturb_fast(sol, L, "τ", 6, device="cpu")
        host = np.asarray(sol.eigval_pert["τ/Taylor"]).copy()
    assert flag >= 0
    Lj, _ = nlevp_jax.gallery.rijke_tube(48)
    Lj.params["n"], Lj.params["τ"] = 1.0, 0.4
    sol_j, _, _ = nlevp_jax.mslp(Lj, 1.0 + 0.3j, tol=1e-12, maxiter=30)
    nlevp_jax.perturb_fast(sol_j, Lj, "τ", 6)
    sol.eigval_pert.clear()
    nlevp.perturb_fast(sol, L, "τ", 6, device="cpu")
    dev = np.asarray(sol.eigval_pert["τ/Taylor"])
    for ref in (host, np.asarray(sol_j.eigval_pert["τ/Taylor"])):
        assert np.all(np.abs(dev - ref)
                      <= 1e-7 * np.maximum(np.abs(ref), 1e-30))


@pytest.mark.parametrize("be", ["host", "device"])
def test_stall_rule(be):
    """tests/test_device_backend.py:170: with tol = 0 the general engine
    stops at its attainable-accuracy floor (flag ≥ 0, fewer than 60
    iterations) on both backends (householder order 2: the general engine
    on "device" too), in both packages, at JAX's eigenvalue (1e-10).  The
    step at which the floor is met follows the rounding, so the counts are
    not compared."""
    def family(g):
        L, _ = g.rijke_tube(60)
        L.params["n"], L.params["τ"] = 1.0, 0.5
        return L

    with backend(be):
        sol, n, flag = nlevp.householder(family(nlevp.gallery), 1.0 + 0.3j,
                                         tol=0.0, maxiter=60, order=2,
                                         device="cpu")
        sol_j, n_j, flag_j = nlevp_jax.householder(
            family(nlevp_jax.gallery), 1.0 + 0.3j, tol=0.0, maxiter=60,
            order=2)
    assert flag >= 0 and n < 60 and flag_j >= 0 and n_j < 60
    assert abs(_eig(sol) - _eig(sol_j)) < 1e-10


def test_rijke_1d_and_biharmonic():
    """tests/test_nlevp_core.py:103,169,176: mslp on the 1-D Rijke tube
    ("host", as that test) and the biharmonic membrane (householder
    order 2 on "device"):
    eigenpair residuals below 1e-8 and 1e-6, eigenvalues equal to JAX's
    to 1e-9 relative; the Orr-Sommerfeld family assembles finite."""
    with backend("host"):
        sol, _, flag = nlevp.mslp(nlevp.gallery.rijke_tube(64)[0],
                                  1.0 + 0.3j, tol=1e-11, maxiter=30,
                                  device="cpu")
    L = nlevp.gallery.rijke_tube(64)[0]
    assert flag in (0, 2)
    assert (np.linalg.norm(L(_eig(sol)).to_dense() @ sol.v)
            / np.linalg.norm(sol.v)) < 1e-8
    L, _, _ = nlevp.gallery.biharmonic(8)
    sol_b, _, _ = nlevp.householder(L, 100.0, tol=1e-8, maxiter=30, order=2,
                                    device="cpu")
    assert (np.linalg.norm(L(_eig(sol_b)).to_dense() @ sol_b.v)
            / np.linalg.norm(sol_b.v)) < 1e-6
    with backend("host"):
        sol_j, _, _ = nlevp_jax.mslp(nlevp_jax.gallery.rijke_tube(64)[0],
                                     1.0 + 0.3j, tol=1e-11, maxiter=30)
    sol_bj, _, _ = nlevp_jax.householder(nlevp_jax.gallery.biharmonic(8)[0],
                                         100.0, tol=1e-8, maxiter=30,
                                         order=2)
    for s, sj in ((sol, sol_j), (sol_b, sol_bj)):
        assert abs(_eig(s) - _eig(sj)) <= 1e-9 * abs(_eig(sj))
    A = nlevp.gallery.orr_sommerfeld(24)[0](1.0 + 0.1j).to_dense()
    assert A.shape == (24, 24) and np.isfinite(A).all()


def test_hybrid_solve_qep():
    """tests/test_nlevp_core.py:203: the hybrid solve (host quadrature,
    householder(order=3) on "device") finds 1/3, 1/2 and 1 inside the
    square, each a true eigenvalue (σ_min < 1e-7), as JAX's does; the
    eigenvalues inside equal JAX's to 1e-8."""
    Gamma = [-2 - 2j, 2 - 2j, 2 + 2j, -2 + 2j]
    kw = dict(dl=2, N=64, tol=1e-9, maxcycles=6, max_outer_cycles=3)
    ev = nlevp.solve(nlevp.gallery.qep3(), Gamma, backend="host",
                     device="cpu", **kw)
    ev_j = nlevp_jax.solve(nlevp_jax.gallery.qep3(), Gamma, **kw)
    inside = sorted((k for k, (s, f) in ev.items() if f), key=abs)
    inside_j = sorted((k for k, (s, f) in ev_j.items() if f), key=abs)
    for target in (1 / 3, 0.5, 1.0):
        assert any(abs(om - target) < 1e-8 for om in inside), target
    T = nlevp.gallery.qep3()
    for om in inside:
        assert np.linalg.svd(T(om).to_dense(), compute_uv=False)[-1] < 1e-7
    assert len(inside) == len(inside_j)
    assert all(abs(a - b) < 1e-8 for a, b in zip(inside, inside_j))


def test_generate_subspace_matches_jax():
    """The residual-controlled subspace of tests/test_nlevp_core.py:185 on
    the 48-point tube (solves on "device"): as many columns as JAX's, the
    same subspace (projector difference below 1e-6), a residual at every
    sample JAX has one, each below 10·tol (JAX's last one is 1.1e-10 at
    tol 1e-10)."""
    Z = [1.0 + 1.0j + 0.3 * np.exp(2j * np.pi * k / 6) for k in range(6)]
    L = nlevp.gallery.rijke_tube(48)[0]
    Y = np.zeros((L.size, 2), complex)
    Y[0, 0] = Y[1, 1] = 1.0
    Q, res = nlevp.generate_subspace(L, Y, 1e-10, Z, device="cpu")
    Qj, res_j = nlevp_jax.generate_subspace(
        nlevp_jax.gallery.rijke_tube(48)[0], Y, 1e-10, Z)
    assert Q.shape == Qj.shape and Q.shape[1] < L.size
    assert np.linalg.norm(Q @ Q.conj().T - Qj @ Qj.conj().T) < 1e-6
    assert len(res) == len(res_j) and np.all(res <= 1e-9)


@pytest.fixture(scope="module")
def jax_437():
    """JAX host householder(order=3) and its order-8 n series on the
    437-DOF active family."""
    mesh = rijke_mesh_jax(n_rings=2, nz_cold=10, nz_hot=10)
    Lj = discretize_jax(mesh, *active_rijke_setup(mesh))
    sol, n, flag = nlevp_jax.householder(Lj, Z0, maxiter=12, tol=1e-9,
                                         order=3)
    nlevp_jax.perturb(sol, Lj, "n", 8)
    return sol, n, flag


@pytest.mark.parametrize("be", ["host", "device"])
def test_householder_order3_active_437(jax_437, be):
    """householder(order=3) on the 437-DOF active Rijke family on "host"
    (scipy) and "device" (DeviceLU on CPU tensors): flag and iterations
    as JAX host, ω within 1e-10·|ω|; perturb(…, "n", 8): c₁…c₈ within
    1e-8 relative of JAX host's."""
    sol_j, n_j, flag_j = jax_437
    L = active_rijke_family()
    with backend(be):
        sol, n, flag = nlevp.householder(L, Z0, maxiter=12, tol=1e-9,
                                         order=3, device="cpu")
        nlevp.perturb(sol, L, "n", 8, device="cpu")
    om, om_j = _eig(sol), _eig(sol_j)
    assert (flag, n) == (flag_j, n_j) == (0, 4)
    assert abs(om - om_j) <= 1e-10 * abs(om_j)
    np.testing.assert_allclose(sol.eigval_pert["n/Taylor"][1:],
                               sol_j.eigval_pert["n/Taylor"][1:], rtol=1e-8)


def _nan_step(self, z, carries, sigma, refresh):
    return complex("nan"), complex("nan"), carries, np.zeros(2)


def test_fused_falls_back_to_general_engine(monkeypatch):
    """A non-finite device dz: both packages hand the iteration to their
    general engine (mslp on "device", the dense fused engine of the
    437-DOF family with its step patched to give dz = nan): the same flag
    and ω within 1e-8·|ω|; the port warns, naming the step."""
    monkeypatch.setattr(fused_local_jax.FusedPencilSolver, "step", _nan_step)
    monkeypatch.setattr(PencilSolver, "step", _nan_step)
    mesh = rijke_mesh_jax(n_rings=2, nz_cold=10, nz_hot=10)
    Lj = discretize_jax(mesh, *active_rijke_setup(mesh))
    with backend("device"):
        sol_j, n_j, flag_j = nlevp_jax.mslp(Lj, Z0, maxiter=30, tol=1e-11)
        with pytest.warns(RuntimeWarning, match="fused device step 0"):
            sol, n, flag = nlevp.mslp(active_rijke_family(), Z0, maxiter=30,
                                      tol=1e-11, device="cpu")
    assert flag == flag_j == 0
    assert abs(_eig(sol) - _eig(sol_j)) <= 1e-8 * abs(_eig(sol_j))


def test_fused_engine_error_still_raises(monkeypatch):
    """Only a non-finite dz falls back: an error inside the device step (a
    kernel that fails to build or launch) propagates out of mslp."""
    def failing(self, *args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(PencilSolver, "step", failing)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        nlevp.mslp(active_rijke_family(), Z0, maxiter=30, tol=1e-11,
                   device="cpu")
