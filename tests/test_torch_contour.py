"""The contour slice: Beyn's solver (port nlevp/solvers.beyn), the slab
direct solver (port ops/slab_solve.SlabSolver), the routes to the panel
GMRES (port ops/panel_solve) and the device-batched quadrature (port
parallel/dist_beyn) against the JAX package on the CPU.

The mesh operator is the passive Rijke family on the generated
``rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)`` (n = 437), built in both
packages; the gallery QEP crosses over through the JAX ``save_family`` and
the port's ``load_family``.  Twins of tests/test_slab_solve.py (whose
fixture reads an absent mesh) and of the Beyn tests of
tests/test_nlevp_core.py."""
import sys
import warnings

import numpy as np
import pytest
import scipy.sparse.linalg as spl
from threadpoolctl import threadpool_limits

from wavesandeigenvalues_jl_tpu.mesh.generate import \
    rijke_mesh as rijke_mesh_jax
from wavesandeigenvalues_jl_tpu.models import discretize as discretize_jax
from wavesandeigenvalues_jl_tpu.nlevp import gallery
from wavesandeigenvalues_jl_tpu.nlevp import solvers as solvers_jax
from wavesandeigenvalues_jl_tpu.nlevp.persist import save_family
from wavesandeigenvalues_jl_tpu.ops import slab_solve as slab_solve_jax
from wavesandeigenvalues_jl_tpu.ops.slab_solve import \
    SlabPartition as SlabPartitionJax
from wavesandeigenvalues_jl_tpu.ops.slab_solve import \
    SlabSolver as SlabSolverJax
from wavesandeigenvalues_jl_tpu.parallel.dist_beyn import \
    matfree_moments as matfree_moments_jax
from wavesandeigenvalues_jl_tpu_torch.mesh.generate import rijke_mesh
from wavesandeigenvalues_jl_tpu_torch.models import discretize
from wavesandeigenvalues_jl_tpu_torch.models.rijke import passive_rijke_setup
from wavesandeigenvalues_jl_tpu_torch.nlevp import load_family
from wavesandeigenvalues_jl_tpu_torch.nlevp import solvers
from wavesandeigenvalues_jl_tpu_torch.ops import panel_solve, slab_solve
from wavesandeigenvalues_jl_tpu_torch.ops.slab_solve import (SlabPartition,
                                                             SlabSolver)
from wavesandeigenvalues_jl_tpu_torch.parallel import (beyn_batched,
                                                       matfree_moments)

from port_threads import one_thread  # noqa: F401

#: the contour of tests/test_slab_solve.py:86-88: 150–1000 Hz at ±5 Hz
GAMMA = [2 * np.pi * (150 - 5j), 2 * np.pi * (1000 - 5j),
         2 * np.pi * (1000 + 5j), 2 * np.pi * (150 + 5j)]
BEYN_KW = dict(l=8, N=24, rtol=1e-12, res_tol=1e-6)
#: the QEP's square and its five eigenvalues inside (tutorial_00)
GAMMA_QEP = [-2 - 2j, 2 - 2j, 2 + 2j, -2 + 2j]
QEP_INSIDE = (1j, -1j, 1.0, 0.5, 1.0 / 3.0)


def _families(n_rings=2, nz_cold=10, nz_hot=10):
    """(JAX family, port family): the same passive Rijke operator."""
    mj = rijke_mesh_jax(n_rings=n_rings, nz_cold=nz_cold, nz_hot=nz_hot)
    mt = rijke_mesh(n_rings=n_rings, nz_cold=nz_cold, nz_hot=nz_hot)
    return (discretize_jax(mj, *passive_rijke_setup(mj)),
            discretize(mt, *passive_rijke_setup(mt)))


@pytest.fixture(scope="module")
def families():
    return _families()


@pytest.fixture(scope="module")
def host_pairs(families):
    """The eigenpairs of JAX host Beyn (serial LAPACK LU per node)."""
    Om, P = solvers_jax.beyn(families[0], GAMMA, backend="host", **BEYN_KW)
    assert len(Om) == 2
    return Om, P


@pytest.fixture
def qep(tmp_path):
    """(JAX gallery.qep3, the port's copy through save_family/load_family)."""
    T = gallery.qep3()
    path = str(tmp_path / "qep3.npz")
    save_family(path, T)
    return T, load_family(path)


def _rhs(n, cols, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cols)) + 1j * rng.standard_normal((n, cols))


def test_partition_edge_property(families):
    """Every union-pattern entry connects slabs differing by ≤ 1 (block
    tridiagonal), and the port's partition is the JAX package's."""
    S = families[1]._stack()
    part = SlabPartition(S.indptr, S.indices, int(S.shape[0]))
    si, d, rl, cl = part.entry_destinations(np.asarray(S.row_ids()),
                                            np.asarray(S.indices))
    assert d.min() >= 0 and d.max() <= 2
    assert (rl < part.sizes[si]).all() and (cl < part.smax).all()
    assert np.bincount(part.slab_of_new, minlength=part.m).max() == part.smax
    Sj = families[0]._stack()
    pj = SlabPartitionJax(Sj.indptr, Sj.indices, int(Sj.shape[0]))
    assert np.array_equal(part.perm, pj.perm)
    assert np.array_equal(part.sizes, pj.sizes)


def test_slab_solver_matches_sparse_lu_and_jax(families):
    """Port SlabSolver (complex64 factorization on the CPU, complex128
    refinement): max relres < 1e-10; against scipy spsolve and the JAX
    SlabSolver on the same input, 1e-8 relative; the same factor steps."""
    Lj, Lt = families
    zs = 2 * np.pi * np.array([250 + 5j, 400 - 5j, 600 + 5j])
    V = _rhs(Lt.size, 3, 0)
    sv = SlabSolver(Lt, chunk=4, device="cpu")
    X, info = sv.solve(zs, V)
    assert info["max_relres"] < 1e-10
    svj = SlabSolverJax(Lj, chunk=4)
    Xj, info_j = svj.solve(zs, V)
    assert info["timings"]["factor_steps"] == \
        info_j["timings"]["factor_steps"] == sv.part.m
    for j, z in enumerate(zs):
        Xe = spl.spsolve(sv._host_csr(sv.coefficients([z])[0]).tocsc(), V)
        assert np.linalg.norm(X[j] - Xe) / np.linalg.norm(Xe) < 1e-8, j
        assert np.linalg.norm(X[j] - Xj[j]) / np.linalg.norm(Xj[j]) < 1e-8


@pytest.mark.parametrize("n_shifts,chunk", [(3, 2), (3, 4), (5, 4)])
def test_slab_shared_and_per_shift_rhs(families, n_shifts, chunk):
    """A shared [n, l] panel and the per-shift [S, n, l] copy give the same
    solutions to rtol 1e-9; odd shift counts run short and padded chunks."""
    Lt = families[1]
    sv = SlabSolver(Lt, chunk=chunk, device="cpu")
    zs = 2 * np.pi * np.linspace(300, 700, n_shifts) + 2j * np.pi * 5
    V = _rhs(Lt.size, 2, 1)
    X1, _ = sv.solve(zs, V)
    X2, _ = sv.solve(zs, np.broadcast_to(V[None], (n_shifts,) + V.shape))
    np.testing.assert_allclose(X1, X2, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("route", ["host", "slab", "dense", "beyn_batched",
                                   "auto"])
def test_beyn_backends_match_jax_host(families, host_pairs, route):
    """Port Beyn through each backend finds the JAX host modes (272.66 and
    696.14 Hz), the same count, each to 1e-6 Hz; the default backend
    ("auto") takes the dense solves at this size."""
    Lt = families[1]
    if route == "beyn_batched":
        Om, _ = beyn_batched(Lt, GAMMA, dense=False, method="slab", chunk=8,
                             device="cpu", **BEYN_KW)
    elif route == "auto":
        Om, _, info = solvers.beyn(Lt, GAMMA, device="cpu", return_info=True,
                                   **BEYN_KW)
        assert "max_relres" not in info and len(info["sigma"]) >= 2
    else:
        kw = {"chunk": 8} if route == "slab" else {}
        Om, _ = solvers.beyn(Lt, GAMMA, backend=route, device="cpu",
                             **BEYN_KW, **kw)
    f, f_host = (np.sort(O.real) / 2 / np.pi for O in (Om, host_pairs[0]))
    assert len(f) == len(f_host)
    np.testing.assert_allclose(f, f_host, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_solve(families):
    """JAX ``solve`` (the hybrid Beyn + Householder) on the passive family
    with its quadrature on the panel GMRES."""
    return solvers_jax.solve(families[0], GAMMA, backend="gmres")


#: the quadrature routes that reach the panel GMRES.  The first runs at
#: the solver's defaults (block-Jacobi bs 64, GMRES(60): ~20 s on the CPU
#: for Beyn's 768 systems); the others take bs 256 and GMRES(30), ~10 s
PANEL_KW = dict(restart=30, bs=256)
PANEL_ROUTES = {
    "beyn-gmres": lambda L: solvers.beyn(L, GAMMA, backend="gmres",
                                         device="cpu", **BEYN_KW),
    "beyn-matfree-kw": lambda L: solvers.beyn(
        L, GAMMA, backend="matfree", device="cpu", **PANEL_KW, **BEYN_KW),
    "beyn_batched-gmres": lambda L: beyn_batched(
        L, GAMMA, dense=False, method="gmres", device="cpu", **PANEL_KW,
        **BEYN_KW),
    "beyn_batched-kw": lambda L: beyn_batched(
        L, GAMMA, dense=False, device="cpu", **PANEL_KW, **BEYN_KW),
    "solve-gmres": lambda L: solvers.solve(L, GAMMA, backend="gmres",
                                           device="cpu"),
    "solve-matfree-kw": lambda L: solvers.solve(
        L, GAMMA, backend="matfree", restart=30, device="cpu"),
}


@pytest.mark.parametrize("route", list(PANEL_ROUTES))
def test_panel_routes_match_jax(families, host_pairs, jax_solve, route,
                                monkeypatch):
    """The quadrature routes that raised before the panel GMRES was ported
    now solve through ShiftedPanelSolver: ``beyn`` and ``beyn_batched``
    give JAX host Beyn's modes (the same count, each to 1e-6 Hz), and the
    hybrid ``solve`` gives what JAX's ``solve`` gives on its panel GMRES
    (the same eigenvalues to 1e-8·|ω|, the same inside flags)."""
    calls = []
    solve = panel_solve.ShiftedPanelSolver.solve

    def counting(self, *a, **k):
        calls.append(self)
        return solve(self, *a, **k)

    monkeypatch.setattr(panel_solve.ShiftedPanelSolver, "solve", counting)
    out = PANEL_ROUTES[route](families[1])
    assert calls
    if route.startswith("solve"):
        got = sorted(out.items(), key=lambda kv: kv[0].real)
        want = sorted(jax_solve.items(), key=lambda kv: kv[0].real)
        assert len(got) == len(want) >= 1
        for (om, (_, inside)), (om_j, (_, inside_j)) in zip(got, want):
            assert abs(om - om_j) <= 1e-8 * abs(om_j) and inside == inside_j
        return
    f, f_host = (np.sort(O.real) / 2 / np.pi for O in (out[0], host_pairs[0]))
    assert len(f) == len(f_host)
    np.testing.assert_allclose(f, f_host, rtol=0, atol=1e-6)


def test_unported_routes_raise(families):
    """The sharded contour is ported (tests/test_torch_parallel.py): a
    ``mesh`` that is not a torch.distributed DeviceMesh is refused with
    TypeError before any solve."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        beyn_batched(families[1], GAMMA, mesh=object(), device="cpu")


def test_beyn_batched_shift_mesh_matches_unsharded(families, host_pairs,
                                                   tmp_path):
    """beyn_batched on a "shift" mesh (a one-rank gloo world) splits the
    dense quadrature over the mesh and sums the moments with all_reduce:
    the modes equal the unsharded "dense" backend's to 1e-12·|ω| and the
    JAX host modes to 1e-6 Hz."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    Lt = families[1]
    Om_d, _ = solvers.beyn(Lt, GAMMA, backend="dense", device="cpu",
                           **BEYN_KW)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("shift",))
        Om, P = beyn_batched(Lt, GAMMA, mesh=mesh, device="cpu", **BEYN_KW)
    finally:
        dist.destroy_process_group()
    Om, Om_d = np.sort_complex(Om), np.sort_complex(Om_d)
    assert len(Om) == len(Om_d) == 2 and np.isfinite(P).all()
    assert np.all(np.abs(Om - Om_d) <= 1e-12 * np.abs(Om_d))
    f, f_host = (np.sort(O.real) / 2 / np.pi for O in (Om, host_pairs[0]))
    np.testing.assert_allclose(f, f_host, rtol=0, atol=1e-6)


def test_beyn_qep_five_of_six(qep):
    """Twin of test_nlevp_core.py:67: host Beyn on the QEP finds the five
    eigenvalues inside the square with residuals < 1e-8, and the same
    candidates as the JAX package to 1e-10."""
    T, Tt = qep
    Om, P = solvers.beyn(Tt, GAMMA_QEP, l=6, N=32, backend="host")
    Om_j, _ = solvers_jax.beyn(T, GAMMA_QEP, l=6, N=32)
    good = sum(
        np.linalg.norm(Tt(lam).to_dense() @ (P[:, i] / np.linalg.norm(
            P[:, i]))) < 1e-8 for i, lam in enumerate(Om))
    assert good == 5
    for target in QEP_INSIDE:
        assert np.min(np.abs(Om - target)) < 1e-8, target
    np.testing.assert_allclose(np.sort_complex(Om), np.sort_complex(Om_j),
                               rtol=0, atol=1e-10)


def test_count_poles_and_zeros_qep(qep):
    """Twin of test_nlevp_core.py:89: the residue count gives 5 to 1e-6,
    and the JAX package's value to 1e-12."""
    T, Tt = qep
    n = solvers.count_poles_and_zeros(Tt, GAMMA_QEP, N=64)
    assert abs(n - 5.0) < 1e-6
    assert abs(n - solvers_jax.count_poles_and_zeros(T, GAMMA_QEP,
                                                     N=64)) < 1e-12


def test_moments2eigs_multiblock_K2(qep):
    """Twin of test_nlevp_core.py:249: two probe blocks with K = 2 recover
    the five eigenvalues to 1e-8; the moments equal JAX's to 1e-12."""
    T, Tt = qep
    V1 = solvers.initialize_V(3, 3)
    V2 = _rhs(3, 3, 1)
    A1 = solvers.compute_moment_matrices(Tt, GAMMA_QEP, V1, K=2, N=32)
    A2 = solvers.compute_moment_matrices(Tt, GAMMA_QEP, V2, K=2, N=32)
    A1j = solvers_jax.compute_moment_matrices(T, GAMMA_QEP, V1, K=2, N=32)
    np.testing.assert_allclose(A1, A1j, rtol=0, atol=1e-12)
    Om, P = solvers.moments2eigs([A1, A2], rtol_sigma=1e-10)
    Om, P = solvers.pos_test(Om, P, GAMMA_QEP)
    for om in QEP_INSIDE:
        assert np.min(np.abs(Om - om)) < 1e-8, om
    assert len(Om) == 5


def test_equilibrated_residual_rejects_corrupted_pair(families, host_pairs):
    """Twin of test_nlevp_core.py:273 on the passive family: a 5 %
    corrupted eigenvector passes the Frobenius-normalized residual at 0.01
    but the port's row-equilibrated one rejects it; the true pair (JAX host
    Beyn's 272 Hz mode) is kept below 1e-10."""
    Lt = families[1]
    Om, P = host_pairs
    i = int(np.argmin(Om.real))
    om, v_true = Om[i], P[:, i] / np.linalg.norm(P[:, i])
    rng = np.random.default_rng(3)
    noise = rng.standard_normal(Lt.size) + 1j * rng.standard_normal(Lt.size)
    v_bad = v_true + 0.05 * noise / np.linalg.norm(noise)
    Lz = Lt(complex(om))
    frob_bad = (np.linalg.norm(Lz @ v_bad) / np.linalg.norm(Lz.data)
                / np.linalg.norm(v_bad))
    assert frob_bad < 0.01
    assert solvers.row_equilibrated_residual(Lz, v_bad) > 0.01
    assert solvers.row_equilibrated_residual(Lz, v_true) < 1e-10
    Om_f, P_f, res = solvers.verify_eigenpairs(
        Lt, np.array([om, om]), np.stack([v_true, v_bad], axis=1),
        res_tol=0.01)
    assert len(Om_f) == 1 and np.allclose(P_f[:, 0], v_true)


def test_nodes_winding_and_inside_test_bitwise():
    """gauss_nodes, wn and pos_test equal the JAX package's bit for bit."""
    for N in (8, 24):
        for a, b in zip(solvers.gauss_nodes(GAMMA, N),
                        solvers_jax.gauss_nodes(GAMMA, N)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    rng = np.random.default_rng(7)
    pts = 2 * np.pi * (rng.uniform(100, 1050, 200)
                       + 1j * rng.uniform(-8, 8, 200))
    assert [solvers.wn(z, GAMMA) for z in pts] == \
        [solvers_jax.wn(z, GAMMA) for z in pts]
    P = _rhs(5, 200, 8)
    got, want = solvers.pos_test(pts, P, GAMMA), \
        solvers_jax.pos_test(pts, P, GAMMA)
    assert 0 < len(got[0]) < len(pts)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_matfree_checkpoint_resumes(families, tmp_path, monkeypatch):
    """matfree_moments with ``checkpoint``: a run stopped after two node
    groups resumes at the third and gives the uninterrupted moments to
    rtol 1e-12 (the same groups summed in the same order)."""
    Lt = families[1]
    kw = dict(l=4, N=8, group=8, method="slab", chunk=8, device="cpu")
    A_ref, _ = matfree_moments(Lt, GAMMA, **kw)
    solve = slab_solve.SlabSolver.solve
    calls = []

    def stopping(self, *a, **k):
        calls.append(1)
        if len(calls) > 2:
            raise KeyboardInterrupt("simulated preemption")
        return solve(self, *a, **k)

    ck = str(tmp_path / "moments.npz")
    monkeypatch.setattr(slab_solve.SlabSolver, "solve", stopping)
    with pytest.raises(KeyboardInterrupt):
        matfree_moments(Lt, GAMMA, checkpoint=ck, **kw)
    with np.load(ck, allow_pickle=False) as z:
        assert int(z["next"]) == 16
    monkeypatch.setattr(slab_solve.SlabSolver, "solve", solve)
    A, info = matfree_moments(Lt, GAMMA, checkpoint=ck, **kw)
    np.testing.assert_allclose(A, A_ref, rtol=1e-12, atol=0)
    assert info["solver_timings"]["factor_steps"] == 2 * \
        SlabSolver(Lt, device="cpu").part.m     # the last two groups only


def test_slab_reports_unconverged_chunks(families):
    """A chunk that ends above refine_tol is listed in ``unconverged`` and
    warned about, by the solver and through beyn's info; at the default
    sweep cap the same shifts converge and nothing is listed."""
    Lt = families[1]
    zs = 2 * np.pi * np.array([250 + 5j, 400 - 5j, 600 + 5j])
    V = _rhs(Lt.size, 2, 4)
    with pytest.warns(RuntimeWarning, match="ended above refine_tol"):
        _, info = SlabSolver(Lt, chunk=2, refine_sweeps=0,
                             device="cpu").solve(zs, V)
    assert [(a, b) for a, b, _ in info["unconverged"]] == [(0, 2), (2, 3)]
    assert all(r > 1e-11 for *_, r in info["unconverged"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, info = SlabSolver(Lt, chunk=2, device="cpu").solve(zs, V)
    assert info["unconverged"] == [] and info["max_relres"] < 1e-11
    with pytest.warns(RuntimeWarning, match="ended above refine_tol"):
        *_, info = solvers.beyn(Lt, GAMMA, backend="slab", refine_sweeps=0,
                                device="cpu", return_info=True, **BEYN_KW)
    assert len(info["unconverged"]) == 6 and info["max_relres"] > 1e-11


def capped_refinement(families, sweeps, host_hz):
    """Beyn through the slab solver of each package, both factorizing in
    complex64 (the JAX one as on a TPU), the refinement capped at
    ``sweeps``: {package: (max relres, relative error of each mode against
    ``host_hz``, Hankel singular values)}."""
    Lj, Lt = families
    V = solvers.initialize_V(Lt.size, BEYN_KW["l"])
    out = {}
    saved = slab_solve_jax.device_complex_dtype
    slab_solve_jax.device_complex_dtype = lambda: np.complex64
    try:
        for name, moments, L, kw in (
                ("jax", matfree_moments_jax, Lj, {}),
                ("port", matfree_moments, Lt, {"device": "cpu"})):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                A, info = moments(L, GAMMA, V=V, K=1, N=BEYN_KW["N"],
                                  method="slab", refine_sweeps=sweeps, **kw)
            Om, P, sigma = solvers.moments2eigs(A, rtol_sigma=BEYN_KW["rtol"],
                                                return_sigma=True)
            Om, P = solvers.pos_test(Om, P, GAMMA)
            Om, P, _ = solvers.verify_eigenpairs(Lt, Om, P,
                                                 res_tol=BEYN_KW["res_tol"])
            f = np.sort(Om.real) / 2 / np.pi
            err = (np.abs(f - host_hz) / host_hz if len(f) == len(host_hz)
                   else np.full(len(host_hz), np.inf))
            out[name] = (info["max_relres"], err, sigma)
    finally:
        slab_solve_jax.device_complex_dtype = saved
    return out


def test_capped_refinement_error_is_the_jax_packages(families, host_pairs):
    """With the refinement capped at 2 sweeps, where neither package
    reaches refine_tol, the port's slab Beyn leaves the same relres as the
    JAX SlabSolver run in complex64 on the same input (within 10x) and
    modes off the host's by as much (within 10x): the mode error left by
    an unconverged refinement is inherited, not the port's."""
    host_hz = np.sort(host_pairs[0].real) / 2 / np.pi
    got = capped_refinement(families, 2, host_hz)
    (rj, ej, _), (rt, et, _) = got["jax"], got["port"]
    assert 1e-11 < rj < 1e-6 and 1e-11 < rt < 1e-6
    assert 0.1 < rt / rj < 10
    assert np.isfinite(et).all() and 0.1 < et.max() / ej.max() < 10


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_contour.py \
    #     [n_rings nz_cold nz_hot [sweeps ...]]
    # prints capped_refinement against the JAX host Beyn of the family
    args = [int(a) for a in sys.argv[1:]]
    size, sweeps = (args[:3] or [2, 10, 10]), (args[3:] or [0, 2, 4])
    with threadpool_limits(4):
        fams = _families(*size)
        Om_h, _ = solvers_jax.beyn(fams[0], GAMMA, backend="host", **BEYN_KW)
        hz = np.sort(Om_h.real) / 2 / np.pi
        print(f"n={fams[1].size} rijke_mesh{tuple(size)}: JAX host modes Hz "
              f"{hz}")
        for sw in sweeps:
            for name, (r, e, sig) in capped_refinement(fams, sw, hz).items():
                print(f"sweeps {sw} {name}: max relres {r:.3e}  mode rel err "
                      f"{e}  sigma_max/sigma_2 {sig[0] / sig[1]:.3e}  "
                      f"sigma {sig}")
