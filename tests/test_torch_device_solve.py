"""The port's solve backends against the JAX package's, on the CPU: the
factorizations of ``ops/device_solve`` (``DeviceLU``, ``DeviceGMRES``),
the backend switch, the dual shift-invert Arnoldi, the restarted GMRES of
``ops/gmres`` and the refinement of ``ops/refine``.  Twins of
tests/test_device_backend.py:33,42,51,62,128,155, tests/test_gmres.py and
tests/test_timing_refine.py:39,60.  Both packages compute in complex128
here (JAX's device backends do on every device but a TPU); each test runs
the JAX function and the port on the same seeded inputs."""
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp
import wavesandeigenvalues_jl_tpu.ops.device_solve as ds_jax
import wavesandeigenvalues_jl_tpu.ops.linsolve as linsolve_jax
import wavesandeigenvalues_jl_tpu.utils.config as config_jax
from wavesandeigenvalues_jl_tpu.nlevp import gallery as gallery_jax
from wavesandeigenvalues_jl_tpu.nlevp.eigs import \
    eigs_pencil_pair as eigs_pencil_pair_jax
from wavesandeigenvalues_jl_tpu.ops.gmres import \
    block_jacobi as block_jacobi_jax
from wavesandeigenvalues_jl_tpu.ops.gmres import gmres as gmres_jax
from wavesandeigenvalues_jl_tpu.ops.gmres import \
    solve_shifted_batch as solve_shifted_batch_jax
from wavesandeigenvalues_jl_tpu.ops.refine import refine as refine_jax
from wavesandeigenvalues_jl_tpu.ops.sparse import CSR as CSRJax
from wavesandeigenvalues_jl_tpu_torch.nlevp import gallery
from wavesandeigenvalues_jl_tpu_torch.nlevp.eigs import eigs_pencil_pair
from wavesandeigenvalues_jl_tpu_torch.ops import linsolve
from wavesandeigenvalues_jl_tpu_torch.ops.device_solve import (
    DEVICE_DENSE_MAX_DIM, DeviceGMRES, DeviceLU, device_factorize)
from wavesandeigenvalues_jl_tpu_torch.ops.gmres import (block_jacobi, gmres,
                                                        solve_shifted_batch)
from wavesandeigenvalues_jl_tpu_torch.ops.refine import refine
from wavesandeigenvalues_jl_tpu_torch.ops.sparse import CSR
from wavesandeigenvalues_jl_tpu_torch.utils.config import (set_solve_backend,
                                                           solve_backend)

from port_threads import one_thread  # noqa: F401


TRANSES = ("N", "T", "H")


def _op(A, trans):
    return {"N": A, "T": A.T, "H": A.conj().T}[trans]


def _rel(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.fixture
def jax_device_backend():
    prev = config_jax.set_solve_backend("device")
    yield
    config_jax.set_solve_backend(prev)


@pytest.fixture
def penalty_system():
    """The JAX test's system (tests/test_device_backend.py:18-28): dense
    complex, one row scaled by 1e12 (the admittance penalty pattern)."""
    rng = np.random.default_rng(0)
    n = 96
    A = (np.eye(n) * 4 + 0.3 * rng.standard_normal((n, n))
         + 0.1j * rng.standard_normal((n, n)))
    A[0] *= 1e12
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return A, b


@pytest.mark.parametrize("kind", ["lu", "gmres"])
def test_device_solve_all_transposes(kind, penalty_system):
    """N, T and H solves of both factorizations: each within 1e-8 of the
    direct solve (the JAX test's bar) and of the JAX class's solve; the T
    solve is the one built from ``lu_solve(adjoint=True)`` and
    conjugation."""
    A, b = penalty_system
    if kind == "lu":
        F = DeviceLU(CSR.from_dense(A), device="cpu")
        Fj = ds_jax.DeviceLU(CSRJax.from_dense(A))
    else:
        F = DeviceGMRES(CSR.from_dense(A), bs=16, tol=1e-10, device="cpu")
        Fj = ds_jax.DeviceGMRES(CSRJax.from_dense(A), bs=16, tol=1e-10)
    for trans in TRANSES:
        x, xj = F.solve(b, trans=trans), Fj.solve(b, trans=trans)
        ref = np.linalg.solve(_op(A, trans), b)
        assert _rel(x, ref) < 1e-8, trans
        assert _rel(x, xj) < 1e-8, trans


@pytest.mark.parametrize("kind", ["lu", "gmres"])
def test_device_solve_multirhs_panel(kind, penalty_system):
    """A [n, 3] panel in one device solve per sweep: within 1e-9 of the
    direct solves and of the JAX class's panel (DeviceLU, the JAX test's
    bar), and the GMRES panel of tests/test_device_backend.py:155 (n = 80,
    one row × 1e10) within 1e-8, each transpose."""
    if kind == "lu":
        A, b = penalty_system
        B = np.stack([b, 2 * b, 1j * b], axis=1)
        F = DeviceLU(CSR.from_dense(A), device="cpu")
        Fj = ds_jax.DeviceLU(CSRJax.from_dense(A))
        bar = 1e-9
    else:
        rng = np.random.default_rng(3)
        n = 80
        A = (np.eye(n) * 5 + 0.3 * rng.standard_normal((n, n))
             + 0.2j * rng.standard_normal((n, n)))
        A[1] *= 1e10
        B = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
        F = DeviceGMRES(CSR.from_dense(A), bs=16, tol=1e-10, device="cpu")
        Fj = ds_jax.DeviceGMRES(CSRJax.from_dense(A), bs=16, tol=1e-10)
        bar = 1e-8
    for trans in TRANSES:
        X, Xj = F.solve(B, trans=trans), Fj.solve(B, trans=trans)
        ref = np.linalg.solve(_op(A, trans), B)
        assert _rel(X, ref) < bar, trans
        assert _rel(X, Xj) < bar, trans
    if kind == "gmres":
        assert F.last_relres < 1e-13


def test_device_lu_detects_singular():
    """A structurally singular matrix: ``ok`` is False in both packages and
    ``factorize(check=True)`` on "device_lu" raises SingularMatrixError."""
    A = np.zeros((4, 4), complex)
    A[0, 0] = A[1, 1] = A[2, 2] = 1.0
    assert not DeviceLU(A, device="cpu").ok
    assert not ds_jax.DeviceLU(A).ok
    with pytest.raises(linsolve.SingularMatrixError):
        linsolve.factorize(A, check=True, backend="device_lu", device="cpu")
    with pytest.raises(linsolve_jax.SingularMatrixError):
        linsolve_jax.factorize(A, check=True, backend="device_lu")


def test_backend_switch_and_dispatch():
    """``set_solve_backend`` takes the JAX package's four values and
    returns the previous one; ``factorize`` and ``device_factorize``
    dispatch as JAX's do (DEVICE_DENSE_MAX_DIM is JAX's 4,096).  The
    port's default is "device" (JAX's is "host")."""
    assert solve_backend() == "device"
    assert DEVICE_DENSE_MAX_DIM == ds_jax.DEVICE_DENSE_MAX_DIM == 4096
    A = np.eye(8, dtype=complex)
    for backend in ("host", "device", "device_lu", "device_gmres"):
        prev = set_solve_backend(backend)
        prev_j = config_jax.set_solve_backend(backend)
        try:
            F = linsolve.factorize(A, device="cpu")
            Fj = linsolve_jax.factorize(A)
            assert type(F).__name__ == type(Fj).__name__
        finally:
            assert set_solve_backend(prev) == backend
            config_jax.set_solve_backend(prev_j)
    assert solve_backend() == "device"
    assert isinstance(device_factorize(A, "device_gmres", "cpu"),
                      DeviceGMRES)
    assert isinstance(device_factorize(A, "device", "cpu"), DeviceLU)
    with pytest.raises(ValueError):
        set_solve_backend("tpu")


def test_factorize_with_fallback_singular():
    """The singular L(0,0) route of the perturbation recurrence: a device
    LU that fails falls back to the host path, and a singular host LU to
    the least-squares solve, in both packages; the minimum-norm solutions
    agree to 1e-12."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6))
    A[:, -1] = 0.0
    b = A @ (rng.standard_normal(6) + 0j)
    prev = config_jax.set_solve_backend("device")
    try:
        Fj = linsolve_jax.factorize_with_fallback(A)
    finally:
        config_jax.set_solve_backend(prev)
    F = linsolve.factorize_with_fallback(A, device="cpu")
    assert type(F).__name__ == type(Fj).__name__ == "DenseQRLstsq"
    for trans in TRANSES:
        np.testing.assert_allclose(F.solve(b, trans), Fj.solve(b, trans),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(linsolve.solve(np.eye(3) * 2, np.ones(3),
                                              device="cpu"), 0.5)


def test_device_lu_against_scipy_n256():
    """DeviceLU on the CPU at n = 256 (torch's CPU LU, where its batched
    form has misbehaved at n ≥ 192; this unbatched call holds): every
    transpose and a panel within 1e-12 of scipy's LU solve."""
    rng = np.random.default_rng(256)
    n = 256
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
         + 8 * np.eye(n))
    A[3] *= 1e9
    B = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    lu = sla.lu_factor(A)
    F = DeviceLU(CSR.from_dense(A), device="cpu")
    assert F.ok
    for t, trans in enumerate(TRANSES):
        ref = sla.lu_solve(lu, B, trans=t)
        assert _rel(F.solve(B, trans), ref) < 1e-12, trans
        assert _rel(F.solve(B[:, 0], trans), ref[:, 0]) < 1e-12, trans


def test_dual_arnoldi_pair_matches_jax(jax_device_backend):
    """The dual Arnoldi on the device (``DeviceLU.dual_arnoldi`` and the
    ``eigs_pencil_pair`` fast path) on the gallery Rijke tube of the JAX
    test (:128): λ within 1e-9 of JAX's DeviceLU pair and of the host
    loop, both vectors the same up to phase (|⟨a, b⟩| within 1e-6 of 1)."""
    def pencil(g):
        L, _ = g.rijke_tube(64)
        L.params["n"], L.params["τ"] = 1.0, 0.5
        L.ensure_aux()
        L.params[L.eigval] = 1.1 + 0.25j
        L.params[L.auxval] = 0.0
        return L(1.1 + 0.25j), L.aux_weight()

    A, M = pencil(gallery)
    lam, V, lam_adj, W = eigs_pencil_pair(A, M, nev=1, device="cpu")
    lam_j, V_j, _, W_j = eigs_pencil_pair_jax(*pencil(gallery_jax), nev=1)
    prev = set_solve_backend("host")
    try:
        lam_h, V_h, _, W_h = eigs_pencil_pair(A, M, nev=1)
    finally:
        set_solve_backend(prev)
    for ref, Vr, Wr in ((lam_j, V_j, W_j), (lam_h, V_h, W_h)):
        assert abs(lam[0] - ref[0]) <= 1e-9 * max(1.0, abs(ref[0]))
        for a, b in ((V[:, 0], Vr[:, 0]), (W[:, 0], Wr[:, 0])):
            assert abs(abs(np.vdot(b, a)) - 1.0) < 1e-6
    assert abs(lam_adj[0] - np.conj(lam[0])) == 0


def _rijke_matrix(n, z=1.0 + 0.5j):
    L, _ = gallery.rijke_tube(n)
    Lj, _ = gallery_jax.rijke_tube(n)
    return L, L(z), Lj, Lj(z)


def _gmres_pair(A, Aj, b, restart, max_restarts, precond):
    """(port, JAX) ``gmres`` results on the same system, each with the
    block-Jacobi right preconditioner (bs 32) if ``precond``."""
    Ad = torch.from_numpy(A.to_dense())
    Adj = jnp.asarray(Aj.to_dense())
    port = gmres(lambda X: X @ Ad.T, torch.from_numpy(b), tol=1e-10,
                 restart=restart, max_restarts=max_restarts,
                 precond=block_jacobi(A, bs=32, device="cpu")
                 if precond else None)
    jax_ = gmres_jax(lambda v: Adj @ v, jnp.asarray(b), tol=1e-10,
                     restart=restart, max_restarts=max_restarts,
                     precond=block_jacobi_jax(Aj, bs=32) if precond else None)
    return ([np.asarray(port[0]), float(port[1]), int(port[2])],
            [np.asarray(jax_[0]), float(jax_[1]), int(jax_[2])])


@pytest.mark.parametrize("case", ["direct", "block_jacobi"])
def test_gmres_matches_jax(case):
    """``gmres`` on the gallery Rijke tube, the two cases of
    tests/test_gmres.py:19,38.  "direct": n = 96 at restart 110 (a Krylov
    breakdown inside the cycle), block-Jacobi preconditioned: relres below
    1e-9, the same restart count as JAX, x within 1e-7 of the direct
    solve and 1e-8 of JAX's.  "block_jacobi": n = 128 at restart 30, with
    and without the preconditioner: preconditioned as above (1e-6) and in
    no more restarts than without; without, both packages stall at the
    restart cap with relres within 10 % of each other (rounding steers a
    stalled GMRES)."""
    n, seed, restart, max_restarts = ((96, 0, 110, 5) if case == "direct"
                                      else (128, 1, 30, 40))
    L, A, Lj, Aj = _rijke_matrix(n)
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x_ref = linsolve.factorize(A, backend="host").solve(b)
    (x, res, its), (xj, res_j, its_j) = _gmres_pair(A, Aj, b, restart,
                                                    max_restarts, True)
    bar = 1e-7 if case == "direct" else 1e-6
    assert res < 1e-9 and res_j < 1e-9 and its == its_j
    assert _rel(x, x_ref) < bar and _rel(x, xj) < bar / 10
    if case == "block_jacobi":
        (_, res_n, its_n), (_, res_nj, its_nj) = _gmres_pair(
            A, Aj, b, restart, max_restarts, False)
        assert its <= its_n == its_nj == max_restarts
        assert abs(res_n - res_nj) <= 0.1 * res_nj


def test_solve_shifted_batch_matches_jax():
    """Three shifts in one batched GMRES (tests/test_gmres.py:57):
    preconditioned residuals below 1e-8, each solution within 1e-6 of the
    direct solve and of JAX's vmapped batch."""
    L, _, Lj, _ = _rijke_matrix(96)
    n = L.size
    rng = np.random.default_rng(2)
    zs = np.array([0.8 + 0.4j, 1.0 + 0.5j, 1.3 + 0.2j])
    B = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    X, res = solve_shifted_batch(L, zs, B, tol=1e-10, restart=110,
                                 max_restarts=5, bs=32, device="cpu")
    Xj, res_j = solve_shifted_batch_jax(Lj, zs, B, tol=1e-10,
                                              restart=110, max_restarts=5,
                                              bs=32)
    assert np.all(res < 1e-8) and np.all(np.asarray(res_j) < 1e-8)
    for i, z in enumerate(zs):
        x_ref = linsolve.factorize(L(z), backend="host").solve(B[i])
        assert _rel(X[i], x_ref) < 1e-6, i
        assert _rel(X[i], Xj[i]) < 1e-6, i


@pytest.mark.parametrize("case", ["dense", "csr"])
def test_refine_matches_jax(case):
    """``refine`` around a complex64 solver (tests/test_timing_refine.py:39,
    60): relres below 1e-13, orders better than the complex64 solve alone,
    the same sweep history as JAX's to 1e-3 relative, x within 1e-12."""
    rng = np.random.default_rng(0 if case == "dense" else 1)
    n = 200 if case == "dense" else 150
    if case == "dense":
        A = np.diag(rng.standard_normal(n) + 5.0 + 0j)
        A += 0.3 * (rng.standard_normal((n, n))
                    + 1j * rng.standard_normal((n, n)))
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        A32 = A.astype(np.complex64)
        solve32 = lambda r: np.linalg.solve(A32, r.astype(np.complex64))
        Ap, Aj = A, A
    else:
        D = np.diag(rng.standard_normal(n) + 4.0 + 0j)
        b = rng.standard_normal(n) + 0j
        F32 = np.diag(1.0 / np.diag(D).astype(np.complex64))
        solve32 = lambda r: F32 @ r.astype(np.complex64)
        Ap, Aj = CSR.from_dense(D), CSRJax.from_dense(D)
        A = D
    x, hist = refine(Ap, b, solve32, iters=6, tol=1e-13)
    xj, hist_j = refine_jax(Aj, b, solve32, iters=6, tol=1e-13)
    res = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    res32 = (np.linalg.norm(b - A @ solve32(b).astype(np.complex128))
             / np.linalg.norm(b))
    assert res < 1e-13 and res < res32 / 1e4
    assert len(hist) == len(hist_j)
    np.testing.assert_allclose(hist, hist_j, rtol=1e-3, atol=1e-16)
    assert _rel(x, xj) < 1e-12
