"""The complex128 polish of the port's mslp on the CPU: against the JAX
package's when the numerics refuse it, and factored on the device against
factored on the host.  JAX wraps the polish so that such a step keeps the
device iterate (``nlevp/fused_local.py``), and its ``factorize`` retries a
failed SuperLU factorization as a dense LU (``ops/linsolve.py``); the port
does the same, and factors on the device first (``nlevp/polish.py``)."""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg
import torch

import wavesandeigenvalues_jl_tpu.ops.linsolve as linsolve_jax
import wavesandeigenvalues_jl_tpu_torch.nlevp.polish as polish
from wavesandeigenvalues_jl_tpu.mesh.generate import \
    rijke_mesh as rijke_mesh_jax
from wavesandeigenvalues_jl_tpu.models import discretize as discretize_jax
from wavesandeigenvalues_jl_tpu.nlevp import mslp as mslp_jax
from wavesandeigenvalues_jl_tpu.nlevp.fused_slab import \
    FusedSlabPencilSolver as FusedSlabJax
from wavesandeigenvalues_jl_tpu.ops.sparse import CSR as CSRJax
from wavesandeigenvalues_jl_tpu.utils.config import set_solve_backend
from wavesandeigenvalues_jl_tpu_torch.models.rijke import (
    active_rijke_family, active_rijke_setup)
from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
    FusedSlabPencilSolver
from wavesandeigenvalues_jl_tpu_torch.ops import linsolve
from wavesandeigenvalues_jl_tpu_torch.ops.device_solve import DeviceLU
from wavesandeigenvalues_jl_tpu_torch.ops.sparse import CSR, NATIVE_DEDUP_MIN
from wavesandeigenvalues_jl_tpu_torch.utils import timing

from port_threads import one_thread  # noqa: F401

Z0 = 340 * 2 * np.pi
#: the tolerance of the JAX package's tests/test_fused_slab.py:47
OMEGA_RTOL = 1e-8


def _superlu_refuses(*args, **kwargs):
    raise RuntimeError("Factor is exactly singular")


class _RefusedLU(DeviceLU):
    """A device factor with a zero pivot, as ``DeviceLU`` reports one."""
    made = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        type(self).made += 1

    ok = False


def test_polish_failure_keeps_the_device_iterate(monkeypatch):
    """Every polish factorization fails in both packages: SuperLU raises
    its RuntimeError (``factorize`` patched where each package's polish
    looks it up: JAX's ``fused_local`` imports it inside the function, the
    port's ``polish`` at module level), and the port's device factor,
    tried first, has a zero pivot.  Both keep the device iterate of the
    slab engine (forced on the n = 437 family, as tests/test_fused_slab.py
    does): the same flag and ω within 1e-8·|ω|; the port does not
    raise."""
    calls = {"jax": 0, "port": 0}

    def refusing(key):
        def factorize(*args, **kwargs):
            calls[key] += 1
            _superlu_refuses()
        return factorize

    monkeypatch.setattr(linsolve_jax, "factorize", refusing("jax"))
    monkeypatch.setattr(polish, "factorize", refusing("port"))
    monkeypatch.setattr(polish, "DeviceLU", _RefusedLU)
    monkeypatch.setattr(_RefusedLU, "made", 0)
    mesh = rijke_mesh_jax(n_rings=2, nz_cold=10, nz_hot=10)
    Lj = discretize_jax(mesh, *active_rijke_setup(mesh))
    Lj._fused_solver = (Lj._stack(), FusedSlabJax(Lj))
    prev = set_solve_backend("device")
    try:
        sol_j, n_j, flag_j = mslp_jax(Lj, Z0, maxiter=30, tol=1e-11)
    finally:
        set_solve_backend(prev)
    L = active_rijke_family()
    L._fused_solver = (L._stack(), FusedSlabPencilSolver(L, "cpu"))
    sol, n_it, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device="cpu")
    assert calls == {"jax": 1, "port": 1} and _RefusedLU.made == 1
    om, om_j = sol.params[sol.eigval], sol_j.params[sol_j.eigval]
    assert flag == flag_j
    assert abs(om - om_j) <= OMEGA_RTOL * abs(om_j)
    assert n_it == n_j
    assert np.isfinite(sol.v).all()


@pytest.mark.parametrize("case", ["singular", "superlu refuses"])
def test_factorize_retries_dense(monkeypatch, case):
    """A CSR of dimension ≥ SPARSE_LU_MIN_DIM that SuperLU refuses goes to
    the dense LU in both packages, with the same ``ok``: an exactly
    singular matrix (SuperLU raises, the dense LU has a zero pivot and
    ``check`` raises SingularMatrixError), and a regular one with SuperLU
    patched to raise (the dense LU solves it)."""
    n = 640
    assert n >= linsolve.SPARSE_LU_MIN_DIM == linsolve_jax.SPARSE_LU_MIN_DIM
    rng = np.random.default_rng(3)
    A = (sp.random(n, n, density=0.01, random_state=4)
         + 4 * sp.eye(n)).tocsr().astype(np.complex128)
    if case == "singular":
        A = sp.diags(np.r_[np.ones(n - 1), 0.0]).tocsr().astype(
            np.complex128)
    else:
        monkeypatch.setattr(scipy.sparse.linalg, "splu", _superlu_refuses)
    A.sort_indices()
    F = linsolve.factorize(CSR(A.indptr, A.indices, A.data, A.shape),
                           backend="host")
    Fj = linsolve_jax.factorize(CSRJax(A.indptr, A.indices, A.data, A.shape),
                                backend="host")
    assert isinstance(F, linsolve.DenseLU)
    assert isinstance(Fj, linsolve_jax.DenseLU)
    assert F.ok == Fj.ok == (case != "singular")
    if case == "singular":
        with pytest.raises(linsolve.SingularMatrixError):
            linsolve.factorize(CSR(A.indptr, A.indices, A.data, A.shape),
                               check=True, backend="host")
        with pytest.raises(linsolve_jax.SingularMatrixError):
            linsolve_jax.factorize(
                CSRJax(A.indptr, A.indices, A.data, A.shape), check=True,
                backend="host")
    else:
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        np.testing.assert_allclose(A @ F.solve(b), b, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(F.solve(b), Fj.solve(b), rtol=1e-13,
                                   atol=1e-13)


def _family(engine):
    """The n = 437 active family on the dense engine, or on the slab
    engine forced."""
    L = active_rijke_family()
    if engine == "slab":
        L._fused_solver = (L._stack(), FusedSlabPencilSolver(L, "cpu"))
    return L


def _solve(L):
    """(ω, flag, polish steps, ``polish.factor`` counts) of one mslp."""
    timing.reset()
    sol, _, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device="cpu")
    root, = [s for s in timing.spans() if s.id == s.request]
    return (sol.params[sol.eigval], flag, root.attrs["polish_steps"],
            timing.counts("polish.factor"))


@pytest.mark.parametrize("engine", ["slab", "dense"])
def test_device_polish_matches_host(monkeypatch, engine):
    """The polish factored on the device (torch's LU on CPU tensors, at n
    = 437 below POLISH_DEVICE_MAX_DIM) and on the host (SuperLU's dense
    LAPACK below SPARSE_LU_MIN_DIM, with the limit patched to 0) from the
    same device loop: ω within 1e-12·|ω|, the same flag, polish steps
    within one of each other, and the counter ``polish.factor`` keyed
    ``device``, then ``host``, once a step.  The two factors' last |dz|
    lie near ``tol`` (1e-11 on |ω| ≈ 1.1e3, some forty ulps of ω), so whether
    a third step is taken depends on rounding that varies with the BLAS
    and torch thread counts."""
    L = _family(engine)
    assert L.size <= polish.POLISH_DEVICE_MAX_DIM
    om, flag, steps, counts = _solve(L)
    assert counts == {"device": steps} and steps >= 1
    monkeypatch.setattr(polish, "POLISH_DEVICE_MAX_DIM", 0)
    om_h, flag_h, steps_h, counts_h = _solve(L)
    assert counts_h == {"host": steps_h}
    assert flag == flag_h == 0 and abs(steps - steps_h) <= 1
    assert abs(om - om_h) <= 1e-12 * abs(om_h)


def test_refused_device_factor_falls_back_to_host(monkeypatch):
    """A device factor with a zero pivot hands the step to the host
    factor: the same answer as the host polish, bit for bit, counted
    ``host``."""
    L = _family("slab")
    monkeypatch.setattr(polish, "POLISH_DEVICE_MAX_DIM", 0)
    host = _solve(L)
    monkeypatch.undo()
    monkeypatch.setattr(polish, "DeviceLU", _RefusedLU)
    monkeypatch.setattr(_RefusedLU, "made", 0)
    assert _solve(L) == host
    assert _RefusedLU.made == host[2] == host[3]["host"]


class _OutOfMemoryLU(DeviceLU):
    """A device factor that runs out of the device's memory."""

    def __init__(self, *args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")


def test_device_factor_out_of_memory_falls_back_to_host(monkeypatch):
    """A device factor that runs out of memory hands the step to the host
    factor: the same answer as the host polish, bit for bit, counted
    ``host``."""
    L = _family("slab")
    monkeypatch.setattr(polish, "POLISH_DEVICE_MAX_DIM", 0)
    host = _solve(L)
    monkeypatch.undo()
    monkeypatch.setattr(polish, "DeviceLU", _OutOfMemoryLU)
    assert _solve(L) == host
    assert host[3] == {"host": host[2]}


class _FaultyFactorLU(DeviceLU):
    """A device factor that fails as a kernel launch would."""

    def __init__(self, *args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")


class _FaultySolveLU(DeviceLU):
    """A device factor whose solves fail as a kernel launch would."""

    def _solve_dev(self, B, trans):
        raise RuntimeError("CUDA error: an illegal memory access")


@pytest.mark.parametrize("where", ["factor", "solve"])
def test_device_fault_in_polish_raises(monkeypatch, where):
    """A torch error in the polish's device factor or its solves, other
    than the factor's out-of-memory, is no refusal of the numerics: mslp
    raises ``DeviceFault`` from it, and does not keep the device iterate
    as it does where the numerics refuse."""
    monkeypatch.setattr(polish, "DeviceLU", {"factor": _FaultyFactorLU,
                                             "solve": _FaultySolveLU}[where])
    with pytest.raises(polish.DeviceFault) as info:
        mslp(_family("slab"), Z0, maxiter=30, tol=1e-11, device="cpu")
    assert "illegal memory access" in str(info.value.__cause__)


@pytest.mark.parametrize("trans", ["N", "T", "H"])
def test_device_single_solve(monkeypatch, trans):
    """``DeviceLU(refine=False).solve``: one device solve of a vector or a
    panel,
    with no host refinement (no ``device_solve.refine`` phase), to 1e-12
    of a LAPACK solve of a system whose rows span 12 orders of magnitude
    (the equilibrated factor takes them)."""
    rng = np.random.default_rng(5)
    n = 96
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
         + 8 * np.eye(n)) * np.logspace(0, 12, n)[:, None]
    Aop = {"N": A, "T": A.T, "H": A.conj().T}[trans]
    F = DeviceLU(A, "cpu", refine=False)
    timing.reset()
    for b in (rng.standard_normal(n) + 1j * rng.standard_normal(n),
              rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))):
        x = F.solve(b, trans)
        assert x.shape == b.shape
        np.testing.assert_allclose(x, np.linalg.solve(Aop, b), rtol=1e-12,
                                   atol=1e-12 * np.abs(x).max())
    assert "device_solve.refine" not in timing.report()


def _sorted_transpose(A):
    """The conjugate transpose by ``CSR.from_coo`` (sort, sum, drop)."""
    rows, cols, vals = A.to_coo()
    return CSR.from_coo(cols, rows, np.conj(vals), (A.shape[1], A.shape[0]))


@pytest.mark.parametrize("case", ["family", "large", "rectangular",
                                  "duplicates", "stored zero", "unsorted"])
def test_conj_transpose_matches_sorted(case):
    """``CSR.conj_transpose`` (SciPy's CSR -> CSC conversion, duplicates
    summed and stored zeros dropped) gives the arrays of ``from_coo``'s
    sort, bit for bit, without calling it: on
    L(z) of the 437-DOF family, on a CSR past the native dedup's gate, and
    on small CSRs of each kind."""
    rng = np.random.default_rng(11)
    if case == "family":
        A = active_rijke_family()(Z0)
    else:
        m, n = {"large": (300, 300), "rectangular": (30, 50)}.get(case,
                                                                  (40, 40))
        A = sp.random(m, n, density=0.4 if case == "large" else 0.2,
                      random_state=12, format="csr")
        A = (A + 1j * A).astype(np.complex128)
        A.sort_indices()
        ind, dat = A.indices.copy(), A.data.copy()
        if case == "duplicates":
            ind[1] = ind[0]
        elif case == "stored zero":
            dat[3] = 0.0
        elif case == "unsorted":
            ind[:2] = ind[1::-1]
        A = CSR(A.indptr.astype(np.int64), ind.astype(np.int32), dat,
                A.shape)
    if case == "large":
        assert A.nnz >= NATIVE_DEDUP_MIN
    ref = _sorted_transpose(A)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CSR, "from_coo", None)
        T = A.conj_transpose()
    for got, want in zip((T.indptr, T.indices, T.data),
                         (ref.indptr, ref.indices, ref.data)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert T.shape == ref.shape
    x = rng.standard_normal(A.shape[0]) + 1j * rng.standard_normal(A.shape[0])
    dense = sp.csr_matrix((A.data, A.indices, A.indptr),
                          shape=A.shape).toarray()     # duplicates summed
    np.testing.assert_allclose(T @ x, dense.conj().T @ x, rtol=1e-12,
                               atol=1e-12 * np.abs(A.data).max())
