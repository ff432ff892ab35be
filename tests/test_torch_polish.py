"""The host polish of the port's mslp against the JAX package's when the
host numerics refuse it, on the CPU.  JAX wraps the polish so that such a
step keeps the device iterate (``nlevp/fused_local.py``), and its
``factorize`` retries a failed SuperLU factorization as a dense LU
(``ops/linsolve.py``); the port does the same."""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg
import torch

import wavesandeigenvalues_jl_tpu.ops.linsolve as linsolve_jax
import wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local as fused_local
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
from wavesandeigenvalues_jl_tpu_torch.ops.sparse import CSR

torch.set_num_threads(2)

Z0 = 340 * 2 * np.pi
#: the tolerance of the JAX package's tests/test_fused_slab.py:47
OMEGA_RTOL = 1e-8


def _superlu_refuses(*args, **kwargs):
    raise RuntimeError("Factor is exactly singular")


def test_polish_failure_keeps_the_device_iterate(monkeypatch):
    """Every polish factorization raises SuperLU's RuntimeError in both
    packages (``factorize`` patched where each ``fused_local`` looks it
    up: JAX imports it inside the function, the port at module level).
    Both keep the device iterate of the slab engine (forced on the n = 437
    family, as tests/test_fused_slab.py does): the same flag and ω within
    1e-8·|ω|; the port does not raise."""
    calls = {"jax": 0, "port": 0}

    def refusing(key):
        def factorize(*args, **kwargs):
            calls[key] += 1
            _superlu_refuses()
        return factorize

    monkeypatch.setattr(linsolve_jax, "factorize", refusing("jax"))
    monkeypatch.setattr(fused_local, "factorize", refusing("port"))
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
    assert calls == {"jax": 1, "port": 1}
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
