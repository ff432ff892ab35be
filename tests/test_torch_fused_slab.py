"""The port's slice end to end: the fused slab-direct local eigensolve
(nlevp/fused_slab.py + fused_local.py + solvers.mslp) against the JAX
package on the small active Rijke tube (n = 437), on the CPU, where the
block-Thomas wrapper runs its plain PyTorch version."""
import numpy as np
import pytest
import torch

from wavesandeigenvalues_jl_tpu.mesh.generate import \
    rijke_mesh as rijke_mesh_jax
from wavesandeigenvalues_jl_tpu.models import discretize as discretize_jax
from wavesandeigenvalues_jl_tpu.nlevp import mslp as mslp_jax
from wavesandeigenvalues_jl_tpu.nlevp.fused_slab import \
    FusedSlabPencilSolver as FusedSlabJax
from wavesandeigenvalues_jl_tpu.nlevp.persist import save_family
from wavesandeigenvalues_jl_tpu_torch.models.rijke import (
    active_rijke_family, active_rijke_setup)
from wavesandeigenvalues_jl_tpu_torch.nlevp import load_family, mslp
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
    FusedSlabPencilSolver
from wavesandeigenvalues_jl_tpu_torch.utils import timing

from port_threads import one_thread  # noqa: F401

Z0 = 340 * 2 * np.pi
#: JAX host mslp on this family (complex128 sparse LU), flag 0
OMEGA_437 = 1074.9363291294444 + 373.1589412263712j


def _jax_family():
    mesh = rijke_mesh_jax(n_rings=2, nz_cold=10, nz_hot=10)
    return discretize_jax(mesh, *active_rijke_setup(mesh))


def test_one_step_matches_jax():
    """One step from the same z and carries: dz and λ agree to 5e-7
    relative (complex64 factorization and Thomas solve, summed in another
    order; the refinement and the Rayleigh quotients are complex128)."""
    import jax
    Lj, Lt = _jax_family(), active_rijke_family()
    n = Lt.size
    one, zero = np.ones(n, np.float32), np.zeros(n, np.float32)
    carries = tuple(jax.device_put(p) for p in (one, zero, one, zero))
    dz_j, lam_j, _, res_j = FusedSlabJax(Lj).step(complex(Z0), carries,
                                                  0.0 + 0.0j, True)
    solver = FusedSlabPencilSolver(Lt, "cpu")
    calls = timing.total("slab_thomas.twin_calls")
    dz_t, lam_t, carries_t, res_t = solver.step(
        complex(Z0), torch.ones(2, n, dtype=torch.complex64), 0.0 + 0.0j)
    # 3 solves per step
    assert timing.total("slab_thomas.twin_calls") == calls + 3
    assert carries_t.shape == (2, n) and carries_t.dtype == torch.complex64
    assert abs(dz_t - dz_j) <= 5e-7 * abs(dz_j)
    assert abs(lam_t - lam_j) <= 5e-7 * abs(lam_j)
    assert res_t.max() < 1e-5 and res_j.max() < 1e-5


def test_cpu_factor_runs_eagerly():
    """On the CPU the slab factor is the same recursion run eagerly: a
    step counts one ``eager`` factor and builds no graph, and the step
    still matches JAX's to 5e-7 relative (test_one_step_matches_jax)."""
    import jax
    Lj, Lt = _jax_family(), active_rijke_family()
    n = Lt.size
    one, zero = np.ones(n, np.float32), np.zeros(n, np.float32)
    carries = tuple(jax.device_put(p) for p in (one, zero, one, zero))
    dz_j, lam_j, _, _ = FusedSlabJax(Lj).step(complex(Z0), carries,
                                              0.0 + 0.0j, True)
    solver = FusedSlabPencilSolver(Lt, "cpu")
    before = timing.counts("fused_slab.factor")
    dz_t, lam_t, _, _ = solver.step(
        complex(Z0), torch.ones(2, n, dtype=torch.complex64), 0.0 + 0.0j)
    after = timing.counts("fused_slab.factor")
    assert after.get("eager", 0) == before.get("eager", 0) + 1
    assert after.get("capture") == before.get("capture")
    assert after.get("replay") == before.get("replay")
    assert solver._graph is None
    assert abs(dz_t - dz_j) <= 5e-7 * abs(dz_j)
    assert abs(lam_t - lam_j) <= 5e-7 * abs(lam_j)


def test_singular_slab_raises():
    """Solve data that leave a Dt_i singular (all zero) raise
    ``LinAlgError`` on the CPU too, and the next factor on sound data
    matches a fresh solver's."""
    L = active_rijke_family()
    solver, fresh = (FusedSlabPencilSolver(L, "cpu") for _ in range(2))
    c, _ = solver.coefficients(complex(Z0))
    _, g = solver.solve_data(torch.from_numpy(c),
                             torch.zeros((), dtype=torch.complex128))
    with pytest.raises(torch.linalg.LinAlgError, match="singular"):
        solver._factor(torch.zeros_like(g))
    DT, stream, scale = solver._factor(g)
    DT_f, stream_f, scale_f = fresh._factor(g)
    assert torch.equal(DT, DT_f) and torch.equal(stream, stream_f)
    assert torch.equal(scale, scale_f)


def test_mslp_matches_jax_host():
    """The slab engine end to end: port mslp (device engine on the CPU)
    against JAX host mslp, both flag 0, |Δω| ≤ 1e-8·|ω|
    (test_fused_slab.py:47).  n = 437 is below FUSED_MAX_DIM, so the slab
    engine is forced through the family's solver cache, as the JAX test
    does (test_fused_slab.py:37-38)."""
    sol_h, _, flag_h = mslp_jax(_jax_family(), Z0, maxiter=30, tol=1e-11)
    om_h = sol_h.params[sol_h.eigval]
    L = active_rijke_family()
    L._fused_solver = (L._stack(), FusedSlabPencilSolver(L, "cpu"))
    calls = timing.total("slab_thomas.twin_calls")
    sol, n_it, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device="cpu")
    assert timing.total("slab_thomas.twin_calls") > calls
    om = sol.params[sol.eigval]
    assert flag_h == 0 and flag == 0
    assert abs(om - om_h) <= 1e-8 * abs(om_h)
    assert abs(om - OMEGA_437) <= 1e-8 * abs(OMEGA_437)
    assert 0 < n_it < 30
    assert np.isfinite(sol.v).all() and np.isfinite(sol.v_adj).all()
    # the forced solver is the one the device loop used
    assert isinstance(L._fused_solver[1], FusedSlabPencilSolver)


def test_load_family_of_jax_npz(tmp_path):
    """The JAX package writes the family, the port reads it back: same
    terms, parameters, union-pattern values and coefficients."""
    Lj = _jax_family()
    fname = str(tmp_path / "rijke_437.npz")
    save_family(fname, Lj)
    Lt = load_family(fname)
    assert [t.symbol for t in Lt.terms] == [t.symbol for t in Lj.terms]
    assert [t.operator for t in Lt.terms] == [t.operator for t in Lj.terms]
    assert [t.params for t in Lt.terms] == [t.params for t in Lj.terms]
    assert Lt.params == Lj.params
    assert (Lt.eigval, Lt.auxval, Lt.active, Lt.mode) == \
        (Lj.eigval, Lj.auxval, Lj.active, Lj.mode)
    Sj, St = Lj._stack(), Lt._stack()
    np.testing.assert_array_equal(St.indptr, Sj.indptr)
    np.testing.assert_array_equal(St.indices, Sj.indices)
    np.testing.assert_array_equal(St.values, Sj.values)
    for z in (Z0, OMEGA_437):
        Lt.params["ω"] = Lj.params["ω"] = z
        for derivs in ({}, {"ω": 1}, {"τ": 1}):
            np.testing.assert_array_equal(Lt.coefficients(derivs),
                                          Lj.coefficients(derivs))


def test_unported_settings_raise():
    """A solve backend the JAX package does not have is refused.  (Higher
    orders and the "host" backend are ported:
    tests/test_torch_local_engine.py; Beyn's "gmres" backend too:
    tests/test_torch_panel_solve.py; the sharded contour too:
    tests/test_torch_parallel.py.)"""
    from wavesandeigenvalues_jl_tpu_torch.utils.config import \
        set_solve_backend
    with pytest.raises(ValueError):
        set_solve_backend("tpu")
