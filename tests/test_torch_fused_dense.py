"""The port's dense local eigensolve (nlevp/fused_local.FusedPencilSolver,
whose inner solves are kernel K2) against the JAX package on the small
active Rijke tube (n = 437, N = 512), on the CPU, where the K2 wrapper runs
its plain PyTorch version.  The family is built by the JAX package and
carried across with save_family / load_family."""
import numpy as np
import pytest
import torch

from wavesandeigenvalues_jl_tpu.mesh.generate import \
    rijke_mesh as rijke_mesh_jax
from wavesandeigenvalues_jl_tpu.models import discretize as discretize_jax
from wavesandeigenvalues_jl_tpu.nlevp import mslp as mslp_jax
from wavesandeigenvalues_jl_tpu.nlevp.fused_local import \
    FusedPencilSolver as FusedPencilJax
from wavesandeigenvalues_jl_tpu.nlevp.persist import save_family
from wavesandeigenvalues_jl_tpu_torch.models.rijke import active_rijke_setup
from wavesandeigenvalues_jl_tpu_torch.nlevp import load_family, mslp
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local import \
    FusedPencilSolver
from wavesandeigenvalues_jl_tpu_torch.utils import timing

from port_threads import one_thread  # noqa: F401

Z0 = 340 * 2 * np.pi
#: JAX host mslp on this family (complex128 sparse LU), flag 0
OMEGA_437 = 1074.9363291294444 + 373.1589412263712j


def _jax_family():
    mesh = rijke_mesh_jax(n_rings=2, nz_cold=10, nz_hot=10)
    return discretize_jax(mesh, *active_rijke_setup(mesh))


@pytest.fixture
def families(tmp_path):
    """(JAX family, the same family loaded into the port)."""
    Lj = _jax_family()
    fname = str(tmp_path / "rijke_437.npz")
    save_family(fname, Lj)
    return Lj, load_family(fname)


def test_one_step_matches_jax(families):
    """One dense step from the same z, carries and σ = 0 with the
    preconditioner refreshed: dz and λ within 1e-6 relative of one JAX
    FusedPencilSolver step (Pallas GMRES in interpret mode).  Measured on
    the CPU: 1.5e-7 (dz) and 1.1e-7 (λ) relative — complex64 GMRES sums
    in another order; the refinement and the quotients are complex128.
    3 K2 solves per step."""
    import jax
    Lj, Lt = families
    n = Lt.size
    one, zero = np.ones(n, np.float32), np.zeros(n, np.float32)
    carries = tuple(jax.device_put(p) for p in (one, zero, one, zero))
    dz_j, lam_j, _, res_j = FusedPencilJax(Lj).step(complex(Z0), carries,
                                                    0.0 + 0.0j, True)
    solver = FusedPencilSolver(Lt, "cpu")
    assert solver.N == 512
    calls = timing.total("dense_gmres.twin_calls")
    dz_t, lam_t, carries_t, res_t = solver.step(
        complex(Z0), torch.ones(2, n, dtype=torch.complex64), 0.0 + 0.0j,
        refresh=True)
    assert timing.total("dense_gmres.twin_calls") == calls + 3
    assert carries_t.shape == (2, n) and carries_t.dtype == torch.complex64
    assert abs(dz_t - dz_j) <= 1e-6 * abs(dz_j)
    assert abs(lam_t - lam_j) <= 1e-6 * abs(lam_j)
    assert res_t.max() < 1e-5 and res_j.max() < 1e-5


def test_mslp_routes_to_dense_and_matches_jax_host(families):
    """Port mslp at n = 437 goes through FusedPencilSolver and K2's plain
    version, flag 0, within 1e-8·|ω| of JAX host mslp and OMEGA_437."""
    Lj, L = families
    sol_h, _, flag_h = mslp_jax(Lj, Z0, maxiter=30, tol=1e-11)
    om_h = sol_h.params[sol_h.eigval]
    calls = timing.total("dense_gmres.twin_calls")
    sol, n_it, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device="cpu")
    om = sol.params[sol.eigval]
    assert isinstance(L._fused_solver[1], FusedPencilSolver)
    assert timing.total("dense_gmres.twin_calls") > calls
    assert flag_h == 0 and flag == 0
    assert abs(om - om_h) <= 1e-8 * abs(om_h)
    assert abs(om - OMEGA_437) <= 1e-8 * abs(OMEGA_437)
    assert 0 < n_it < 30
    assert np.isfinite(sol.v).all() and np.isfinite(sol.v_adj).all()


def test_refresh_protocol(families, monkeypatch):
    """The block-Jacobi inverses are refreshed at step 0 (σ = 0) and again
    right after σ is set from λ(z₀), at the same z; a later refresh only
    follows a step whose refined residual exceeds 1e-3."""
    _, L = families
    seen = []
    refresh = FusedPencilSolver.refresh_bj
    step = FusedPencilSolver.step

    def record_refresh(self, c, sigma):
        seen.append(("refresh", complex(sigma), complex(self.L.params["ω"])))
        return refresh(self, c, sigma)

    def record_step(self, z, carries, sigma, refresh=False):
        out = step(self, z, carries, sigma, refresh)
        seen.append(("step", float(out[3].max()), complex(z)))
        return out

    monkeypatch.setattr(FusedPencilSolver, "refresh_bj", record_refresh)
    monkeypatch.setattr(FusedPencilSolver, "step", record_step)
    sol, _, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device="cpu")
    assert flag == 0
    kinds = [k for k, _, _ in seen]
    assert kinds[:3] == ["refresh", "step", "refresh"]
    assert seen[0][1] == 0 and seen[0][2] == Z0
    sigma = seen[2][1]
    assert sigma.real > 0 and sigma.imag == 0 and seen[2][2] == Z0
    for i in range(3, len(seen)):
        if seen[i][0] == "refresh":
            assert seen[i - 1][0] == "step" and seen[i - 1][1] > 1e-3
            assert seen[i][1] == sigma


def test_default_device_is_the_card(families):
    """Without a device argument mslp runs on cuda: where torch sees no
    card the call raises from torch instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs there")
    _, L = families
    with pytest.raises((AssertionError, RuntimeError)):
        mslp(L, Z0, maxiter=2)
