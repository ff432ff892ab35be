"""The parameter studies of the port (nlevp/pade's convergence radius,
polynomials and multipoint Padé; nlevp/continuation.track_branch) against
the JAX package on the CPU.  Twins of tests/test_nlevp_core.py:116,136,
154,163 and of the six tests of tests/test_multipoint_pade.py, plus
track_branch against the JAX one on the 437-DOF active Rijke family.  Each
test states its tolerance against the JAX value."""
import importlib
import math
import warnings

import numpy as np
import pytest

import wavesandeigenvalues_jl_tpu.nlevp as nlevp_jax
import wavesandeigenvalues_jl_tpu_torch.nlevp as nlevp
from wavesandeigenvalues_jl_tpu.mesh.generate import \
    rijke_mesh as rijke_mesh_jax
from wavesandeigenvalues_jl_tpu.models import discretize as discretize_jax
from wavesandeigenvalues_jl_tpu.nlevp.continuation import \
    track_branch as track_branch_jax
from wavesandeigenvalues_jl_tpu_torch.models.rijke import (
    active_rijke_family, active_rijke_setup)
from wavesandeigenvalues_jl_tpu_torch.nlevp import (
    Polynomial, RationalPolynomial, conv_radius, estimate_pol, gallery, mslp,
    multipoint_pade, newton_polynomial, pade, perturb_fast, poly_roots,
    polyval, taylor_shift, track_branch)

from port_threads import one_thread  # noqa: F401

#: the JAX module (its package exports a function of the same name)
pade_jax = importlib.import_module("wavesandeigenvalues_jl_tpu.nlevp.pade")
Z0 = 340 * 2 * np.pi


def _taylor_of_poly(c, z0, n):
    """First n Taylor coefficients of the polynomial c (monomial) about
    z0 (test_multipoint_pade.py:12)."""
    c = np.asarray(c, complex)
    return np.asarray([sum(c[j] * math.comb(j, s) * z0 ** (j - s)
                           for j in range(s, len(c))) for s in range(n)])


def _omega_jet(g, tau, order, z=1.0 + 0.3j, **kw):
    """ω and its order-``order`` jet in τ on the 48-point gallery tube of
    package ``g`` (the port's runs on the CPU)."""
    L, _ = g.gallery.rijke_tube(48)
    L.params["τ"] = tau
    sol, _, flag = g.mslp(L, z, tol=1e-12, maxiter=30, **kw)
    assert flag >= 0
    g.perturb_fast(sol, L, "τ", order, **kw)
    return sol.params["ω"], np.asarray(sol.eigval_pert["τ/Taylor"])


def test_perturbation_taylor_vs_exact():
    """Twin of test_nlevp_core.py:116: the order-8 series in τ at 0.01
    reproduces the re-solved ω to 1e-9·max(1, |ω|); the coefficients
    equal JAX's to 1e-8 relative each, ω to 1e-10·|ω|."""
    L, _ = gallery.rijke_tube(48)
    sol, _, flag = mslp(L, 1.0 + 0.3j, tol=1e-12, maxiter=30, device="cpu")
    om0 = sol.params["ω"]
    perturb_fast(sol, L, "τ", 8, device="cpu")
    coeffs = sol.eigval_pert["τ/Taylor"]
    assert abs(coeffs[0] - om0) < 1e-12
    dtau = 0.01
    est = polyval(coeffs, dtau)
    L.params["τ"] = L.params["τ"] + dtau
    sol2, _, _ = mslp(L, om0, tol=1e-12, maxiter=30, device="cpu")
    exact = sol2.params["ω"]
    assert abs(est - exact) < 1e-9 * max(1.0, abs(exact))
    om_j, c_j = _omega_jet(nlevp_jax, gallery.rijke_tube(48)[0].params["τ"],
                           8)
    assert abs(om0 - om_j) <= 1e-10 * abs(om_j)
    np.testing.assert_allclose(coeffs, c_j, rtol=1e-8, atol=0)


def test_pade_beats_taylor_outside_radius():
    """Twin of test_nlevp_core.py:136: at 2.5× the ratio-test radius the
    [8/8] Padé beats the order-16 Taylor series and lands within 1e-3·|ω|;
    conv_radius equals JAX's on JAX's series to 1e-12 and the series
    JAX's to 1e-8 in its first eight terms."""
    L, _ = gallery.rijke_tube(48)
    sol, _, _ = mslp(L, 1.0 + 0.3j, tol=1e-12, maxiter=30, device="cpu")
    om0 = sol.params["ω"]
    perturb_fast(sol, L, "τ", 16, device="cpu")
    coeffs = sol.eigval_pert["τ/Taylor"]
    r = conv_radius(coeffs)[-1]
    dtau = 2.5 * r
    taylor_est = polyval(coeffs, dtau)
    pade_est = sol("τ", L.params["τ"].real + dtau, 8, 8)
    L.params["τ"] = L.params["τ"] + dtau
    sol2, _, _ = mslp(L, om0, tol=1e-12, maxiter=40, device="cpu")
    exact = sol2.params["ω"]
    assert abs(pade_est - exact) < abs(taylor_est - exact)
    assert abs(pade_est - exact) < 1e-3 * abs(exact)
    _, c_j = _omega_jet(nlevp_jax, gallery.rijke_tube(48)[0].params["τ"],
                        16)
    np.testing.assert_allclose(conv_radius(c_j), pade_jax.conv_radius(c_j),
                               rtol=1e-12)
    np.testing.assert_allclose(coeffs[:8], c_j[:8], rtol=1e-8, atol=0)


def test_pade_roundtrip():
    """Twin of test_nlevp_core.py:154: the [1/1] Padé of (1+2z)/(1−z) is
    exact to 1e-10, its coefficients JAX's bit for bit; estimate_pol
    finds the pole at 1 and equals JAX's."""
    taylor = np.array([1.0 + 0j] + [3.0 + 0j] * 10)
    a, b = pade(taylor, 1, 1)
    z = 0.7
    assert abs(polyval(a, z) / polyval(b, z) - (1 + 2 * z) / (1 - z)) < 1e-10
    for x, y in zip((a, b), pade_jax.pade(taylor, 1, 1)):
        assert np.array_equal(x, y)
    de, k = estimate_pol(taylor)
    de_j, k_j = pade_jax.estimate_pol(taylor)
    np.testing.assert_allclose(de[1:], 1.0, rtol=1e-12)
    assert np.array_equal(de, de_j) and np.array_equal(k, k_j)


def test_poly_roots():
    """Twin of test_nlevp_core.py:163: the roots of z² − 1, and the
    Polynomial / RationalPolynomial classes and taylor_shift against
    JAX's (1e-12)."""
    r = np.sort_complex(poly_roots(np.array([-1.0, 0.0, 1.0])))
    assert np.allclose(r, [-1, 1])
    p, q = Polynomial([1.0, -2.0, 0.0, 1.0]), Polynomial([2.0, 1.0])
    pj, qj = pade_jax.Polynomial([1.0, -2.0, 0.0, 1.0]), \
        pade_jax.Polynomial([2.0, 1.0])
    for got, want in (((p + q).coeffs, (pj + qj).coeffs),
                      ((p * q).coeffs, (pj * qj).coeffs),
                      ((p - q).coeffs, (pj - qj).coeffs),
                      (p.derivative().coeffs, pj.derivative().coeffs),
                      (p.shift(0.5 + 1j).coeffs, pj.shift(0.5 + 1j).coeffs),
                      (taylor_shift([1.0, 2.0, 3.0], -0.25),
                       pade_jax.taylor_shift([1.0, 2.0, 3.0], -0.25))):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert p.degree() == 3 and abs(p(2.0) - 5.0) < 1e-12
    rr = RationalPolynomial([1.0, 2.0], Polynomial([1.0, -1.0]))
    assert np.allclose(rr.poles(), [1.0]) and np.allclose(rr.zeros(), [-0.5])
    assert abs(rr(0.7) - (1 + 1.4) / 0.3) < 1e-12


def test_newton_polynomial_hermite_exact():
    """Twin of test_multipoint_pade.py:24: two 2-jets give the cubic to
    1e-12, equal to JAX's."""
    p = np.array([1.0, -2.0, 0.0, 1.0], complex)
    pts = [(0.0, _taylor_of_poly(p, 0.0, 2)),
           (1.0, _taylor_of_poly(p, 1.0, 2))]
    q = newton_polynomial(pts)
    assert np.allclose(q, p, atol=1e-12)
    assert np.array_equal(q, pade_jax.newton_polynomial(pts))


def test_newton_polynomial_plain_nodes():
    """Twin of test_multipoint_pade.py:33: distinct simple nodes give the
    classic Newton interpolant, equal to JAX's."""
    p = np.array([2.0, 1.0, -3.0], complex)
    pts = [(z, [polyval(p, z)]) for z in (0.0, 0.5, 2.0)]
    q = newton_polynomial(pts)
    assert np.allclose(q, p, atol=1e-12)
    assert np.array_equal(q, pade_jax.newton_polynomial(pts))


def test_multipoint_pade_exact_rational():
    """Twin of test_multipoint_pade.py:41: the [1/2] interpolant from
    2-jets at two points recovers (1+2z)/(1−0.5z+0.25z²) to 1e-10 and
    equals JAX's to 1e-12."""
    num = np.array([1.0, 2.0], complex)
    den = np.array([1.0, -0.5, 0.25], complex)

    def taylor(z0, n):
        a, b = taylor_shift(num, z0), taylor_shift(den, z0)
        a = np.concatenate([a, np.zeros(n, complex)])
        c = np.zeros(n, complex)
        for k in range(n):
            c[k] = (a[k] - sum(c[j] * b[k - j]
                               for j in range(max(0, k - len(b) + 1), k))) \
                / b[0]
        return c

    pts = [(0.0, taylor(0.0, 2)), (0.7, taylor(0.7, 2))]
    r = multipoint_pade(1, 2, pts)
    rj = pade_jax.multipoint_pade(1, 2, pts)
    for z in (0.21 + 0.3j, -0.4, 1.5 + 1j):
        exact = polyval(num, z) / polyval(den, z)
        assert abs(r(z) - exact) < 1e-10
        assert abs(r(z) - rj(z)) <= 1e-12 * abs(rj(z))
    np.testing.assert_allclose(np.sort_complex(r.poles()),
                               np.sort_complex(rj.poles()), rtol=1e-12)


def test_multipoint_pade_condition_count():
    """Twin of test_multipoint_pade.py:65: the wrong number of conditions
    raises."""
    with pytest.raises(ValueError):
        multipoint_pade(2, 2, [(0.0, [1.0, 2.0])])


def test_two_point_pade_rijke_eigenvalue():
    """Twin of test_multipoint_pade.py:70: the [2/3] two-point Padé of
    ω(τ) from jets at τ₀ (order 3) and τ₁ (order 1) predicts the midpoint
    better than the order-3 Taylor series, within 5e-3·|ω|; the jets equal
    JAX's to 1e-8 relative each, the two-point value JAX's to 1e-10·|ω|."""
    tau0, tau1 = 0.2, 0.4
    taum = 0.5 * (tau0 + tau1)
    _, jet0 = _omega_jet(nlevp, tau0, 3, device="cpu")
    _, jet1 = _omega_jet(nlevp, tau1, 1, device="cpu")
    om_exact, _ = _omega_jet(nlevp, taum, 1, device="cpu")
    r = multipoint_pade(2, 3, [(tau0, jet0), (tau1, jet1)])
    om_2pt = r(taum)
    om_taylor = polyval(jet0, taum - tau0)
    assert abs(om_2pt - om_exact) < abs(om_taylor - om_exact)
    assert abs(om_2pt - om_exact) < 5e-3 * abs(om_exact)
    _, jet0_j = _omega_jet(nlevp_jax, tau0, 3)
    _, jet1_j = _omega_jet(nlevp_jax, tau1, 1)
    np.testing.assert_allclose(jet0, jet0_j, rtol=1e-8, atol=0)
    np.testing.assert_allclose(jet1, jet1_j, rtol=1e-8, atol=0)
    om_j = pade_jax.multipoint_pade(2, 3, [(tau0, jet0_j),
                                           (tau1, jet1_j)])(taum)
    assert abs(om_2pt - om_j) <= 1e-10 * abs(om_j)


def test_duplicate_expansion_points_merge_not_nan():
    """Twin of test_multipoint_pade.py:100: a repeated node merges into
    one confluent jet (the cubic to 1e-12, JAX's coefficients), and
    inconsistent data at a repeated node raises."""
    p = np.array([1.0, -2.0, 0.0, 1.0], complex)
    pts = [(0.0, _taylor_of_poly(p, 0.0, 1)),
           (0.0, _taylor_of_poly(p, 0.0, 2)),
           (1.0, _taylor_of_poly(p, 1.0, 2))]
    q = newton_polynomial(pts)
    assert np.all(np.isfinite(q))
    assert np.allclose(q, p, atol=1e-12)
    assert np.array_equal(q, pade_jax.newton_polynomial(pts))
    with pytest.raises(ValueError):
        newton_polynomial([(0.0, [1.0]), (0.0, [2.0]), (1.0, [0.0, 1.0])])


def test_track_branch_matches_jax():
    """track_branch over 4 τ values on the 437-DOF active Rijke family
    (the fused dense engine and DeviceLU on CPU tensors) against the JAX
    one on its "host" backend: the same flags, each ω within 1e-8·|ω|,
    every point but the last with its order-2 jet, each coefficient within
    1e-8 relative.  The fused engine's hand-over warning is an error.  The
    engine cached on L at the first point serves every point, and its
    last solve equals a fresh engine's from the same guess: no value from
    before the τ change carries over."""
    taus = np.linspace(1e-3, 1.6e-3, 4)
    mj = rijke_mesh_jax(n_rings=2, nz_cold=10, nz_hot=10)
    Lj = discretize_jax(mj, *active_rijke_setup(mj))
    sols_j, flags_j = track_branch_jax(Lj, "τ", taus, Z0, order=2)
    L = active_rijke_family()
    engines = []
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="fused device step",
                                category=RuntimeWarning)

        def recording_mslp(L, z, **kw):
            out = mslp(L, z, **kw)
            engines.append(L._fused_solver[1])
            return out

        sols, flags = track_branch(L, "τ", taus, Z0, order=2,
                                   solver=recording_mslp, device="cpu")
    assert flags == flags_j and all(f >= 0 for f in flags)
    assert all(e is engines[0] for e in engines)
    for i, (s, sj) in enumerate(zip(sols, sols_j)):
        om, om_j = s.params["ω"], sj.params["ω"]
        assert abs(om - om_j) <= 1e-8 * abs(om_j), i
        if i + 1 < len(taus):
            jet = np.asarray(s.eigval_pert["τ/Taylor"])
            jet_j = np.asarray(sj.eigval_pert["τ/Taylor"])
            assert len(jet) == 3
            np.testing.assert_allclose(jet, jet_j, rtol=1e-8, atol=0)
        else:
            assert "τ/Taylor" not in s.eigval_pert
    guess = complex(polyval(sols[-2].eigval_pert["τ/Taylor"],
                            taus[-1] - taus[-2]))
    fresh = active_rijke_family()
    fresh.params["τ"] = complex(taus[-1])
    sol_f, n_f, flag_f = mslp(fresh, guess, tol=1e-11, maxiter=30,
                              device="cpu")
    assert fresh._fused_solver[1] is not engines[0]
    assert flag_f == flags[-1]
    assert sol_f.params["ω"] == sols[-1].params["ω"]
