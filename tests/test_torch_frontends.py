"""The port's front-ends against the JAX package, on the CPU: the
coefficient algebra (twins of tests/test_algebra.py), every descriptor
kind of ``discretize`` and the forcing vector (the skipped speaker and
custom-FTF tests of tests/test_fem_helmholtz.py:281,298 run here on
``rijke_mesh``), the npz loader for every function kind, the 1-D networks
(twins of tests/test_network.py), the shape sensitivities (twins of
tests/test_shape.py) and the 437-DOF ``fancyflame`` family through the
dense engine.  Each test runs both packages on the same inputs and states
its tolerance."""
import math

import numpy as np
import pytest
import scipy.sparse as sp

import wavesandeigenvalues_jl_tpu.models as models_jax
import wavesandeigenvalues_jl_tpu.nlevp as nlevp_jax
import wavesandeigenvalues_jl_tpu.nlevp.algebra as alg_jax
import wavesandeigenvalues_jl_tpu_torch.models as models
import wavesandeigenvalues_jl_tpu_torch.nlevp as nlevp
import wavesandeigenvalues_jl_tpu_torch.nlevp.algebra as alg
from wavesandeigenvalues_jl_tpu.mesh.generate import \
    rijke_mesh as rijke_mesh_jax
from wavesandeigenvalues_jl_tpu_torch.mesh.generate import rijke_mesh
from wavesandeigenvalues_jl_tpu_torch.models.rijke import (
    GAMMA, Q02U0, RHO, active_rijke_setup)

from port_threads import one_thread  # noqa: F401


Z0 = 340 * 2 * np.pi
ALGS = (alg_jax, alg)
#: the same closed-form arithmetic in both packages: values to 1e-14
ALG_RTOL = 1e-14


def _close(a, b, rtol):
    return abs(a - b) <= rtol * max(1.0, abs(b))


def fd(f, z, k, h=1e-5):
    if k == 0:
        return f(z)
    return (fd(f, z + h, k - 1, h) - fd(f, z - h, k - 1, h)) / (2 * h)


# ---------------------------------------------------------------------------
# coefficient algebra (twins of tests/test_algebra.py)


def _twin(build, values, orders):
    """build(alg) -> ScalarFunc; its values at ``values`` for each order
    tuple in ``orders`` from the JAX package and the port."""
    fj, ft = build(alg_jax), build(alg)
    out = []
    for o in orders:
        vj, vt = fj.eval(values, o), ft.eval(values, o)
        assert _close(vt, vj, ALG_RTOL), (o, vt, vj)
        out.append(vt)
    return out


def test_pow_basic():
    """Twin of test_algebra.py::test_pow_basic, exact values."""
    z = 1.7 - 0.3j
    for name, exact in (("pow0", (1, 0)), ("pow1", (z, 1, 0)),
                        ("pow2", (z ** 2, 2 * z, 2, 0))):
        got = _twin(lambda a: getattr(a, name), (z,),
                    [(k,) for k in range(len(exact))])
        assert got == list(exact), name


def test_pow_a():
    """Twin of test_algebra.py::test_pow_a: z⁴ against FD (1e-3) and the
    half power against its closed form (1e-12)."""
    z = 0.9 + 0.2j
    got = _twin(lambda a: a.pow_a(4), (z,), [(k,) for k in range(6)])
    for k, v in enumerate(got):
        ref = fd(lambda w: w ** 4, z, k, h=1e-2)
        assert abs(v - ref) < 1e-3 * max(1, abs(ref))
    (d1,) = _twin(lambda a: a.pow_a(0.5), (z,), [(1,)])
    assert abs(d1 - 0.5 * z ** (-0.5)) < 1e-12


def test_exp_az():
    a, z = 0.3 - 1.1j, 0.4 + 0.8j
    got = _twin(lambda m: m.ExpAz(a), (z,), [(k,) for k in range(4)])
    for k, v in enumerate(got):
        assert abs(v - a ** k * np.exp(a * z)) < 1e-12


@pytest.mark.parametrize("m,n", [(0, 0), (1, 0), (0, 1), (2, 1), (1, 2),
                                 (3, 2), (4, 4)])
def test_exp_delay_mixed_derivs(m, n):
    """Twin of test_algebra.py::test_exp_delay_mixed_derivs against sympy
    (1e-10)."""
    import sympy as sy
    w, tau = 2.0 + 0.5j, 0.7 - 0.1j
    ws, ts = sy.symbols("w t")
    ref = complex(sy.diff(sy.exp(-sy.I * ws * ts), ws, m, ts, n)
                  .subs({ws: w, ts: tau}).evalf())
    (v,) = _twin(lambda a: a.exp_delay, (w, tau), [(m, n)])
    assert abs(v - ref) < 1e-10 * max(1.0, abs(ref))
    (vp,) = _twin(lambda a: a.ExpPM(-1), (w, tau), [(m, n)])
    assert vp == v


def test_z_times_g():
    z = 1.3 + 0.4j
    got = _twin(lambda a: a.generate_z_g_z(a.ExpAz(-0.5j)), (z,),
                [(k,) for k in range(4)])
    for k, v in enumerate(got):
        ref = fd(lambda w: w * np.exp(-0.5j * w), z, k, h=1e-3)
        assert abs(v - ref) < 1e-4 * max(1, abs(ref))


def test_state_space():
    A = np.array([[-1.0, 0.3], [0.0, -2.0]])
    B = np.array([1.0, 0.5])
    C = np.array([0.2, 1.0])
    z = 0.9 + 0.2j
    got = _twin(lambda a: a.generate_stsp_z(A, B, C, 0.1), (z,),
                [(k,) for k in range(3)])

    def g(w):
        return C @ np.linalg.solve(1j * w * np.eye(2) - A, B) + 0.1

    for k, v in enumerate(got):
        ref = fd(g, z, k, h=1e-4)
        assert abs(v - ref) < 1e-5 * max(1, abs(ref))


def test_product_and_one_minus():
    z = 0.5 - 0.3j
    got = _twin(lambda a: a.generate_gz_hz(a.ExpAz(0.2j), a.pow2), (z,),
                [(k,) for k in range(4)])
    for k, v in enumerate(got):
        ref = fd(lambda w: np.exp(0.2j * w) * w ** 2, z, k, h=1e-3)
        assert abs(v - ref) < 1e-4 * max(1, abs(ref))
    v0, v2 = _twin(lambda a: a.generate_1_gz(a.ExpAz(0.2j)), (z,),
                   [(0,), (2,)])
    assert abs(v0 - (1 - np.exp(0.2j * z))) < 1e-12
    assert abs(v2 + (0.2j) ** 2 * np.exp(0.2j * z)) < 1e-12


def test_bloch_filter():
    DOS = 12
    y = np.zeros(DOS, complex)
    y[0] = 1.0 / DOS
    y = np.fft.fft(y)
    for b in range(DOS + 1):
        (v,) = _twin(lambda a: a.generate_sum_y_exp_ikx(y), (complex(b),),
                     [(0,)])
        assert abs(v - (1.0 if b % DOS == 0 else 0.0)) < 1e-12


def test_fancy_flame():
    """Twin of test_algebra.py::test_fancy_flame, plus mixed derivatives
    of the scalar and two-branch forms up to order 3 (1e-14)."""
    w, tau, a = 1.1 + 0.3j, 0.4, 0.05
    got = _twin(lambda m: m.exp_az2mzit, (w, tau, a),
                [(i, j, k) for i in range(4) for j in range(3)
                 for k in range(2)])
    assert abs(got[0] - np.exp(a * w ** 2 - 1j * w * tau)) < 1e-12
    h = 1e-5
    d1 = (np.exp(a * (w + h) ** 2 - 1j * (w + h) * tau)
          - np.exp(a * (w - h) ** 2 - 1j * (w - h) * tau)) / (2 * h)
    assert abs(got[6] - d1) < 1e-6
    vals = (w, 0.7, 1e-3, -1e-2, 0.3, 1.5e-3, -2e-2)
    _twin(lambda m: m.SumNExpAZ2MZIT(2), vals,
          [(m, l1, n1, 0, l2, 0, k2) for m in range(3) for l1 in range(2)
           for n1 in range(2) for l2 in range(2) for k2 in range(2)])


def test_raw_reference_functions():
    """Twin of test_algebra.py::test_raw_reference_functions."""
    z, a = 1.3, 0.7
    for m in ALGS:
        assert np.isclose(m.pow(2.0, 1, 3), 12.0)
        assert np.isclose(m.pow(2.0, 0, 0.5), np.sqrt(2))
        assert np.isclose(m.exp_az(1.0, 3.0, 2), 9 * np.exp(3.0))
        g = m.generate_exp_az(2.0 + 1.0j)
        assert np.isclose(g.eval((0.5,), (1,)),
                          (2 + 1j) * np.exp((2 + 1j) * 0.5))
        assert np.isclose(m.z_exp_iaz(z, a), z * np.exp(1j * a * z))
        assert np.isclose(m.z_exp_iaz(z, a, 1, 0),
                          (1j * a * z + 1) * np.exp(1j * a * z))
        assert np.isclose(m.z_exp__iaz(z, a, 0, 1),
                          -1j * z ** 2 * np.exp(-1j * a * z))
        f = m.exp_pm(-1)
        assert np.isclose(f.eval((z, a), (0, 0)), np.exp(-1j * z * a))
        with pytest.raises(NotImplementedError):
            m.z_exp_iaz(z, a, 1, 1)
    args = (1.1 + 0.2j, 0.7, 1e-3, -1e-2, 1, 0, 1, 0)
    assert _close(alg.sum_n_exp_az2mzit(*args),
                  alg_jax.sum_n_exp_az2mzit(*args), ALG_RTOL)
    assert sorted(alg.__all__) == sorted(alg_jax.__all__)


def test_reciprocal_derivatives_any_order():
    """Twin of test_network.py::test_reciprocal_derivatives_any_order."""
    w = 1.7 + 0.3j
    got = _twin(lambda a: a.Reciprocal(a.Pow(2)), (w,),
                [(k,) for k in range(6)])
    for k, v in enumerate(got):
        exact = (-1) ** k * math.factorial(k + 1) / w ** (k + 2)
        assert np.isclose(v, exact), k


# ---------------------------------------------------------------------------
# every descriptor kind of discretize


def _ntau(a, n=1.0, tau=1e-3):
    """The n–τ flame as a custom FTF (tutorial 08), in algebra ``a``."""
    class NTau(a.ScalarFunc):
        nargs = 1

        def eval(self, values, orders):
            return n * a.exp_delay.eval((values[0], tau), (orders[0], 0))

    return NTau()


def _adm_y(w, k):
    """A callable admittance Y(ω) = 1e-3·exp(2e-4·iω) and its k-th
    derivative (both packages wrap the same callable)."""
    return 1e-3 * (2e-4j) ** k * np.exp(2e-4j * w)


SS = (np.array([[-300.0, 40.0], [0.0, -900.0]]), np.array([1.0, 0.5]),
      np.array([0.02, 0.1]), 1e-3)
HEAD = (GAMMA, RHO, Q02U0, [0.0, 0.0, -0.0101], [0.0, 0.0, 1.0])


def _kind_dscrp(kind, a):
    """(dscrp, discretize kwargs) of one descriptor case for package
    ``a`` (its algebra module) on a rijke_mesh."""
    base = {"Interior": ("interior", ()),
            "Outlet": ("admittance", ("Y", 1e15))}
    if kind == "interior+admittance":
        return base, {}
    if kind == "mass+stiff":
        return {"Interior": ("mass", ()),
                "Cold": ("stiff", ((a.pow_a(2),), (("κ",),), "κ^2")),
                "Hot": ("stiff", ((), (), ""))}, {}
    if kind == "admittance callable":
        return dict(base, Inlet=("admittance", (_adm_y,))), {}
    if kind == "admittance state-space":
        return dict(base, Inlet=("admittance", SS)), {}
    if kind == "speaker":
        return dict(base, Inlet=("speaker", ("S", 1.0, "Yin", 1e-3))), \
            {"source": True}
    if kind == "speaker bare":
        return dict(base, Inlet=("speaker", ("S", 2.0))), {"source": True}
    if kind == "flame n-tau":
        return dict(base, Flame=("flame", HEAD + ("n", "τ", 1.0, 1e-3))), {}
    if kind == "flame n-tau ref_idx":
        return dict(base, Flame=("flame", HEAD[:3] + (7,) + HEAD[3:]
                                 + ("n", "τ", 1.0, 1e-3))), {}
    if kind == "flame custom FTF":
        return dict(base, Flame=("flame", HEAD + (_ntau(a),))), {}
    if kind == "flame callable FTF":
        return dict(base, Flame=("flame", HEAD + (_adm_y,))), {}
    if kind == "flame FTF":
        return dict(base, Flame=("flame", HEAD)), {}
    if kind == "flameresponse":
        return dict(base, Flame=("flameresponse", HEAD + ("ε", 0.3))), {}
    if kind == "fancyflame":
        return dict(base, Flame=("fancyflame", HEAD + (
            "n", "τ", "a", 1.0, 1e-3, -1e-8))), {}
    if kind == "fancyflame list":
        return dict(base, Flame=("fancyflame", HEAD + (
            ["n1", "n2"], ["τ1", "τ2"], ["a1", "a2"], [0.7, 0.3],
            [1e-3, 1.5e-3], [-1e-8, -2e-8]))), {}
    if kind == "unknown kind":
        return dict(base, Walls=("wall", (1, 2, 3))), {}
    if kind in ("herm", "quad"):
        return dict(base, Flame=("flame", HEAD + ("n", "τ", 1.0, 1e-3))), \
            {"order": kind}
    raise KeyError(kind)


KINDS = ["interior+admittance", "mass+stiff", "admittance callable",
         "admittance state-space", "speaker", "speaker bare", "flame n-tau",
         "flame n-tau ref_idx", "flame custom FTF", "flame callable FTF",
         "flame FTF", "flameresponse", "fancyflame", "fancyflame list",
         "unknown kind", "herm", "quad"]
#: the same float64 numpy assembly in both packages; the JAX package sums
#: large COO sets in C++ (another order): terms and coefficients to 1e-12
TERM_RTOL = 1e-12
OMEGAS = (Z0, 1074.9 + 373.2j, -250.0 + 1800.0j)


def _family_pair(kind):
    """The 437-DOF active Rijke's family of one descriptor case, built by
    the JAX package and by the port."""
    out = []
    for mod, a, rm in ((models_jax, alg_jax, rijke_mesh_jax),
                       (models, alg, rijke_mesh)):
        mesh = rm(n_rings=2, nz_cold=10, nz_hot=10)
        c = active_rijke_setup(mesh)[1]
        dscrp, kw = _kind_dscrp(kind, a)
        out.append(mod.discretize(mesh, dscrp, c, **kw))
    return out


def _csr_close(Aj, At, rtol):
    """Both CSRs as scipy matrices: the same shape and values within
    rtol·max|A_jax| (the JAX package's C++ sums may leave a round-off
    entry where the port's cancel to an exact zero)."""
    assert Aj.shape == At.shape
    sj = sp.csr_matrix((Aj.data, Aj.indices, Aj.indptr), shape=Aj.shape)
    st = sp.csr_matrix((At.data, At.indices, At.indptr), shape=At.shape)
    scale = abs(sj).max()
    assert abs(st - sj).max() <= rtol * scale


def _families_close(Lj, Lt):
    assert Lt.size == Lj.size
    assert [t.symbol for t in Lt.terms] == [t.symbol for t in Lj.terms]
    assert [t.operator for t in Lt.terms] == [t.operator for t in Lj.terms]
    assert [t.params for t in Lt.terms] == [t.params for t in Lj.terms]
    assert Lt.params.keys() == Lj.params.keys()
    for k, v in Lj.params.items():
        assert Lt.params[k] == v or (np.isnan(v) and np.isnan(Lt.params[k]))
    for tj, tt in zip(Lj.terms, Lt.terms):
        _csr_close(tj.coeff, tt.coeff, TERM_RTOL)
    for z in OMEGAS:
        for L in (Lj, Lt):
            L.params[L.eigval] = z
        for k in range(3):
            d = {Lj.eigval: k} if k else {}
            cj, ct = Lj.coefficients(d), Lt.coefficients(d)
            assert np.all(np.abs(ct - cj) <= TERM_RTOL * np.maximum(
                1.0, np.abs(cj))), (z, k, ct, cj)


@pytest.mark.parametrize("kind", KINDS)
def test_discretize_kind_twin(kind):
    """Every descriptor kind (and orders "herm", "quad"): the same terms,
    parameters, CSRs to 1e-12 of the largest entry, and each term's
    coefficient with its first two ω-derivatives at three ω to 1e-12
    relative; with ``source=True`` the forcing family too."""
    Lj, Lt = _family_pair(kind)
    if isinstance(Lj, tuple):
        (Lj, rj), (Lt, rt) = Lj, Lt
        _families_close(rj, rt)
        for z in OMEGAS:
            rj.params["ω"] = rt.params["ω"] = z
            np.testing.assert_allclose(rt.coefficients(),
                                       rj.coefficients(), rtol=1e-12)
    _families_close(Lj, Lt)


def test_flame_length_mismatch_raises():
    """As the JAX package: a flame of 7 items raises ValueError."""
    mesh = rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
    c = active_rijke_setup(mesh)[1]
    for mod in (models_jax, models):
        with pytest.raises(ValueError, match="flame data length"):
            mod.discretize(mesh, {"Flame": ("flame", HEAD + (1, 2))}, c)


def test_speaker_source():
    """Twin of test_fem_helmholtz.py::test_speaker_source on rijke_mesh:
    the forcing vector lives on the inlet's points only, in both packages,
    and the two agree to 1e-12."""
    mesh = rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
    inlet = np.unique(mesh.triangles[mesh.domains["Inlet"]["simplices"]])
    (Lj, rj), (Lt, rt) = _family_pair("speaker")
    assert "Yin" in Lt.params and "S" in rt.params
    vj = rj.terms[0].coeff.to_dense()[:, 0]
    vt = rt.terms[0].coeff.to_dense()[:, 0]
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-12 * np.abs(vj).max())
    assert np.abs(vt[inlet]).sum() > 0
    mask = np.ones(len(vt), bool)
    mask[inlet] = False
    assert np.abs(vt[mask]).sum() == 0


def test_custom_ftf_equals_ntau():
    """Twin of test_fem_helmholtz.py::test_custom_ftf_equals_ntau on
    rijke_mesh: the custom FTF family equals the n–τ one at z (1e-9 of the
    largest entry, the JAX test's bar), in both packages."""
    z = 1000.0 + 300j
    Aj = [L(z).to_dense() for L in _family_pair("flame n-tau")]
    At = [L(z).to_dense() for L in _family_pair("flame custom FTF")]
    for A1, A2 in zip(Aj, At):
        assert np.allclose(A1, A2, atol=1e-9 * np.abs(A1).max())


def test_load_family_every_kind(tmp_path):
    """The JAX writer's file of a family holding every function kind the
    loader reads (StateSpace inside ZTimesG, ExpAZ2MZIT, ExpPM, Product,
    OneMinus, SumYExpIKX, ExpAz) loads into the port with the same
    coefficients (1e-14) and matrices (exact)."""
    Lj = _family_pair("admittance state-space")[0]
    Lf = _family_pair("fancyflame")[0]
    for t in Lf.terms:
        if t.operator == "Q":
            Lj.push(t)
    for k in ("n", "τ", "a"):
        Lj.params[k] = Lf.params[k]
    A = Lj.terms[0].coeff
    Lj.push(nlevp_jax.Term(A, (alg_jax.ExpPM(+1),), (("ω", "τ"),), "e",
                           "P"))
    Lj.push(nlevp_jax.Term(A, (alg_jax.generate_gz_hz(
        alg_jax.ExpAz(2e-4j), alg_jax.pow2),), (("ω",),), "g", "G"))
    Lj.push(nlevp_jax.Term(A, (alg_jax.generate_1_gz(
        alg_jax.generate_sum_y_exp_ikx(np.fft.fft(np.eye(4)[0]))),),
        (("ω",),), "o", "O"))
    f = str(tmp_path / "fam.npz")
    nlevp_jax.save_family(f, Lj)
    Lt = nlevp.load_family(f)
    assert [type(g).__name__ for t in Lt.terms for g in t.funcs] == \
        [type(g).__name__ for t in Lj.terms for g in t.funcs]
    _families_close(Lj, Lt)


# ---------------------------------------------------------------------------
# the slice as a whole: the 437-DOF fancyflame family, dense engine


def test_fancyflame_mslp_dense():
    """The 437-DOF active Rijke with a scalar fancyflame through the port's
    dense engine (plain K2 on the CPU) against JAX host mslp: flag 0 and ω
    within 1e-8·|ω| (tests/test_fused_slab.py:47's bar)."""
    Lj, Lt = _family_pair("fancyflame")
    solj, _, flagj = nlevp_jax.mslp(Lj, Z0, maxiter=30, tol=1e-10)
    sol, n, flag = nlevp.mslp(Lt, Z0, maxiter=30, tol=1e-10, device="cpu")
    from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local import \
        FusedPencilSolver
    assert isinstance(Lt._fused_solver[1], FusedPencilSolver)
    assert flag == flagj == 0
    wj = solj.params["ω"]
    assert abs(sol.params["ω"] - wj) <= 1e-8 * abs(wj)


# ---------------------------------------------------------------------------
# 1-D networks (twins of tests/test_network.py)

C, AREA, LEN = 347.0, 0.01, 1.0
NETS = {
    "quarter": [("unode", (C, AREA)), ("duct", (LEN, C, AREA)),
                ("pnode", (C, AREA))],
    "half2": [("pnode", (C, AREA)), ("duct", (0.4, C, AREA)),
              ("duct", (0.6, C, AREA)), ("pnode", (C, AREA))],
    "flame_passive": [("unode", (C, AREA)), ("duct", (0.5, C, AREA)),
                      ("flame", (C, C, AREA)), ("duct", (0.5, C, AREA)),
                      ("pnode", (C, AREA))],
    "flame_active": [("unode", (C, AREA)), ("duct", (0.25, C, AREA)),
                     ("flame", (C, 2 * C, AREA)),
                     ("duct", (0.25, 2 * C, AREA)), ("pnode", (2 * C, AREA))],
    "damper": [("unode", (C, AREA)), ("duct", (0.5, C, AREA)),
               ("helmholtz", (0.02 ** 3, 0.01, 0.005, C, AREA)),
               ("duct", (0.5, C, AREA)), ("pnode", (C, AREA))],
    "lhr": [("unode", (C, AREA)), ("duct", (0.5, C, AREA)),
            ("lhr", (0.02 ** 3, 0.01, 0.005, C, AREA)),
            ("duct", (0.5, C, AREA)), ("pnode", (C, AREA))],
}
#: (network, params, start in Hz, mslp kwargs, property of f in Hz)
NET_CASES = {
    "quarter_wave": ("quarter", {}, 80.0, dict(maxiter=30, tol=1e-10),
                     lambda w: np.isclose(w.real / 2 / np.pi, C / 4 / LEN,
                                          rtol=1e-8)),
    "half_wave_and_multiple_ducts": (
        "half2", {}, 170.0, dict(maxiter=30, tol=1e-10),
        lambda w: np.isclose(w.real / 2 / np.pi, C / 2 / LEN, rtol=1e-8)),
    "flame_passive_limit": (
        "flame_passive", {"n": 0.0, "τ": 1e-3}, 80.0,
        dict(maxiter=30, tol=1e-10),
        lambda w: np.isclose(w.real / 2 / np.pi, C / 4, rtol=1e-8)),
    "helmholtz_damper_adds_damping": (
        "damper", {}, 86.0, dict(maxiter=40, tol=1e-10),
        lambda w: abs(w.real / 2 / np.pi - C / 4 / LEN) < 20.0),
    "lhr_element_builds_and_solves": (
        "lhr", {}, 86.0, dict(maxiter=40, tol=1e-9), lambda w: True),
}


def _nets(name):
    return (models_jax.discretize_network(NETS[name]),
            models.discretize_network(NETS[name]))


@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_network_mslp_twin(case):
    """Twins of tests/test_network.py's mslp tests: the port's mslp (the
    dense engine, plain K2) from the same start gives JAX host's ω within
    1e-8·|ω|, with flag ≥ 0 and the JAX test's physical check."""
    net, params, f0, kw, prop = NET_CASES[case]
    Lj, Lt = _nets(net)
    _families_close(Lj, Lt)
    for L in (Lj, Lt):
        L.params.update(params)
    solj, _, flagj = nlevp_jax.mslp(Lj, 2 * np.pi * f0, **kw)
    sol, _, flag = nlevp.mslp(Lt, 2 * np.pi * f0, device="cpu", **kw)
    w, wj = sol.params["ω"], solj.params["ω"]
    assert flag >= 0 and flagj >= 0
    assert abs(w - wj) <= 1e-8 * abs(wj), (w, wj)
    assert prop(w)


def test_flame_active_shifts_and_destabilizes():
    """Twin of test_network.py::test_flame_active_shifts_and_destabilizes:
    n = 0 then n = 1 from the n = 0 mode, each within 1e-8·|ω| of JAX."""
    Lj, Lt = _nets("flame_active")
    out = []
    for L, solve, kw in ((Lj, nlevp_jax.mslp, {}),
                         (Lt, nlevp.mslp, {"device": "cpu"})):
        L.params["n"], L.params["τ"] = 0.0, 1e-3
        s0, _, f0 = solve(L, 2 * np.pi * 200.0, maxiter=40, tol=1e-11, **kw)
        L.params["n"] = 1.0
        s1, _, f1 = solve(L, s0.params["ω"], maxiter=40, tol=1e-11, **kw)
        assert f0 >= 0 and f1 >= 0
        out.append((s0.params["ω"], s1.params["ω"]))
    (w0j, w1j), (w0, w1) = out
    assert abs(w0.imag) < 1e-6
    assert abs(w1.imag) > 1.0 and abs(w1 - w0) > 1.0
    assert abs(w0 - w0j) <= 1e-8 * abs(w0j)
    assert abs(w1 - w1j) <= 1e-8 * abs(w1j)


def test_beyn_finds_duct_modes():
    """Twin of test_network.py::test_beyn_finds_duct_modes: the port's
    Beyn on its "dense" backend finds the first two half-wave modes to
    1e-6.  With the eigenpair residual filter (``res_tol`` 1e-6; without
    it, the directions of σ at round-off give candidates that differ
    between any two evaluations of the moments) it keeps JAX host Beyn's
    modes, each within 1e-8·|ω|."""
    net = [NETS["half2"][0], ("duct", (LEN, C, AREA)), NETS["half2"][-1]]
    Lj = models_jax.discretize_network(net)
    Lt = models.discretize_network(net)
    Gamma = 2 * np.pi * np.array([100 - 40j, 400 - 40j, 400 + 40j,
                                  100 + 40j])
    Om, _ = nlevp.beyn(Lt, Gamma, l=6, K=2, N=64, backend="dense",
                       device="cpu")
    f = np.sort(Om.real / 2 / np.pi)
    assert all(any(np.isclose(f, k * C / 2, rtol=1e-6)) for k in (1, 2)), f
    Omj, _ = nlevp_jax.beyn(Lj, Gamma, l=6, K=2, N=64, res_tol=1e-6)
    Om, _ = nlevp.beyn(Lt, Gamma, l=6, K=2, N=64, res_tol=1e-6,
                       backend="dense", device="cpu")
    assert len(Om) == len(Omj) == 2
    a, b = np.sort_complex(Om), np.sort_complex(Omj)
    assert np.all(np.abs(a - b) <= 1e-8 * np.abs(b))


# ---------------------------------------------------------------------------
# shape sensitivities (twins of tests/test_shape.py)

C0 = 340.0


@pytest.fixture(scope="module")
def duct_problem():
    """The closed-open box duct of tests/test_shape.py, in both packages;
    the port's householder(order=2) on "device" (DeviceLU on CPU tensors)
    against JAX host to 1e-10·|ω|."""
    from wavesandeigenvalues_jl_tpu.mesh.generate import \
        box_mesh as box_mesh_jax
    from wavesandeigenvalues_jl_tpu_torch.mesh.generate import box_mesh
    out = []
    for bm, mod, hh, kw in ((box_mesh_jax, models_jax, nlevp_jax.householder,
                             {}),
                            (box_mesh, models, nlevp.householder,
                             {"device": "cpu"})):
        mesh = bm(lx=0.2, ly=0.2, lz=1.0, nx=2, ny=2, nz=6)
        dscrp = {"Interior": ("interior", ()),
                 "Zmax": ("admittance", ("Y", 1e15))}
        c = np.full(len(mesh.tetrahedra), C0)
        L = mod.discretize(mesh, dscrp, c)
        sol, _, flag = hh(L, 2 * np.pi * (C0 / 4) * 0.95, maxiter=20,
                          tol=1e-11, nev=1, order=2, **kw)
        assert flag >= 0
        out.append((mesh, dscrp, c, L, sol))
    wj, wt = (o[4].params["ω"] for o in out)
    assert abs(wt - wj) <= 1e-10 * abs(wj)
    assert np.isclose(wt.real / 2 / np.pi, C0 / 4, rtol=2e-2)
    return out


def _pick(mesh, mod):
    surf, tri_mask, tet_mask = mod.get_surface_point_masks(mesh)
    pick = np.linspace(0, len(surf) - 1, 6).astype(int)
    return surf[pick], [tri_mask[i] for i in pick], [tet_mask[i] for i in pick]


def test_da_matches_fd(duct_problem):
    """Twin of test_shape.py::test_da_matches_fd: DA against FD within
    5e-3 (the JAX test's bar); DA and FD each against JAX's to 1e-6
    relative to the largest entry."""
    res = []
    for (mesh, dscrp, c, L, sol), mod, kw in zip(
            duct_problem, (models_jax, models), ({}, {"device": "cpu"})):
        surf_s, tri_s, tet_s = _pick(mesh, mod)
        sens = mod.discrete_adjoint_shape_sensitivity(
            mesh, dscrp, c, surf_s, tri_s, tet_s, L, sol, h=1e-8)
        fd_ = mod.forward_finite_differences_shape_sensitivity(
            mesh, dscrp, c, surf_s, tri_s, tet_s, L, sol, h=1e-6, **kw)
        res.append((sens[:, surf_s], fd_[:, surf_s]))
    (sj, fj), (s, f) = res
    scale = np.abs(fj).max()
    assert np.abs(s - f).max() / np.abs(f).max() < 5e-3
    assert np.abs(s - sj).max() <= 1e-6 * scale
    assert np.abs(f - fj).max() <= 1e-6 * scale


def test_da_analytic_end_stretch(duct_problem):
    """Twin of test_shape.py::test_da_analytic_end_stretch: the summed
    z-sensitivity of the end face is −ω/L within 5 % (the JAX bar) and
    JAX's sum within 1e-6 relative."""
    tot = []
    for (mesh, dscrp, c, L, sol), mod in zip(duct_problem,
                                             (models_jax, models)):
        surf, tri_mask, tet_mask = mod.get_surface_point_masks(mesh)
        idx = np.nonzero(np.isclose(mesh.points[2, surf],
                                    mesh.points[2].max()))[0]
        sens = mod.discrete_adjoint_shape_sensitivity(
            mesh, dscrp, c, surf[idx], [tri_mask[i] for i in idx],
            [tet_mask[i] for i in idx], L, sol, h=1e-8)
        tot.append(sens[2, surf[idx]].sum())
    w0 = duct_problem[1][4].params["ω"]
    assert np.isclose(tot[1].real, (-w0 / 1.0).real, rtol=0.05)
    assert abs(tot[1] - tot[0]) <= 1e-6 * abs(tot[0])


def test_postprocessing_shapes(duct_problem):
    """Twin of test_shape.py::test_postprocessing_shapes: the same normals,
    normalized, mass-normalized (port on DeviceLU, CPU tensors) and normal
    sensitivities as JAX's, to 1e-12 of the largest entry."""
    outs = []
    for (mesh, *_), mod, kw in zip(duct_problem, (models_jax, models),
                                   ({}, {"device": "cpu"})):
        surf, tri_mask, _ = mod.get_surface_point_masks(mesh)
        nvec = mod.surface_normal_vectors(mesh)
        zmax = np.isclose(mesh.points[2, mesh.triangles].mean(axis=1),
                          mesh.points[2].max())
        assert nvec.shape == (3, len(mesh.triangles))
        assert np.all(nvec[2, zmax] > 0)
        sens = np.random.default_rng(0).normal(size=(3, mesh.n_points)) \
            + 0j
        normed = mod.normalize_sensitivity(surf, nvec, tri_mask, sens)
        nsens = mod.bound_mass_normalize(surf, nvec, tri_mask, mesh, sens,
                                         **kw)
        ns = mod.normal_sensitivity(nvec, normed)
        assert np.isfinite(normed).all() and np.isfinite(nsens[:, surf]).all()
        assert ns.shape == (len(mesh.triangles),)
        outs.append((nvec, normed, nsens, ns))
    for a, b in zip(*outs):
        assert np.abs(b - a).max() <= 1e-12 * np.abs(a).max()


def test_unequal_ritz_counts_f6(monkeypatch):
    """F6 (ROADMAP.md Queue 3): the direct and adjoint Arnoldi runs of
    ``eigs_pencil_pair`` can stop (breakdown) at different steps, so
    ``householder(nev=3)`` (the finite-difference shape sensitivity's
    re-solve) gets 3 direct and 1 adjoint Ritz pairs.  The JAX package
    raises IndexError there; the port pairs the pairs both sides have.
    The breakdown is made deterministic here by dropping the adjoint's
    last columns; the port then iterates on the first pair alone, which is
    JAX host's householder with nev=1 (the same 24-step Krylov space and
    its smallest-|λ| Ritz pair): ω to 1e-10."""
    import wavesandeigenvalues_jl_tpu.nlevp.solvers as solvers_jax
    import wavesandeigenvalues_jl_tpu_torch.nlevp.solvers as solvers
    from wavesandeigenvalues_jl_tpu_torch.utils.config import \
        set_solve_backend

    def one_adjoint(orig):
        def pair(*args, **kw):
            lam, V, lam_adj, Vadj = orig(*args, **kw)
            return lam, V, lam_adj[:1], Vadj[:, :1]
        return pair

    Lj = _family_pair("flame n-tau")[0]
    ref, _, _ = nlevp_jax.householder(Lj, Z0, maxiter=4, nev=1, order=3)
    monkeypatch.setattr(solvers_jax, "eigs_pencil_pair",
                        one_adjoint(solvers_jax.eigs_pencil_pair))
    with pytest.raises(IndexError):
        nlevp_jax.householder(Lj, Z0, maxiter=4, nev=3, order=3)
    monkeypatch.setattr(solvers, "eigs_pencil_pair",
                        one_adjoint(solvers.eigs_pencil_pair))
    Lt = _family_pair("flame n-tau")[1]
    prev = set_solve_backend("host")
    try:
        sol, _, flag = nlevp.householder(Lt, Z0, maxiter=4, nev=3, order=3,
                                         device="cpu")
    finally:
        set_solve_backend(prev)
    assert flag >= 0
    w = ref.params["ω"]
    assert abs(sol.params["ω"] - w) <= 1e-10 * abs(w)
