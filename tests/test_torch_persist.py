"""The port's persistence and fitting (nlevp/persist, nlevp/toml_compat,
nlevp/fitting, ``OperatorFamily.save``, ``project``,
``StackedOperator.assemble_dense``) against the JAX package on the CPU:
npz and TOML files cross between the packages in both directions with
equal arrays and parameters, the vector fit gives JAX's poles and
residues, and the fitted flame gives JAX host's eigenvalue through the
port's mslp at 513 DOF.  Twins of tests/test_toml_compat.py,
tests/test_fitting.py and the moment checkpoint of
tests/test_continuation_checkpoint.py."""
import importlib
import os

import numpy as np
import pytest

from wavesandeigenvalues_jl_tpu_torch.models.rijke import active_rijke_setup
from wavesandeigenvalues_jl_tpu_torch.nlevp import (OperatorFamily, Solution,
                                                    fit_state_space,
                                                    load_family,
                                                    load_family_toml,
                                                    load_solution_toml,
                                                    project, read_sol,
                                                    read_solution, read_toml,
                                                    save, save_family_toml)

from port_threads import one_thread  # noqa: F401

PKGS = ("wavesandeigenvalues_jl_tpu", "wavesandeigenvalues_jl_tpu_torch")
JAX, PORT = PKGS
#: the noise-free fit of tests/test_fitting.py:60-64 (path J2's)
FIT_FREQS = np.linspace(100, 600, 120)
FIT_TAU = 1e-3


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _kinds_family(pkg):
    """A 6×6 family with a term of every persistable function kind (and
    a constant term), built by the package ``pkg`` alone."""
    alg, fam = _mod(pkg, "nlevp.algebra"), _mod(pkg, "nlevp.family")
    rng = np.random.default_rng(7)
    poles = np.array([-30 + 400j, -30 - 400j, -80.0])
    ss = alg.StateSpace(np.diag(poles), np.ones((3, 1)),
                        np.array([[2 + 1j, 2 - 1j, 0.5]]), 0.1)
    funcs = [((alg.pow2,), (("ω",),)),
             ((alg.ExpAz(0.2 + 0.1j),), (("ω",),)),
             ((alg.exp_delay,), (("ω", "τ"),)),
             ((alg.ExpPM(-1),), (("ω", "τ"),)),
             ((alg.exp_az2mzit,), (("ω", "τ", "a"),)),
             ((alg.SumYExpIKX([1.0, 0.5j, -0.25]),), (("ω",),)),
             ((ss,), (("ω",),)),
             ((alg.ZTimesG(ss),), (("ω",),)),
             ((alg.Product(alg.pow1, alg.ExpAz(-0.3j)),), (("ω",),)),
             ((alg.OneMinus(alg.ExpAz(0.05)),), (("ω",),)),
             ((alg.pow1, alg.exp_delay), (("ω",), ("ω", "τ"))),
             ((), ())]
    L = fam.OperatorFamily(["ω", "τ", "a", "λ"],
                           [0.0, 1e-3, -1e-6, complex("inf")])
    for k, (fs, ps) in enumerate(funcs):
        M = np.zeros((6, 6), complex)
        idx = rng.integers(0, 6, (8, 2))
        M[idx[:, 0], idx[:, 1]] = (rng.standard_normal(8)
                                   + 1j * rng.standard_normal(8))
        L.push(fam.Term(M, fs, ps, None, f"A{k}"))
    return L


def _active_family(pkg, n_rings=2, nz=10):
    mesh = _mod(pkg, "mesh.generate").rijke_mesh(n_rings=n_rings,
                                                 nz_cold=nz, nz_hot=nz)
    return _mod(pkg, "models.helmholtz").discretize(
        mesh, *active_rijke_setup(mesh))


def _assert_same_family(a, b):
    assert (a.eigval, a.auxval, list(a.active), a.mode) == \
        (b.eigval, b.auxval, list(b.active), b.mode)
    assert list(a.params) == list(b.params)
    for k in a.params:
        np.testing.assert_array_equal(a.params[k], b.params[k])
    assert len(a.terms) == len(b.terms)
    for s, t in zip(a.terms, b.terms):
        assert (s.symbol, s.operator, s.params) == \
            (t.symbol, t.operator, tuple(tuple(p) for p in t.params))
        assert [f.signature() for f in s.funcs] == \
            [f.signature() for f in t.funcs]
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(s.coeff, attr),
                                          getattr(t.coeff, attr))


def _assert_same_values(a, b, zs, orders=(0, 1, 2)):
    for z in zs:
        for k in orders:
            np.testing.assert_allclose(a(z, k).to_dense(),
                                       b(z, k).to_dense(), rtol=1e-14,
                                       atol=0)


@pytest.mark.parametrize("writer", [JAX, PORT])
def test_family_npz_crosses(tmp_path, writer):
    """save_family by one package, load_family by the other: the family
    with every function kind, term for term, and L(z) with its first two
    ω-derivatives; ``OperatorFamily.save`` and ``save`` dispatch to it."""
    reader = PORT if writer == JAX else JAX
    L = _kinds_family(writer)
    fname = str(tmp_path / "kinds.npz")
    if writer == PORT:
        save(fname, L)
    else:
        L.save(fname)
    L2 = _mod(reader, "nlevp.persist").load_family(fname)
    Lref = _kinds_family(reader)
    _assert_same_family(L2, Lref)
    _assert_same_values(L2, Lref, [300.0 + 20j, 1500.0 - 5j])


def test_family_npz_port_round_trip(tmp_path):
    """The 437-DOF active Rijke family through the port alone."""
    L = _active_family(PORT)
    L.save(str(tmp_path / "rijke.npz"))
    _assert_same_family(load_family(str(tmp_path / "rijke.npz")), L)


def _solution(pkg):
    """A Solution with both vectors, a Taylor array, a Padé pair and
    perturbed vectors, built by ``pkg``."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal(9) + 1j * rng.standard_normal(9)
    sol = _mod(pkg, "nlevp.family").Solution(
        {"ω": 1070 + 370j, "n": 1.0 + 0j, "λ": complex("inf")}, v,
        v.conj()[::-1], "ω", "λ")
    sol.eigval_pert["n/Taylor"] = rng.standard_normal(6) + 0j
    sol.eigval_pert["n/Pade"] = (np.arange(3) + 1j, np.arange(4) - 1j)
    sol.v_pert["n/Taylor"] = [v * k for k in range(4)]
    return sol


def _assert_same_solution(a, b):
    assert (a.eigval, list(a.params)) == (b.eigval, list(b.params))
    for k in a.params:
        np.testing.assert_array_equal(a.params[k], b.params[k])
    np.testing.assert_array_equal(a.v, b.v)
    if a.v_adj is None or b.v_adj is None:
        assert a.v_adj is None and b.v_adj is None
    else:
        np.testing.assert_array_equal(a.v_adj, b.v_adj)
    for da, db in ((a.eigval_pert, b.eigval_pert), (a.v_pert, b.v_pert)):
        assert list(da) == list(db)
        for k in da:
            x, y = da[k], db[k]
            if isinstance(x, tuple):
                assert isinstance(y, tuple)
                for xi, yi in zip(x, y):
                    np.testing.assert_array_equal(xi, yi)
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("writer", [JAX, PORT])
def test_solution_npz_crosses(tmp_path, writer):
    reader = PORT if writer == JAX else JAX
    fname = str(tmp_path / "sol.npz")
    _mod(writer, "nlevp.persist").save_solution(fname, _solution(writer))
    got = _mod(reader, "nlevp.persist").read_solution(fname)
    _assert_same_solution(got, _solution(reader))
    if reader == PORT:
        _assert_same_solution(read_sol(fname), got)
        assert read_solution is read_sol


@pytest.mark.parametrize("writer", [JAX, PORT])
def test_family_toml_crosses(tmp_path, writer):
    """save_family_toml by one package, load_family_toml by the other,
    on the 437-DOF active Rijke family (every term a named Julia
    function): equal term matrices and params, equal L(z)."""
    reader = PORT if writer == JAX else JAX
    L = _active_family(writer)
    fname = str(tmp_path / "rijke.toml")
    _mod(writer, "nlevp.toml_compat").save_family_toml(fname, L)
    L2 = _mod(reader, "nlevp.toml_compat").load_family_toml(fname)
    assert list(L2.params) == list(L.params)
    for k in L.params:
        np.testing.assert_array_equal(L2.params[k], L.params[k])
    assert len(L2.terms) == len(L.terms)
    for s, t in zip(L2.terms, L.terms):
        assert (s.symbol, s.operator, s.params) == \
            (t.symbol, t.operator, t.params)
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(s.coeff, attr),
                                          getattr(t.coeff, attr))
    L.params["ω"] = L2.params["ω"] = 2 * np.pi * 300
    _assert_same_values(L2, L, [2 * np.pi * (300 + 5j)], orders=(0, 1))


def test_toml_statespace_refused_before_writing(tmp_path):
    """A StateSpace term has no named Julia counterpart: the port raises
    the JAX package's ValueError and writes nothing."""
    from wavesandeigenvalues_jl_tpu.nlevp import \
        save_family_toml as save_family_toml_jax
    msgs = []
    for pkg, saver in ((JAX, save_family_toml_jax),
                       (PORT, save_family_toml)):
        fname = tmp_path / f"{pkg}.toml"
        with pytest.raises(ValueError) as err:
            saver(str(fname), _kinds_family(pkg))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "no named Julia counterpart" in msgs[1]
    assert not os.path.exists(tmp_path / f"{PORT}.toml")


def test_load_reference_written_family_twin(tmp_path):
    """The reference writer's output of tests/test_toml_compat.py: both
    packages load the same family; L(z) and its derivative as there."""
    ref = importlib.import_module("test_toml_compat")._REF_FAMILY
    fname = tmp_path / "fam.toml"
    fname.write_text(ref, encoding="utf-8")
    L = load_family_toml(str(fname))
    Lj = _mod(JAX, "nlevp.toml_compat").load_family_toml(str(fname))
    _assert_same_family(L, Lj)
    L.params["τ"] = 0.001
    z, tau = 2.0 + 1.0j, 0.001
    A = np.array([[1, 0], [0, -2 - 3j]], complex)
    B = np.array([[0, 0.5 + 0.25j], [0, 0]], complex)
    np.testing.assert_allclose(L(z).to_dense(),
                               z * A + np.exp(-1j * z * tau) * B, atol=1e-14)
    np.testing.assert_allclose(L(z, 1).to_dense(),
                               A + (-1j * tau) * np.exp(-1j * z * tau) * B,
                               atol=1e-14)


@pytest.mark.parametrize("text", [
    ":ω", "(:ω, :τ)", "[1, 2, 3]", "NaN + NaN*im", "1.0e+15-2.5im",
    "Complex{Float64}[1.0+0.0im,-1.0-1.0im,]", '"exp(-iωτ)"', "(pow1,)",
    "()", "Inf + 0.0*im", "((:ω,),(:ω, :τ),)", "-3.5im", "Complex{Float64}[]"])
def test_parse_julia_literals_twin(text):
    from wavesandeigenvalues_jl_tpu.nlevp.toml_compat import \
        _Parser as ParserJax
    from wavesandeigenvalues_jl_tpu_torch.nlevp.toml_compat import _Parser
    assert repr(_Parser(text).parse_value()) == \
        repr(ParserJax(text).parse_value())


def test_read_toml_stray_bracket_and_nonfinite(tmp_path):
    """The stray "]" of the reference writer (save.jl:14-16) is skipped;
    a fresh family's ω = NaN + NaN·im and λ = Inf are written '*im' and
    read back, as tests/test_toml_compat.py asks of the JAX package."""
    import re
    fname = tmp_path / "s.toml"
    fname.write_text("a=1\nv=[1.0+0.0im,]\n]\nb=2\n", encoding="utf-8")
    D = read_toml(str(fname))
    assert D["a"] == 1 and D["b"] == 2 and D["v"] == [1 + 0j]
    L = _mod(PORT, "nlevp.gallery").rijke_tube(8)[0]
    L.params["ω"] = complex(float("nan"), float("nan"))
    L.params["λ"] = complex(float("inf"), 0.0)
    out = str(tmp_path / "fresh.toml")
    save_family_toml(out, L)
    text = open(out, encoding="utf-8").read()
    assert not re.findall(r"(?:NaN|Inf)[^*\s,)]*im", text)
    assert "*im" in text
    for loader in (load_family_toml,
                   _mod(JAX, "nlevp.toml_compat").load_family_toml):
        assert np.isnan(loader(out).params["ω"].real)


@pytest.fixture(scope="module")
def solved_tube():
    """A solution of the gallery Rijke tube with its τ Taylor series
    (JAX host mslp and perturb_fast, tests/test_toml_compat.py:94)."""
    from wavesandeigenvalues_jl_tpu.nlevp import gallery, mslp, perturb_fast
    L, _ = gallery.rijke_tube(32)
    sol, _, flag = mslp(L, 1.0 + 0.3j, tol=1e-12, maxiter=30)
    assert flag >= 0
    perturb_fast(sol, L, "τ", 4)
    return sol


@pytest.mark.parametrize("writer", [JAX, PORT])
def test_solution_toml_crosses(tmp_path, solved_tube, writer):
    """save_solution_toml by one package, load_solution_toml by the
    other: a solved Solution with its Taylor series, and one without an
    adjoint vector (written 'Complex{Float64}[]')."""
    reader = PORT if writer == JAX else JAX
    tc_w, tc_r = (_mod(p, "nlevp.toml_compat") for p in (writer, reader))
    Sol = _mod(writer, "nlevp.family").Solution
    s = solved_tube
    for k, sol in enumerate([
            Sol(s.params, s.v, s.v_adj, s.eigval, s.auxval),
            Sol(s.params, s.v, None, s.eigval)]):
        if k == 0:
            sol.eigval_pert = dict(s.eigval_pert)
            sol.v_pert = dict(s.v_pert)
        fname = str(tmp_path / f"sol{k}.toml")
        tc_w.save_solution_toml(fname, sol)
        got = tc_r.load_solution_toml(fname)
        assert abs(got.params["ω"] - sol.params["ω"]) == 0
        np.testing.assert_array_equal(got.v, sol.v)
        if k == 1:
            assert got.v_adj is None
            assert "Complex{Float64}[]" in open(fname).read()
        else:
            key = "τ/Taylor"
            np.testing.assert_array_equal(np.asarray(got.eigval_pert[key]),
                                          np.asarray(sol.eigval_pert[key]))
            np.testing.assert_array_equal(np.stack(got.v_pert[key]),
                                          np.stack(sol.v_pert[key]))
        if reader == PORT:
            assert isinstance(load_solution_toml(fname), Solution)


def test_project_and_assemble_dense_twin():
    """project(L, Q) on an orthonormal Q and StackedOperator.assemble_dense
    against the JAX package's, to 1e-14."""
    from wavesandeigenvalues_jl_tpu.nlevp import project as project_jax
    L, Lj = _active_family(PORT), _active_family(JAX)
    rng = np.random.default_rng(11)
    Q, _ = np.linalg.qr(rng.standard_normal((L.size, 5))
                        + 1j * rng.standard_normal((L.size, 5)))
    P, Pj = project(L, Q), project_jax(Lj, Q)
    assert isinstance(P, OperatorFamily) and P.size == 5
    assert list(P.params) == list(Pj.params)
    for s, t in zip(P.terms, Pj.terms):
        assert s.symbol == t.symbol
        ref = t.coeff.to_dense()
        np.testing.assert_allclose(s.coeff.to_dense(), ref, rtol=0,
                                   atol=1e-14 * np.abs(ref).max())
    c = L.coefficients({})
    D, Dj = L._stack().assemble_dense(c), Lj._stack().assemble_dense(c)
    np.testing.assert_allclose(D, Dj, rtol=0, atol=1e-14 * np.abs(Dj).max())
    np.testing.assert_array_equal(D, L.assemble({}).to_dense())


def _rational(w):
    s = 1j * w
    return 2 / (s + 60) + (3 + 1j) / (s - (-40 + 900j)) + 0.2


FIT_CASES = {
    "rational": (np.linspace(20, 400, 80), 4,
                 lambda f: _rational(2 * np.pi * f), 1e-10),
    "delay band": (np.linspace(20, 400, 80), 10,
                   lambda f: np.exp(-1j * 2 * np.pi * f * 1.2e-3), 1e-5),
    "flame": (FIT_FREQS, 12,
              lambda f: np.exp(-1j * 2 * np.pi * f * FIT_TAU), 1e-6),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_matches_jax(case):
    """Poles, residues and D of the port's vector fit equal the JAX
    package's to 1e-12 relative; the fitted values meet the bars of
    tests/test_fitting.py; the poles are stable."""
    from wavesandeigenvalues_jl_tpu.nlevp.fitting import \
        fit_state_space as fit_jax
    freqs, order, fn, bar = FIT_CASES[case]
    data = fn(freqs)
    ss, fitted = fit_state_space(freqs, data, order=order)
    ssj, fittedj = fit_jax(freqs, data, order=order)
    for a, b in ((np.diag(ss.A), np.diag(ssj.A)), (ss.C, ssj.C),
                 (ss.D, ssj.D), (fitted, fittedj)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
    assert np.abs(fitted - data).max() / np.abs(data).max() < bar
    assert np.all(np.linalg.eigvals(ss.A).real < 0)


def test_fitted_derivatives_analytic():
    freqs, order, fn, _ = FIT_CASES["rational"]
    ss, _ = fit_state_space(freqs, fn(freqs), order=order)
    w0, h = 2 * np.pi * 123.0, 1e-4
    for k, fd, tol in [
            (1, (_rational(w0 + h) - _rational(w0 - h)) / (2 * h), 1e-6),
            (2, (_rational(w0 + h) - 2 * _rational(w0)
                 + _rational(w0 - h)) / h ** 2, 1e-3)]:
        an = ss.eval((w0,), (k,))
        assert abs(an - fd) < tol * max(abs(fd), 1e-12), (k, an, fd)


def test_fitted_flame_mslp_matches_jax():
    """tests/test_fitting.py:47-72 at 513 DOF (rijke_mesh(2, 12, 12)): the
    port's fitted flame through the port's mslp on the CPU gives JAX
    host's ω to 1e-10·|ω| at flag 0, and JAX host's ω of the built-in n–τ
    flame to 1e-3·|ω| (that test's criterion)."""
    from wavesandeigenvalues_jl_tpu.nlevp import mslp as mslp_jax
    from wavesandeigenvalues_jl_tpu.nlevp.fitting import \
        fit_state_space as fit_jax
    from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp
    z0, kw = 340 * 2 * np.pi, dict(maxiter=20, tol=1e-10)
    data = np.exp(-1j * 2 * np.pi * FIT_FREQS * FIT_TAU)
    oms = {}
    for pkg, fit in ((JAX, fit_jax), (PORT, fit_state_space)):
        ss, _ = fit(FIT_FREQS, data, order=12)
        mesh = _mod(pkg, "mesh.generate").rijke_mesh(n_rings=2, nz_cold=12,
                                                     nz_hot=12)
        dscrp, _ = active_rijke_setup(mesh)
        c = mesh.generate_field(lambda x, y, z: np.where(
            z < 0, np.sqrt(1.4 * 287.05 * 300.0),
            np.sqrt(1.4 * 287.05 * 1200.0)))
        head = dscrp["Flame"][1][:3] + ([0.0, 0.0, -0.0012],
                                        [0.0, 0.0, 1.0])
        disc = _mod(pkg, "models.helmholtz").discretize
        for kind, tail in (("fitted", (ss,)),
                           ("n-tau", ("n", "τ", 1.0, FIT_TAU))):
            if pkg == PORT and kind == "n-tau":
                continue
            L = disc(mesh, dict(dscrp, Flame=("flame", head + tail)), c)
            assert L.size == 513
            if pkg == JAX:
                sol, _, flag = mslp_jax(L, z0, **kw)
            else:
                sol, _, flag = mslp(L, z0, device="cpu", **kw)
            assert flag == 0, (pkg, kind)
            oms[pkg, kind] = sol.params["ω"]
    om = oms[PORT, "fitted"]
    assert abs(om - oms[JAX, "fitted"]) <= 1e-10 * abs(oms[JAX, "fitted"])
    assert abs(om - oms[JAX, "n-tau"]) < 1e-3 * abs(oms[JAX, "n-tau"])


class _Interruptible:
    """A family that raises after ``limit`` evaluations at derivative 0
    (tests/test_continuation_checkpoint.py:44)."""

    def __init__(self, L, limit):
        self.L, self.limit, self.calls = L, limit, 0

    @property
    def size(self):
        return self.L.size

    def __getattr__(self, name):
        return getattr(self.L, name)

    def __call__(self, *args, **kwargs):
        if len(args) == 1:
            self.calls += 1
            if self.calls > self.limit:
                raise KeyboardInterrupt("simulated preemption")
        return self.L(*args, **kwargs)


GAMMA_TUBE = [1.0 - 0.5j, 3.0 - 0.5j, 3.0 + 1.0j, 1.0 + 1.0j]


def test_moment_checkpoint_crosses_and_resumes(tmp_path):
    """A moment checkpoint written by the JAX package's interrupted
    compute_moment_matrices resumes in the port with fewer node solves
    and JAX's moments; a changed τ invalidates it."""
    from wavesandeigenvalues_jl_tpu.nlevp import \
        compute_moment_matrices as moments_jax
    from wavesandeigenvalues_jl_tpu_torch.nlevp import \
        compute_moment_matrices
    Lj = _mod(JAX, "nlevp.gallery").rijke_tube(24)[0]
    L = _mod(PORT, "nlevp.gallery").rijke_tube(24)[0]
    Lj.params["τ"] = L.params["τ"] = 0.2
    kw = dict(l=3, K=1, N=8)
    ck = str(tmp_path / "moments.npz")
    A_ref = moments_jax(Lj, GAMMA_TUBE, **kw)
    with pytest.raises(KeyboardInterrupt):
        moments_jax(_Interruptible(Lj, 10), GAMMA_TUBE, checkpoint=ck,
                    checkpoint_every=4, **kw)
    resumed = _Interruptible(L, 10 ** 9)
    A = compute_moment_matrices(resumed, GAMMA_TUBE, checkpoint=ck,
                                checkpoint_every=4, **kw)
    assert 0 < resumed.calls < 4 * 8
    np.testing.assert_allclose(A, A_ref, rtol=0, atol=1e-12)
    L.params["τ"] = Lj.params["τ"] = 0.35
    A = compute_moment_matrices(L, GAMMA_TUBE, checkpoint=ck, **kw)
    np.testing.assert_allclose(A, moments_jax(Lj, GAMMA_TUBE, **kw), rtol=0,
                               atol=1e-12)
