"""The port's Bloch and annular slice against the JAX package on the CPU:
``annular_halfcell``, ``extend_mesh`` and its ``SymInfo``, the P2
numbering, the Bloch-reduced and P2 families, the Bloch coefficient
functions, ``bloch_expand``, the unit-cell = full-annulus invariant
through the port's ``mslp(..., device="cpu")``, and the batched
wavenumber sweep.  Twins of tests/test_bloch.py:30,54,70,81,98,178 at the
JAX tests' sizes.  Each test states its tolerance against the JAX value.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import scipy.sparse as sp

import wavesandeigenvalues_jl_tpu.nlevp.algebra as algebra_jax
import wavesandeigenvalues_jl_tpu.ops.linsolve as linsolve_jax
import wavesandeigenvalues_jl_tpu_torch.nlevp.algebra as algebra
import wavesandeigenvalues_jl_tpu_torch.nlevp.polish as polish
import wavesandeigenvalues_jl_tpu_torch.ops.linsolve as linsolve
from wavesandeigenvalues_jl_tpu.mesh.annular import \
    bloch_expand as bloch_expand_jax
from wavesandeigenvalues_jl_tpu.nlevp import mslp as mslp_jax
from wavesandeigenvalues_jl_tpu.nlevp.bloch_sweep import \
    bloch_mode_sweep as sweep_jax
from wavesandeigenvalues_jl_tpu_torch.mesh import bloch_expand
from wavesandeigenvalues_jl_tpu_torch.models.rijke import active_rijke_setup
from wavesandeigenvalues_jl_tpu_torch.nlevp import bloch_mode_sweep, mslp
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local import \
    FusedPencilSolver
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
    FusedSlabPencilSolver
from wavesandeigenvalues_jl_tpu_torch.ops.device_solve import DeviceLU

from port_threads import one_thread  # noqa: F401


PKGS = ("wavesandeigenvalues_jl_tpu", "wavesandeigenvalues_jl_tpu_torch")
DSCRP = {"Interior": ("interior", ()), "Outlet": ("admittance", ("Y", 1e15))}
DOMS = [("Interior", "full"), ("Outlet", "full")]
#: ω of the port against JAX host mslp: the bar of tests/test_fused_slab.py
OMEGA_RTOL = 1e-8
#: the unit-cell = full-annulus bar of tests/test_bloch.py:66 (Hz)
UNIT_FULL_HZ = 1e-8
#: eigenvector residual bar of tests/test_bloch.py:96
RES_TOL = 1e-12
MSLP_KW = dict(tol=1e-11, scale=2 * np.pi, maxiter=25)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _pair(pkg, DOS=6, with_axis=False, doms=DOMS, **kw):
    """(half cell, unit cell, full annulus) built by package ``pkg``."""
    half = _mod(pkg, "mesh.generate").annular_halfcell(
        DOS=DOS, with_axis=with_axis, **kw)
    extend = _mod(pkg, "mesh.annular").extend_mesh
    return half, extend(half, doms, unit=True), extend(half, doms, unit=False)


def _c(mesh, c0=340.0):
    return mesh.generate_field(lambda x, y, z: c0 * np.ones_like(z))


def _family(pkg, mesh, order="lin", b=None, dscrp=DSCRP, C=None):
    discretize = _mod(pkg, "models.helmholtz").discretize
    return discretize(mesh, dscrp, _c(mesh) if C is None else C, order=order,
                      b=b)


def _slab(L):
    """Force the port's fused slab engine (K3's plain version on the CPU),
    which on these small families is ~10x faster on the CPU than the dense
    engine's plain GMRES."""
    L._fused_solver = (L._stack(), FusedSlabPencilSolver(L, "cpu"))
    return L


def _assert_mesh_equal(mj, mt):
    for attr in ("points", "lines", "triangles", "int_triangles",
                 "tetrahedra"):
        np.testing.assert_array_equal(getattr(mj, attr), getattr(mt, attr),
                                      err_msg=attr)
    assert list(mj.domains) == list(mt.domains)
    for k in mj.domains:
        assert mj.domains[k]["dimension"] == mt.domains[k]["dimension"]
        np.testing.assert_array_equal(mj.domains[k]["simplices"],
                                      mt.domains[k]["simplices"], err_msg=k)


@pytest.mark.parametrize("with_axis", [False, True])
def test_annular_halfcell_identical(with_axis):
    """The half cell of both packages, array for array."""
    mj, mt = (_mod(p, "mesh.generate").annular_halfcell(
        DOS=6, nr=2, nphi=2, nz=5, with_axis=with_axis) for p in PKGS)
    _assert_mesh_equal(mj, mt)
    assert mt.dos is None and mj.dos is None


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("with_axis", [False, True])
def test_extend_mesh_identical(with_axis, unit):
    """extend_mesh with all three copy degrees, array for array, and every
    SymInfo field (exact, the axis point and direction to 1e-15)."""
    doms = [("Interior", "full"), ("Outlet", "full"), ("Inlet", "unit"),
            ("Walls", "half")]
    mj, mt = (_pair(p, DOS=4 if with_axis else 6, with_axis=with_axis,
                    doms=doms, nr=2, nphi=2, nz=4)[1 if unit else 2]
              for p in PKGS)
    _assert_mesh_equal(mj, mt)
    dj, dt = dataclasses.asdict(mj.dos), dataclasses.asdict(mt.dos)
    assert dj.keys() == dt.keys()
    for k in dj:
        if k in ("n", "pnt"):
            np.testing.assert_allclose(dt[k], dj[k], rtol=0, atol=1e-15)
        else:
            assert dt[k] == dj[k], k
    assert type(mt.dos).__module__.startswith(PKGS[1])


def test_extend_mesh_counts():
    """Twin of tests/test_bloch.py:30 on the port."""
    doms = [("Interior", "full"), ("Outlet", "full"), ("Inlet", "unit")]
    half, unit, full = _pair(PKGS[1], doms=doms, nr=2, nphi=2, nz=5)
    dos = unit.dos
    assert dos.DOS == 6 and dos.naxis == 0
    assert unit.n_points == dos.naxis + dos.nxsector + dos.nxbloch
    assert full.n_points == dos.naxis + dos.nxsector * dos.DOS
    assert len(full.tetrahedra) == 2 * 6 * len(half.tetrahedra)
    assert "Inlet#0" in unit.domains
    assert all(f"Inlet#{s}" in full.domains for s in range(6))
    assert dos.nxsector_tet == 2 * len(half.tetrahedra)
    assert full.dos.nxsector_tet == len(full.tetrahedra) // 6
    assert dos.nxsector_tri == full.dos.nxsector_tri \
        == len(full.triangles) // 6 > 0


@pytest.mark.parametrize("mesh", ["box", "rijke"])
def test_aggregate_elements_quad(mesh):
    """P2 numbering (points, then the edges of collect_lines) on a box and
    on a small Rijke tube: identical arrays and dimension."""
    out = []
    for p in PKGS:
        gen = _mod(p, "mesh.generate")
        m = (gen.box_mesh(nx=2, ny=3, nz=2) if mesh == "box"
             else gen.rijke_mesh(n_rings=1, nz_cold=3, nz_hot=3))
        out.append((m, _mod(p, "fem.assembly").aggregate_elements(m, "quad")))
    (mj, (trj, tej, dj)), (mt, (trt, tet, dt)) = out
    assert dt == dj == mt.n_points + len(mt.lines)
    np.testing.assert_array_equal(mt.lines, mj.lines)
    np.testing.assert_array_equal(trt, trj)
    np.testing.assert_array_equal(tet, tej)
    # cached: a second call returns the same numbering
    again = _mod(PKGS[1], "fem.assembly").aggregate_elements(mt, "quad")
    np.testing.assert_array_equal(again[1], tet)


def _assert_family_equal(Lj, Lt, points):
    """Same terms (symbols, operators, CSR patterns; values to 1e-12 of
    each term's largest) and the same L(ω) and ∂_ω L(ω) at each (ω, b) of
    ``points``, to 1e-12 relative."""
    assert [t.symbol for t in Lt.terms] == [t.symbol for t in Lj.terms]
    assert [t.operator for t in Lt.terms] == [t.operator for t in Lj.terms]
    for tj, tt in zip(Lj.terms, Lt.terms):
        np.testing.assert_array_equal(tt.coeff.indptr, tj.coeff.indptr)
        np.testing.assert_array_equal(tt.coeff.indices, tj.coeff.indices)
        np.testing.assert_allclose(
            tt.coeff.data, tj.coeff.data, rtol=0,
            atol=1e-12 * np.abs(tj.coeff.data).max())
    for om, b in points:
        for L in (Lj, Lt):
            if b is not None:
                L.params["b"] = b
        cj, ct = Lj.coefficients(), Lt.coefficients()
        np.testing.assert_allclose(ct, cj, rtol=1e-12, atol=1e-300)
        for derivs in ((), (1,)):
            Aj, At = Lj(om, *derivs), Lt(om, *derivs)
            scale = np.abs(Aj.data).max()
            assert np.abs(At.to_dense() - Aj.to_dense()).max() \
                <= 1e-12 * scale


@pytest.mark.parametrize("order", ["lin", "quad"])
@pytest.mark.parametrize("with_axis", [False, True])
def test_bloch_family_identical(with_axis, order):
    """The Bloch-reduced unit-cell family (up to 6 classes per operator,
    the axis penalty with the axis, the mass weighting) and the full
    annulus's family, P1 and P2, at a few (ω, b)."""
    DOS = 4 if with_axis else 6
    pair = [_pair(p, DOS=DOS, with_axis=with_axis, nr=2, nphi=2, nz=3)
            for p in PKGS]
    Lj, Lt = (_family(p, m[1], order, b="b") for p, m in zip(PKGS, pair))
    assert Lt.size == Lj.size
    assert ("D" in [t.operator for t in Lt.terms]) == with_axis
    pts = [(2 * np.pi * 300, 0.0), (2 * np.pi * (310 + 4j), 1.0),
           (2 * np.pi * 900, DOS - 1.0)]
    _assert_family_equal(Lj, Lt, pts)
    Fj, Ft = (_family(p, m[2], order) for p, m in zip(PKGS, pair))
    _assert_family_equal(Fj, Ft, [(2 * np.pi * (310 + 4j), None)])


def test_p2_rijke_family_identical():
    """discretize(order="quad") of the active Rijke description (interior,
    admittance, n–τ flame) on a small tube."""
    Ls = []
    for p in PKGS:
        m = _mod(p, "mesh.generate").rijke_mesh(n_rings=1, nz_cold=4,
                                                nz_hot=4)
        Ls.append(_mod(p, "models.helmholtz").discretize(
            m, *active_rijke_setup(m), order="quad"))
    _assert_family_equal(*Ls, [(2 * np.pi * (340 + 20j), None)])


def _bloch_funcs(mod):
    filt = mod.SumYExpIKX(np.fft.fft(np.eye(6)[0] / 6))
    e = mod.ExpAz(1j * 2 * np.pi / 6)
    return [e, filt, mod.Product(filt, e), mod.OneMinus(filt)]


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_bloch_scalar_funcs(k):
    """ExpAz, SumYExpIKX, Product and OneMinus at derivative order k, at
    real and complex arguments, to 1e-13 relative (and the same symbols
    and signatures)."""
    for fj, ft in zip(_bloch_funcs(algebra_jax), _bloch_funcs(algebra)):
        assert ft.signature() == fj.signature()
        assert ft.symbol(("b",)) == fj.symbol(("b",))
        for z in (0.0, 1.0, 2.5 - 0.3j):
            vj, vt = fj(z, k), ft(z, k)
            assert abs(vt - vj) <= 1e-13 * max(abs(vj), 1.0), (ft, z, k)


def _unit_full(with_axis, order, DOS):
    """ω of the unit cell at b = 1 and of the full annulus from its
    frequency: the port (slab engine, CPU) and JAX host mslp."""
    out = {}
    for p in PKGS:
        _, unit, full = _pair(p, DOS=DOS, with_axis=with_axis, nr=2,
                              nphi=2, nz=3 if order == "quad" else 4)
        lu = _family(p, unit, order, b="b")
        lf = _family(p, full, order)
        lu.params["b"] = 1.0
        if p == PKGS[1]:
            solve = lambda L, f: mslp(_slab(L), f, device="cpu", **MSLP_KW)
        else:
            solve = lambda L, f: mslp_jax(L, f, **MSLP_KW)
        su, _, flu = solve(lu, 330.0)
        sf, _, flf = solve(lf, (su.params["ω"] / 2 / np.pi).real)
        out[p] = (su.params["ω"], sf.params["ω"], flu, flf)
    return out


@pytest.mark.parametrize("with_axis,order", [(False, "lin"), (True, "lin"),
                                             (True, "quad")])
def test_unit_equals_full(with_axis, order):
    """Twins of tests/test_bloch.py:54,70: the b = 1 unit-cell frequency
    equals the full annulus's to 1e-8 Hz, through the port's mslp on the
    CPU (P1 with and without the axis, P2 with it), and each ω is within
    1e-8·|ω| of JAX host mslp's; flags 0."""
    out = _unit_full(with_axis, order, 4 if with_axis else 6)
    wu, wf, flu, flf = out[PKGS[1]]
    wu_j, wf_j, _, _ = out[PKGS[0]]
    assert flu == flf == 0
    assert abs(wu - wf) / 2 / np.pi < UNIT_FULL_HZ
    assert abs(wu - wu_j) <= OMEGA_RTOL * abs(wu_j)
    assert abs(wf - wf_j) <= OMEGA_RTOL * abs(wf_j)


def _sparse(A):
    return sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)


@pytest.mark.parametrize("order", ["lin", "quad"])
def test_bloch_expand(order):
    """Twins of tests/test_bloch.py:81,98: bloch_expand of the port's b = 1
    unit-cell eigenvector equals JAX's expansion of the same vector (to
    1e-15 of its norm) and is an eigenvector of the port's full family:
    ‖L_full(ω)v‖ / (‖v‖·‖L_full(ω)‖_F) ≤ 1e-12, computed sparse."""
    quad = order == "quad"
    kw = dict(DOS=4, with_axis=True, nr=2, nphi=2, nz=3) if quad \
        else dict(DOS=6, nr=2, nphi=2, nz=4)
    _, uj, fj = _pair(PKGS[0], **kw)
    _, ut, ft = _pair(PKGS[1], **kw)
    lu = _slab(_family(PKGS[1], ut, order, b="b"))
    lu.params["b"] = 1.0
    sol, _, flag = mslp(lu, 330.0, device="cpu", **MSLP_KW)
    assert flag == 0
    extra = dict(full_mesh=ft) if quad else {}
    v = bloch_expand(ut, sol, "b", **extra)
    v_j = bloch_expand_jax(uj, sol.v, 1.0, **(dict(full_mesh=fj) if quad
                                              else {}))
    assert len(v) == ft.n_points + (len(ft.lines) if quad else 0)
    assert np.abs(v - v_j).max() <= 1e-15 * np.linalg.norm(v_j)
    A = _sparse(_family(PKGS[1], ft, order)(sol.params["ω"]))
    res = np.linalg.norm(A @ v) / (np.linalg.norm(v)
                                   * sp.linalg.norm(A, "fro"))
    assert res < RES_TOL, res


def test_sweep_matches_jax_and_mslp():
    """Twin of tests/test_bloch.py:178: the port's batched sweep on the CPU
    against JAX's sweep (ω to 1e-12 relative, same flags and steps) and
    against the port's per-b mslp (to 1e-8·|ω|), with verified residuals
    (≤ 1e-10, the JAX test's bar)."""
    bvals = [0.0, 1.0, 2.0, 3.0]
    kw = dict(tol=1e-10, scale=2 * np.pi, maxiter=25)
    lj, lt = (_family(p, _pair(p, nr=2, nphi=2, nz=4)[1], b="b")
              for p in PKGS)
    swept = bloch_mode_sweep(lt, 1124.0, bvals, device="cpu", **kw)
    swept_j = sweep_jax(lj, 1124.0, bvals, **kw)
    _slab(lt)
    for b, (sol, its, flag), (sj, its_j, flag_j) in zip(bvals, swept,
                                                         swept_j):
        om, om_j = sol.params["ω"], sj.params["ω"]
        assert flag == flag_j == 0 and its == its_j
        assert abs(om - om_j) <= 1e-12 * abs(om_j), (b, om, om_j)
        lt.params["b"] = b
        ref, _, flag_m = mslp(lt, 1124.0, device="cpu", **kw)
        assert flag_m == 0
        assert abs(om - ref.params["ω"]) <= OMEGA_RTOL * abs(om), b
        A = _sparse(lt(om))
        res = (np.linalg.norm(A @ sol.v) / np.linalg.norm(sol.v)
               / sp.linalg.norm(A, "fro"))
        assert res < 1e-10, (b, res)


class _ZeroPivotLU(DeviceLU):
    """A device factor with a zero pivot, as ``DeviceLU`` reports one."""
    ok = False


def test_sweep_polish_refusal():
    """JAX wraps the sweep's seed and polish in ``except Exception``; the
    port narrows it to (RuntimeError, LinAlgError).  With every polish
    ``factorize`` raising RuntimeError (the seeds' factorizations pass)
    and, in the port, the device factor its polish tries first reporting
    a zero pivot, both packages keep the device iterate: the same ω to
    1e-9 relative and within 1e-6 of the polished value.  A TypeError
    propagates from the port, which restores L.active, L.mode and b."""
    bvals = [0.0, 1.0]
    kw = dict(tol=1e-10, scale=2 * np.pi, maxiter=25)
    lj, lt = (_family(p, _pair(p, nr=2, nphi=2, nz=4)[1], b="b")
              for p in PKGS)
    polished = [s.params["ω"] for s, _, _ in
                bloch_mode_sweep(lt, 1124.0, bvals, device="cpu", **kw)]

    def refusing(real, exc, calls):
        def factorize(*args, **kwargs):
            calls.append(1)
            if len(calls) > len(bvals):      # past the seeds
                raise exc("Factor is exactly singular")
            return real(*args, **kwargs)
        return factorize

    mp = pytest.MonkeyPatch()
    real_j, real_t = linsolve_jax.factorize, linsolve.factorize
    calls_j, calls_t = [], []
    try:
        mp.setattr(linsolve_jax, "factorize",
                   refusing(real_j, RuntimeError, calls_j))
        refuse_t = refusing(real_t, RuntimeError, calls_t)
        mp.setattr(linsolve, "factorize", refuse_t)        # the seeds
        mp.setattr(polish, "factorize", refuse_t)
        mp.setattr(polish, "DeviceLU", _ZeroPivotLU)
        kept_j = sweep_jax(lj, 1124.0, bvals, **kw)
        kept = bloch_mode_sweep(lt, 1124.0, bvals, device="cpu", **kw)
        assert len(calls_t) == len(calls_j) == 2 * len(bvals)
        for (s, _, f), (sj, _, fj), om in zip(kept, kept_j, polished):
            assert f == fj == 0
            assert abs(s.params["ω"] - sj.params["ω"]) <= 1e-9 * abs(om)
            assert abs(s.params["ω"] - om) <= 1e-6 * abs(om)

        refuse_t = refusing(real_t, TypeError, [])
        mp.setattr(linsolve, "factorize", refuse_t)
        mp.setattr(polish, "factorize", refuse_t)
        lt.params["b"] = 0.5
        lt.mode, lt.active = "all", ["ω"]
        with pytest.raises(TypeError):
            bloch_mode_sweep(lt, 1124.0, bvals, device="cpu", **kw)
        assert lt.params["b"] == 0.5
        assert (lt.mode, lt.active) == ("all", ["ω"])
    finally:
        mp.undo()


def test_fused_engines_over_b():
    """The fused engine cached on L is keyed by L._stack(), which b does
    not change: a b = 6 solve after b = 0 on the cached slab engine equals
    a fresh engine's bit for bit (12 sectors).  The dense engine (K2's
    plain version) on a b = 1 unit cell gives JAX host's ω to
    1e-8·|ω|."""
    _, unit, _ = _pair(PKGS[1], DOS=12, nr=2, nphi=2, nz=3)
    L = _slab(_family(PKGS[1], unit, b="b"))
    engine = L._fused_solver[1]
    L.params["b"] = 0.0
    s0, _, f0 = mslp(L, 330.0, device="cpu", **MSLP_KW)
    L.params["b"] = 6.0
    s6, n6, f6 = mslp(L, 900.0, device="cpu", **MSLP_KW)
    assert L._fused_solver[1] is engine
    _slab(L)
    fresh, n_fr, f_fr = mslp(L, 900.0, device="cpu", **MSLP_KW)
    assert f0 == f6 == f_fr == 0 and n6 == n_fr
    assert s6.params["ω"] == fresh.params["ω"]
    np.testing.assert_array_equal(s6.v, fresh.v)

    lj, lt = (_family(p, _pair(p, nr=2, nphi=2, nz=4)[1], b="b")
              for p in PKGS)
    for L in (lj, lt):
        L.params["b"] = 1.0
    sol, _, flag = mslp(lt, 330.0, device="cpu", **MSLP_KW)
    assert isinstance(lt._fused_solver[1], FusedPencilSolver)
    ref, _, _ = mslp_jax(lj, 330.0, **MSLP_KW)
    assert flag == 0
    assert abs(sol.params["ω"] - ref.params["ω"]) \
        <= OMEGA_RTOL * abs(ref.params["ω"])
