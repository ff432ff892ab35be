#!/usr/bin/env python3
"""Reference values of the JAX package, computed on the CPU, for paths F
to J of ``chip_smoke.py`` (the PyTorch port holds itself against them).

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py hierarchy
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py beyn55k
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py panel2 OUT.npz
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py track
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py bloch
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py frontends [PART]
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py io

* ``hierarchy``: n and nnz of the passive Rijke family on
  ``rijke_mesh(n_rings=3, nz_cold=12, nz_hot=12)`` and its first and second
  octosplit (999, 7,415 and 55,401 DOF).
* ``beyn55k``: JAX host Beyn (complex128 SuperLU per node) on the
  55,401-DOF family over path D's contour (``OMEGA_55K``).
* ``panel2``: the JAX ``ShiftedPanelSolver`` with
  ``MultiGrid([L1, L0], [P1, P0], bs=64)`` at 55,401 DOF on the first two
  contour nodes and Beyn's l = 8 probe block: its restarts, its relres, its
  timings; X is written to OUT.npz for the port's run on the same input.
* ``track``: JAX ``track_branch`` on the "host" backend over τ in
  ``linspace(1e-3, 2e-3, 6)`` on the 4,087-DOF active family from 340·2π,
  order 2, each point's ω, flag and jet, and the two-point Padé
  ``multipoint_pade(2, 3, ...)`` of the first two jets at their midpoint.
* ``bloch``: the annular combustor of path H, ``annular_halfcell(DOS=12,
  nr=4, nphi=4, nz=48)`` extended to its unit cell (1,960 DOF once
  reduced) and its full annulus (23,520 DOF), c = 347 m/s below z = 0.2 m
  and 850 m/s above (per tet), ``Outlet`` Y = 1e15: JAX host ``mslp`` at
  b = 0…6 from ``BLOCH_GUESSES``, the full annulus from the b = 1
  frequency, ``bloch_mode_sweep`` from the same guesses, the 984-DOF cell
  (nr=3, nphi=3, nz=40) at b = 1 from 426 Hz, and the sweep and per-b
  ``mslp`` from one scalar guess of 280 Hz (ROADMAP.md Queue 3, F5).
* ``frontends``: path I, every front-end, JAX host on the CPU (PART one of
  ``flames``, ``hermite``, ``ape``, ``network``, ``shape``; all without):
  I1 the 7,259-DOF active Rijke with the scalar ``fancyflame``, tutorial
  08's custom n–τ FTF and a two-branch list ``fancyflame``; I2 the active
  Rijke on ``rijke_mesh(3, 17, 17)`` with Hermite elements (19,674 DOF, or
  ``rijke_mesh(2, 10, 10)``, 5,706 DOF, where JAX host does not reach flag
  0 there) and its ``get_p``/``get_n_grad_p`` at the flame's reference
  point; I3 the APE duct of tutorial 11 on ``box_mesh(0.25, 0.25, 1.0, 4,
  4, 24)`` with its Hermite potential flow (12,532 DOF); I4 tutorial 12's
  three networks (``mslp`` and, for the duct, Beyn); I5 the 1,369-DOF
  active Rijke's ``householder(order=2)``, its discrete-adjoint shape
  sensitivity over every surface point and the finite differences at six
  (one point a call: F6). ``f7`` (not in the default set) runs the
  quiescent APE duct through the dense fused engine of both packages
  (ROADMAP.md Queue 3, F7).
* ``io``: path J2, the fitted flame of ``tests/test_fitting.py:47-72``
  (vector fitting of the noise-free n–τ response, τ 1e-3, order 12, 120
  points from 100 to 600 Hz) on the 7,259-DOF Rijke
  (``rijke_mesh(4, 58, 58)``, speed of sound per point, flame referenced
  1.2 mm upstream): the fit's largest error, JAX host ``mslp`` from 340·2π
  (maxiter 20, tol 1e-10) with the fitted flame and with the built-in n–τ
  flame.
"""
import sys
import time

import numpy as np

from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
from wavesandeigenvalues_jl_tpu.mesh.refine import octosplit, p1_prolongation
from wavesandeigenvalues_jl_tpu.models import discretize

#: path D's contour: 150–1000 Hz at ±5 Hz, 24 nodes an edge
CONTOUR = [2 * np.pi * (150 - 5j), 2 * np.pi * (1000 - 5j),
           2 * np.pi * (1000 + 5j), 2 * np.pi * (150 + 5j)]
BEYN_KW = dict(l=8, N=24, rtol=1e-12, res_tol=1e-6)
GAMMA, R_GAS = 1.4, 287.05


def _c(x, y, z):
    return np.where(z < 0, np.sqrt(GAMMA * R_GAS * 300.0),
                    np.sqrt(GAMMA * R_GAS * 1200.0))


def passive(mesh):
    """The passive Rijke family of the JAX bench's large operator: speed
    of sound per point, outlet admittance 1e15, no flame."""
    return discretize(mesh, {"Interior": ("interior", ()),
                             "Outlet": ("admittance", ("Y", 1e15))},
                      mesh.generate_field(_c, order="lin"))


def hierarchy():
    """(families L0, L1, L2, prolongations P0, P1) of path F."""
    m0 = rijke_mesh(n_rings=3, nz_cold=12, nz_hot=12)
    P0 = p1_prolongation(m0)
    m1 = octosplit(m0)
    P1 = p1_prolongation(m1)
    m2 = octosplit(m1)
    return [passive(m) for m in (m0, m1, m2)], (P0, P1)


def cmd_hierarchy():
    (L0, L1, L2), _ = hierarchy()
    for L in (L0, L1, L2):
        print(f"n={L.size} nnz={L._stack().nnz} K={len(L.terms)}")


def cmd_beyn55k():
    from wavesandeigenvalues_jl_tpu.nlevp import beyn
    (_, _, L2), _ = hierarchy()
    t0 = time.perf_counter()
    Om, P = beyn(L2, CONTOUR, backend="host", **BEYN_KW)
    print(f"n={L2.size}: {time.perf_counter() - t0:.1f} s")
    print("OMEGA_55K =", tuple(complex(z) for z in Om))


def cmd_panel2(out):
    from wavesandeigenvalues_jl_tpu.nlevp.solvers import (gauss_nodes,
                                                          initialize_V)
    from wavesandeigenvalues_jl_tpu.ops.panel_solve import (MultiGrid,
                                                            ShiftedPanelSolver)
    (L0, L1, L2), (P0, P1) = hierarchy()
    mg = MultiGrid([L1, L0], [P1, P0], bs=64)
    zs = gauss_nodes(CONTOUR, BEYN_KW["N"])[0][:2]
    V = initialize_V(L2.size, BEYN_KW["l"])
    solver = ShiftedPanelSolver(L2, coarse=mg)
    t0 = time.perf_counter()
    X, info = solver.solve(zs, V, output=True)
    print(f"n={L2.size} shifts {len(zs)} l={V.shape[1]}: "
          f"{time.perf_counter() - t0:.1f} s | max relres "
          f"{info['max_relres']:.3e} | restarts a solve "
          f"{info['restarts_per_solve']:.3f} | timings {info['timings']}")
    print("relres", info["relres"].tolist())
    np.savez(out, zs=zs, X=X, relres=info["relres"],
             restarts=info["restarts_per_solve"])


def cmd_track():
    from wavesandeigenvalues_jl_tpu.nlevp import multipoint_pade
    from wavesandeigenvalues_jl_tpu.nlevp.continuation import track_branch
    m = rijke_mesh(n_rings=4, nz_cold=32, nz_hot=32)
    c = m.generate_field(_c, order="const")
    q02u0 = (101325.0 * (1200.0 / 300.0 - 1) * np.pi * 0.025 ** 2 * GAMMA
             / (GAMMA - 1))
    L = discretize(m, {
        "Interior": ("interior", ()),
        "Outlet": ("admittance", ("Y", 1e15)),
        "Flame": ("flame", (GAMMA, 1.225, q02u0, [0.0, 0.0, -0.0101],
                            [0.0, 0.0, 1.0], "n", "τ", 1.0, 1e-3))}, c)
    taus = np.linspace(1e-3, 2e-3, 6)
    t0 = time.perf_counter()
    sols, flags = track_branch(L, "τ", taus, 340 * 2 * np.pi, order=2)
    print(f"n={L.size}: {time.perf_counter() - t0:.1f} s")
    print("TRACK_4087_OMEGA =", tuple(complex(s.params["ω"]) for s in sols))
    print("TRACK_4087_FLAGS =", tuple(flags))
    jets = [np.asarray(s.eigval_pert["τ/Taylor"]) for s in sols[:2]]
    print("TRACK_4087_JETS =", [tuple(complex(x) for x in j) for j in jets])
    r = multipoint_pade(2, 3, [(taus[0], jets[0]), (taus[1], jets[1])])
    print("PADE2PT_4087 =", complex(r(0.5 * (taus[0] + taus[1]))))


#: path H: per-b guesses (Hz) for b = 0…6, and the scalar guess of F5
BLOCH_GUESSES = (337.0, 426.0, 593.0, 782.0, 980.0, 1184.0, 1393.0)
BLOCH_SCALAR_GUESS = 280.0
BLOCH_DSCRP = {"Interior": ("interior", ()),
               "Outlet": ("admittance", ("Y", 1e15))}
BLOCH_DOMS = [("Interior", "full"), ("Outlet", "full")]


def bloch_families(nr, nphi, nz, full=True):
    """(unit family with b, full family or None) on the 12-sector
    annulus of path H."""
    from wavesandeigenvalues_jl_tpu.mesh.annular import extend_mesh
    from wavesandeigenvalues_jl_tpu.mesh.generate import annular_halfcell
    half = annular_halfcell(DOS=12, nr=nr, nphi=nphi, nz=nz)
    out = []
    for unit in (True, False) if full else (True,):
        m = extend_mesh(half, BLOCH_DOMS, unit=unit)
        c = m.generate_field(lambda x, y, z: np.where(z < 0.2, 347.0, 850.0),
                             order="const")
        out.append(discretize(m, BLOCH_DSCRP, c, b="b" if unit else None))
    return out[0], (out[1] if full else None)


def cmd_bloch():
    from wavesandeigenvalues_jl_tpu.nlevp import mslp
    from wavesandeigenvalues_jl_tpu.nlevp.bloch_sweep import bloch_mode_sweep
    kw = dict(tol=1e-11, scale=2 * np.pi, maxiter=30)
    lu, Lf = bloch_families(4, 4, 48)
    print(f"unit n={lu.size}, full n={Lf.size}")
    om, flags = [], []
    t0 = time.perf_counter()
    for b, f0 in enumerate(BLOCH_GUESSES):
        lu.params["b"] = float(b)
        sol, n, flag = mslp(lu, f0, **kw)
        om.append(complex(sol.params["ω"]))
        flags.append(flag)
        print(f"b={b}: {sol.params['ω'] / 2 / np.pi} Hz, {n} its, flag {flag}")
    print(f"per-b mslp: {time.perf_counter() - t0:.1f} s")
    print("BLOCH_1960_OMEGA =", tuple(om))
    print("BLOCH_1960_FLAGS =", tuple(flags))
    f1 = om[1].real / 2 / np.pi
    t0 = time.perf_counter()
    solf, n, flag = mslp(Lf, f1, **kw)
    print(f"full from {f1!r} Hz: {n} its, flag {flag}, "
          f"{time.perf_counter() - t0:.1f} s, |f_unit - f_full| "
          f"{abs(om[1] - solf.params['ω']) / 2 / np.pi:.3e} Hz")
    print("BLOCH_23520_OMEGA =", complex(solf.params["ω"]))
    t0 = time.perf_counter()
    sw = bloch_mode_sweep(lu, np.asarray(BLOCH_GUESSES), range(7), **kw)
    print(f"sweep: {time.perf_counter() - t0:.1f} s, its "
          f"{[n for _, n, _ in sw]}, flags {[f for _, _, f in sw]}")
    print("BLOCH_SWEEP_OMEGA =", tuple(complex(s.params["ω"])
                                       for s, _, _ in sw))
    l984, _ = bloch_families(3, 3, 40, full=False)
    l984.params["b"] = 1.0
    sol, n, flag = mslp(l984, 426.0, **kw)
    print(f"n={l984.size} b=1: {n} its, flag {flag}")
    print("BLOCH_984_OMEGA =", complex(sol.params["ω"]))
    # F5: one scalar guess for every b
    sw = bloch_mode_sweep(lu, BLOCH_SCALAR_GUESS, range(7), **kw)
    for b, (s, _, _) in enumerate(sw):
        lu.params["b"] = float(b)
        ref, _, flag = mslp(lu, BLOCH_SCALAR_GUESS, **kw)
        fs, fm = s.params["ω"] / 2 / np.pi, ref.params["ω"] / 2 / np.pi
        print(f"F5 b={b}: sweep {fs.real:.3f} Hz, mslp {fm.real:.3f} Hz "
              f"(flag {flag}), gap {abs(fs - fm) / abs(fm):.3%}")


#: path I: the active Rijke flame's data (``models/rijke.py`` of the port)
Q02U0 = 101325.0 * (1200.0 / 300.0 - 1) * np.pi * 0.025 ** 2 * GAMMA / (
    GAMMA - 1)
FLAME_HEAD = (GAMMA, 1.225, Q02U0, [0.0, 0.0, -0.0101], [0.0, 0.0, 1.0])
#: the second point that normalises I2's point values
X_NORM = [0.01, 0.0, -0.2]
#: I1's mslp and I2's (JAX host stalls above tol 1e-10 on Hermite)
I1_KW = dict(maxiter=30, tol=1e-10)
I2_KW = dict(maxiter=30, tol=1e-8)
FANCY_LIST = (["n1", "n2"], ["τ1", "τ2"], ["a1", "a2"], [0.7, 0.3],
              [1e-3, 1.5e-3], [-1e-8, -2e-8])
APE_Q = 0.05
NET_C, NET_A = 347.0, 0.01


def active(mesh, flame=None, order="lin"):
    """The active Rijke family on ``mesh`` with its Flame descriptor
    replaced by ``flame`` (kind, data) where given."""
    dscrp = {"Interior": ("interior", ()),
             "Outlet": ("admittance", ("Y", 1e15)),
             "Flame": flame or ("flame", FLAME_HEAD + ("n", "τ", 1.0, 1e-3))}
    return discretize(mesh, dscrp, mesh.generate_field(_c, order="const"),
                      order=order), dscrp


def _solve(L, z0, kw, label, symbol="ω"):
    from wavesandeigenvalues_jl_tpu.nlevp import mslp
    t0 = time.perf_counter()
    sol, n, flag = mslp(L, z0, **kw)
    print(f"{label}: n={L.size} {n} steps flag {flag} "
          f"{time.perf_counter() - t0:.1f} s {symbol}={sol.params[symbol]!r}",
          flush=True)
    return sol, n, flag


def part_flames():
    from wavesandeigenvalues_jl_tpu.nlevp.algebra import (ScalarFunc,
                                                          exp_delay)

    class NTauFTF(ScalarFunc):
        nargs = 1

        def __init__(self, n, tau):
            self.n, self.tau = n, tau

        def eval(self, values, orders):
            (z,), (k,) = values, orders
            return self.n * exp_delay.eval((z, self.tau), (k, 0))

    m = rijke_mesh(n_rings=4, nz_cold=58, nz_hot=58)
    z0 = 340 * 2 * np.pi
    for name, flame in (
            ("FANCY", ("fancyflame", FLAME_HEAD + ("n", "τ", "a", 1.0, 1e-3,
                                                   -1e-8))),
            ("CUSTOM", ("flame", FLAME_HEAD + (NTauFTF(1.0, 1e-3),))),
            ("FANCY_LIST", ("fancyflame", FLAME_HEAD + FANCY_LIST))):
        L, _ = active(m, flame)
        sol, _, _ = _solve(L, z0, I1_KW, name)
        print(f"OMEGA_7259_{name} =", complex(sol.params["ω"]))


def part_hermite():
    from wavesandeigenvalues_jl_tpu.fem import get_n_grad_p, get_p
    z0 = 340 * 2 * np.pi
    for rings, nz in ((3, 17), (2, 10)):
        m = rijke_mesh(n_rings=rings, nz_cold=nz, nz_hot=nz)
        t0 = time.perf_counter()
        L, _ = active(m, order="herm")
        print(f"hermite rijke_mesh({rings}, {nz}, {nz}): n={L.size} nnz="
              f"{L._stack().nnz} discretize {time.perf_counter() - t0:.1f} s",
              flush=True)
        sol, n, flag = _solve(L, z0, I2_KW, f"HERM_{L.size}")
        if flag != 0:
            continue
        x_ref, n_ref = FLAME_HEAD[3], FLAME_HEAD[4]
        pn = get_p(m, sol.v, X_NORM)
        print(f"OMEGA_HERM_{L.size} =", complex(sol.params["ω"]))
        print(f"HERM_{L.size}_POINT =",
              (complex(get_p(m, sol.v, x_ref) / pn),
               complex(get_n_grad_p(m, sol.v, x_ref, n_ref) / pn)))
        break


def part_ape():
    from wavesandeigenvalues_jl_tpu.mesh.generate import box_mesh
    from wavesandeigenvalues_jl_tpu.models import ape, compute_potflow_field
    m = box_mesh(lx=0.25, ly=0.25, lz=1.0, nx=4, ny=4, nz=24)
    m.collect_lines()
    bc = {"Zmin": APE_Q, "Zmax": -APE_Q}
    t0 = time.perf_counter()
    U = compute_potflow_field(m, bc, order="lin")
    L = ape.discretize(m, bc, U=U)
    print(f"APE: potential flow + discretize {time.perf_counter() - t0:.1f} "
          f"s, U_z {U[2].mean()!r} ± {U[2].std():.3e}", flush=True)
    c = np.sqrt(ape.AMBIENT_GAMMA * ape.AMBIENT_P / ape.AMBIENT_RHO)
    sol, _, _ = _solve(L, 1j * np.pi * c * 1.05, dict(maxiter=30, tol=1e-9),
                       "APE", "s")
    print("S_APE =", complex(sol.params["s"]))


def networks():
    """tutorial 12's networks: (name, element list, params) in order."""
    C, A = NET_C, NET_A
    return [
        ("duct", [("unode", (C, A)), ("duct", (1.0, C, A)),
                  ("pnode", (C, A))]),
        ("rijke", [("unode", (C, A)), ("duct", (0.5, C, A)),
                   ("flame", (C, 2 * C, A)), ("duct", (0.5, 2 * C, A)),
                   ("pnode", (2 * C, A))]),
        ("damper", [("unode", (C, A)), ("duct", (0.5, C, A)),
                    ("helmholtz", (1e-4, 0.02, 0.005, C, A)),
                    ("duct", (0.5, C, A)), ("pnode", (C, A))]),
    ]


NET_GAMMA = 2 * np.pi * np.array([20 + 20j, 20 - 20j, 500 - 20j, 500 + 20j])


def part_network():
    from wavesandeigenvalues_jl_tpu.models import discretize_network
    from wavesandeigenvalues_jl_tpu.nlevp import beyn
    nets = dict(networks())
    L = discretize_network(nets["duct"])
    Om, _ = beyn(L, NET_GAMMA, l=6, K=2, N=64, res_tol=1e-6)
    print("NET_DUCT_BEYN =", tuple(complex(z) for z in Om))
    sol, _, _ = _solve(L, 2 * np.pi * 80.0, dict(maxiter=30, tol=1e-10),
                       "duct")
    print("NET_DUCT =", complex(sol.params["ω"]))
    L = discretize_network(nets["rijke"])
    L.params["n"], L.params["τ"] = 0.0, 1e-3
    sol, _, _ = _solve(L, 2 * np.pi * 150, dict(maxiter=40, tol=1e-10),
                       "rijke n=0")
    print("NET_RIJKE_N0 =", complex(sol.params["ω"]))
    L.params["n"] = 0.3
    sol, _, _ = _solve(L, sol.params["ω"], dict(maxiter=40, tol=1e-10),
                       "rijke n=0.3")
    print("NET_RIJKE_N03 =", complex(sol.params["ω"]))
    L = discretize_network(nets["damper"])
    sol, _, _ = _solve(L, 2 * np.pi * 90, dict(maxiter=50, tol=1e-9),
                       "damper")
    print("NET_DAMPER =", complex(sol.params["ω"]))


def part_shape():
    from wavesandeigenvalues_jl_tpu.models import (
        discrete_adjoint_shape_sensitivity,
        forward_finite_differences_shape_sensitivity, get_surface_point_masks)
    from wavesandeigenvalues_jl_tpu.nlevp import householder
    m = rijke_mesh(n_rings=3, nz_cold=17, nz_hot=17)
    L, dscrp = active(m)
    c = m.generate_field(_c, order="const")
    t0 = time.perf_counter()
    sol, n, flag = householder(L, 340 * 2 * np.pi, maxiter=20, tol=1e-11,
                               order=2)
    print(f"shape: n={L.size} householder(order=2) {n} steps flag {flag} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print("OMEGA_1369_H2 =", complex(sol.params["ω"]))
    surf, tri_mask, tet_mask = get_surface_point_masks(m)
    t0 = time.perf_counter()
    sens = discrete_adjoint_shape_sensitivity(m, dscrp, c, surf, tri_mask,
                                              tet_mask, L, sol, h=1e-8)
    print(f"DA over {len(surf)} surface points: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pick = np.linspace(0, len(surf) - 1, 6).astype(int)
    outlet = np.unique(m.triangles[m.domains["Outlet"]["simplices"]])
    flat = np.abs(sens).ravel()
    print("SENS_MAX =", complex(sens.ravel()[np.argmax(flat)]))
    print("SENS_OUTLET_Z =", complex(sens[2, outlet].sum()))
    print("SENS_PICKED =", [tuple(complex(x) for x in sens[:, p])
                            for p in surf[pick]])
    # the DA's round-off resolution: the picked entries at other h
    for h in (2e-8, 5e-9):
        other = discrete_adjoint_shape_sensitivity(
            m, dscrp, c, surf[pick], [tri_mask[i] for i in pick],
            [tet_mask[i] for i in pick], L, sol, h=h)[:, surf[pick]]
        base = sens[:, surf[pick]]
        print(f"DA picked at h={h:g} against h=1e-8: "
              f"{np.abs(other - base).max() / np.abs(base).max():.3e} of the "
              "largest picked entry")
    # one point a call: the JAX package's re-solve (householder, nev=3)
    # raises IndexError where the direct and adjoint Arnoldi runs stop at
    # different steps (ROADMAP.md Queue 3, F6)
    fd = []
    t0 = time.perf_counter()
    for i in pick:
        try:
            f = forward_finite_differences_shape_sensitivity(
                m, dscrp, c, surf[[i]], [tri_mask[i]], [tet_mask[i]], L,
                sol, h=1e-6)[:, surf[i]]
            err = np.abs(sens[:, surf[i]] - f).max() / np.abs(f).max()
            print(f"FD point {surf[i]}: |DA - FD| / max|FD| {err:.3e}")
            fd.append(tuple(complex(x) for x in f))
        except IndexError as e:
            print(f"FD point {surf[i]}: F6, IndexError {e}")
            fd.append(None)
    print(f"FD at 6 points: {time.perf_counter() - t0:.1f} s")
    print("FD_PICKED =", fd)


def part_f7():
    """F7 (ROADMAP.md Queue 3): the quiescent APE duct of
    tests/test_ape.py:139 through the dense fused engine of the JAX
    package (its "device" backend) and of the port (its default), against
    JAX host and the port's slab engine."""
    import torch
    from wavesandeigenvalues_jl_tpu.mesh.generate import box_mesh
    from wavesandeigenvalues_jl_tpu.models import ape
    from wavesandeigenvalues_jl_tpu.nlevp import mslp
    from wavesandeigenvalues_jl_tpu.utils.config import set_solve_backend
    import wavesandeigenvalues_jl_tpu_torch.models as port_models
    import wavesandeigenvalues_jl_tpu_torch.nlevp as port_nlevp
    from wavesandeigenvalues_jl_tpu_torch.mesh.generate import \
        box_mesh as port_box_mesh
    from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
        FusedSlabPencilSolver

    torch.set_num_threads(1)
    c = np.sqrt(ape.AMBIENT_GAMMA * ape.AMBIENT_P / ape.AMBIENT_RHO)
    s0, kw = 1j * np.pi * c * 1.06, dict(maxiter=40, tol=1e-9)

    def family(bm, mod):
        m = bm(lx=0.25, ly=0.25, lz=1.0, nx=1, ny=1, nz=12)
        m.collect_lines()
        return mod.discretize(m, {})

    for label, backend in (("JAX host", "host"),
                           ("JAX FusedPencilSolver", "device")):
        prev = set_solve_backend(backend)
        L = family(box_mesh, ape)
        sol, n, flag = mslp(L, s0, **kw)
        set_solve_backend(prev)
        print(f"F7 {label}: n={L.size} {n} steps flag {flag} "
              f"s={sol.params['s']!r}", flush=True)
    for label, slab in (("port FusedPencilSolver", False),
                        ("port FusedSlabPencilSolver", True)):
        L = family(port_box_mesh, port_models.ape)
        if slab:
            L._fused_solver = (L._stack(), FusedSlabPencilSolver(L, "cpu"))
        sol, n, flag = port_nlevp.mslp(L, s0, device="cpu", **kw)
        print(f"F7 {label}: n={L.size} {n} steps flag {flag} "
              f"s={sol.params['s']!r}", flush=True)


PARTS = {"flames": part_flames, "hermite": part_hermite, "ape": part_ape,
         "network": part_network, "shape": part_shape, "f7": part_f7}


def cmd_frontends(parts):
    for name in parts or [p for p in PARTS if p != "f7"]:
        PARTS[name]()


def cmd_io():
    from wavesandeigenvalues_jl_tpu.nlevp.fitting import fit_state_space
    freqs = np.linspace(100, 600, 120)
    data = np.exp(-1j * 2 * np.pi * freqs * 1e-3)
    t0 = time.perf_counter()
    ss, fitted = fit_state_space(freqs, data, order=12)
    print(f"fit: order 12, {time.perf_counter() - t0:.3f} s, max error "
          f"{np.abs(fitted - data).max()!r}", flush=True)
    mesh = rijke_mesh(n_rings=4, nz_cold=58, nz_hot=58)
    c = mesh.generate_field(_c)
    head = FLAME_HEAD[:3] + ([0.0, 0.0, -0.0012], [0.0, 0.0, 1.0])
    base = {"Interior": ("interior", ()),
            "Outlet": ("admittance", ("Y", 1e15))}
    kw = dict(maxiter=20, tol=1e-10)
    for label, flame in (("fitted flame", head + (ss,)),
                         ("n-tau flame", head + ("n", "τ", 1.0, 1e-3))):
        t0 = time.perf_counter()
        L = discretize(mesh, {**base, "Flame": ("flame", flame)}, c)
        print(f"{label}: discretize {time.perf_counter() - t0:.2f} s",
              flush=True)
        _solve(L, 340 * 2 * np.pi, kw, f"J2 {label}")


if __name__ == "__main__":
    cmd = sys.argv[1]
    if cmd == "hierarchy":
        cmd_hierarchy()
    elif cmd == "beyn55k":
        cmd_beyn55k()
    elif cmd == "panel2":
        cmd_panel2(sys.argv[2])
    elif cmd == "track":
        cmd_track()
    elif cmd == "bloch":
        cmd_bloch()
    elif cmd == "frontends":
        cmd_frontends(sys.argv[2:])
    elif cmd == "io":
        cmd_io()
    else:
        sys.exit(f"unknown command {cmd!r}")
