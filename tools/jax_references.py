#!/usr/bin/env python3
"""Reference values of the JAX package, computed on the CPU, for paths F,
G and H of ``chip_smoke.py`` (the PyTorch port holds itself against them).

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py hierarchy
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py beyn55k
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py panel2 OUT.npz
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py track
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py bloch

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
    else:
        sys.exit(f"unknown command {cmd!r}")
