#!/usr/bin/env python3
"""Reference values of the JAX package, computed on the CPU, for paths F
and G of ``chip_smoke.py`` (the PyTorch port holds itself against them).

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py hierarchy
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py beyn55k
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py panel2 OUT.npz
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py track

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
    else:
        sys.exit(f"unknown command {cmd!r}")
