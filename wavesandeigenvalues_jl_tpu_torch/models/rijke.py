"""The flagship problem: a generated Rijke tube with an n–τ flame.

Cold (300 K) and hot (1200 K) halves, an outlet admittance Y = 1e15 and
the n = 1, τ = 1 ms flame at the centre, referenced 10.1 mm upstream — the
active family of the JAX package's tests and bench
(``tests/test_fused_slab.py``, ``bench.py``).  ``rijke_mesh(n_rings=2,
nz_cold=10, nz_hot=10)`` gives n = 437 DOF, ``rijke_mesh(n_rings=4,
nz_cold=58, nz_hot=58)`` n = 7,259 DOF.

The passive family (no flame, speed of sound per point) on the
octosplit-refined 7,259-point tube is the large operator of the JAX
bench (``bench.py:550-556``): 57,210 DOF and 819,730 nonzeros.
"""
from __future__ import annotations

import numpy as np

from ..mesh.generate import rijke_mesh
from ..mesh.refine import octosplit
from .helmholtz import discretize

GAMMA, R_GAS, T_COLD, T_HOT, P0, RHO = 1.4, 287.05, 300.0, 1200.0, 101325.0, 1.225
#: mean heat release over mean velocity of the flame
Q02U0 = P0 * (T_HOT / T_COLD - 1) * np.pi * 0.025 ** 2 * GAMMA / (GAMMA - 1)


def _speed_of_sound(x, y, z):
    return np.where(z < 0, np.sqrt(GAMMA * R_GAS * T_COLD),
                    np.sqrt(GAMMA * R_GAS * T_HOT))


def active_rijke_setup(mesh):
    """(dscrp, c) of the active Rijke family on a ``rijke_mesh`` mesh:
    the model description and the per-tetrahedron speed of sound."""
    c = mesh.generate_field(_speed_of_sound, order="const")
    dscrp = {
        "Interior": ("interior", ()),
        "Outlet": ("admittance", ("Y", 1e15)),
        "Flame": ("flame", (GAMMA, RHO, Q02U0, [0.0, 0.0, -0.0101],
                            [0.0, 0.0, 1.0], "n", "τ", 1.0, 1e-3)),
    }
    return dscrp, c


def active_rijke_family(n_rings: int = 2, nz_cold: int = 10,
                        nz_hot: int = 10):
    """The port's active Rijke operator family on a generated mesh."""
    mesh = rijke_mesh(n_rings=n_rings, nz_cold=nz_cold, nz_hot=nz_hot)
    dscrp, c = active_rijke_setup(mesh)
    return discretize(mesh, dscrp, c)


def passive_rijke_setup(mesh):
    """(dscrp, c) of the passive Rijke family of the JAX bench's large
    operator (``bench.py:551-556``): the interior and the outlet
    admittance, no flame, and the speed of sound sampled per point
    (``order="lin"``, where the active family samples per tetrahedron)."""
    c = mesh.generate_field(_speed_of_sound, order="lin")
    dscrp = {"Interior": ("interior", ()),
             "Outlet": ("admittance", ("Y", 1e15))}
    return dscrp, c


def large_operator_family(n_rings: int = 4, nz_cold: int = 58,
                          nz_hot: int = 58, refine: int = 1):
    """The passive family on a ``rijke_mesh`` refined by ``refine``
    octosplit passes; the defaults give the JAX bench's 57,210-DOF large
    operator (``bench.py:550``)."""
    mesh = rijke_mesh(n_rings=n_rings, nz_cold=nz_cold, nz_hot=nz_hot)
    for _ in range(refine):
        mesh = octosplit(mesh)
    dscrp, c = passive_rijke_setup(mesh)
    return discretize(mesh, dscrp, c)


__all__ = ["active_rijke_setup", "active_rijke_family",
           "passive_rijke_setup", "large_operator_family", "Q02U0"]
