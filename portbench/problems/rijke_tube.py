"""The Rijke tube with an n–τ flame (WavesAndEigenvalues.jl tutorial 01).

A configuration of this problem gives the tube's mesh parameters and its
physics.  The mesh and the speed of sound are made here and handed to
both sides: the program assembles its family through its own
``discretize``, the reference through :mod:`..reference.helmholtz`.
"""
from __future__ import annotations

import numpy as np

from ..reference.helmholtz import helmholtz_family
from ..reference.meshes import rijke_tube

#: request parameter -> the program's parameter name
PORT_NAMES = {"n": "n", "tau": "τ"}


def mesh(cfg: dict) -> dict:
    return rijke_tube(**cfg["mesh"])


def speed_of_sound(cfg: dict, z):
    ph = cfg["physics"]
    c = lambda T: np.sqrt(ph["gamma"] * ph["R"] * T)      # noqa: E731
    return np.where(z < 0, c(ph["T_cold"]), c(ph["T_hot"]))


def flame(cfg: dict) -> dict:
    ph = cfg["physics"]
    q = (ph["p0"] * (ph["T_hot"] / ph["T_cold"] - 1)
         * np.pi * ph["tube_radius"] ** 2 * ph["gamma"] / (ph["gamma"] - 1))
    return {"gamma": ph["gamma"], "rho": ph["rho"], "q_over_u": q,
            "x_ref": ph["x_ref"], "n_ref": ph["n_ref"], "n": ph["n"],
            "tau": ph["tau"]}


def c_tet(mesh_: dict, cfg: dict) -> np.ndarray:
    z = mesh_["points"][2, mesh_["tetrahedra"]].mean(axis=1)
    return speed_of_sound(cfg, z)


def reference_family(mesh_: dict, cfg: dict):
    return helmholtz_family(mesh_, c_tet(mesh_, cfg), cfg["physics"]["Y"],
                            flame(cfg))


def port_family(mesh_: dict, cfg: dict):
    """The program's family: its mesh constructor on the arrays, its
    per-tetrahedron field sampler and its ``discretize``."""
    from wavesandeigenvalues_jl_tpu_torch.mesh.core import Mesh
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    m = Mesh.from_raw(mesh_["points"], np.zeros((0, 2), np.int64),
                      mesh_["triangles"], mesh_["tetrahedra"],
                      mesh_["domains"], name=cfg["name"])
    c = m.generate_field(lambda x, y, z: speed_of_sound(cfg, z),
                         order="const")
    f = flame(cfg)
    dscrp = {"Interior": ("interior", ()),
             "Outlet": ("admittance", ("Y", cfg["physics"]["Y"])),
             "Flame": ("flame", (f["gamma"], f["rho"], f["q_over_u"],
                                 list(f["x_ref"]), list(f["n_ref"]), "n",
                                 "τ", f["n"], f["tau"]))}
    return discretize(m, dscrp, c)


__all__ = ["PORT_NAMES", "mesh", "reference_family", "port_family"]
