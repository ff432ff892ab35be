"""Mesh generators of the benchmark's configurations, as plain arrays.

A frozen copy of the generated mesh the configuration names: the Rijke
tube (a Delaunay cylinder with a thin flame slab).  Both sides of a run
take these arrays: the program through its mesh constructor, the
reference as they are.

Every mesh is returned as a dict of numpy arrays:

* ``points`` [3, N] float64, ``tetrahedra`` [nt, 4] int64 in canonical
  order (rows sorted lexicographically by their sorted vertices, the
  order a deduplicating mesh constructor keeps), ``triangles`` [ntri, 3]
  (boundary faces) and ``triangle_owner`` (the tetrahedron of each),
  ``domains`` {name: {"dimension", "simplices"}}.
"""
from __future__ import annotations

import numpy as np


def canonical(tets: np.ndarray) -> np.ndarray:
    """Rows deduplicated and ordered by their sorted vertices; each row
    keeps its own vertex order."""
    s = np.sort(tets, axis=1)
    _, first = np.unique(s, axis=0, return_index=True)
    return tets[first]


def tet_volumes(points: np.ndarray, tets: np.ndarray) -> np.ndarray:
    p = points[:, tets]                               # [3, nt, 4]
    d = np.stack([p[:, :, i] - p[:, :, 3] for i in range(3)], axis=1)
    return np.abs(np.linalg.det(np.moveaxis(d, 2, 0))) / 6.0


def boundary_faces(tets: np.ndarray):
    """(faces appearing once [nf, 3], owning tetrahedron of each)."""
    faces = np.concatenate([tets[:, [1, 2, 3]], tets[:, [0, 2, 3]],
                            tets[:, [0, 1, 3]], tets[:, [0, 1, 2]]])
    owner = np.tile(np.arange(len(tets)), 4)
    _, first, counts = np.unique(np.sort(faces, axis=1), axis=0,
                                 return_index=True, return_counts=True)
    once = first[counts == 1]
    return faces[once], owner[once]


def _disk(radius: float, n_rings: int) -> np.ndarray:
    pts = [(0.0, 0.0)]
    for r_i in range(1, n_rings + 1):
        r = radius * r_i / n_rings
        for p in range(6 * r_i):
            phi = 2 * np.pi * p / (6 * r_i)
            pts.append((r * np.cos(phi), r * np.sin(phi)))
    return np.asarray(pts)


def rijke_tube(radius: float, length: float, flame_halfwidth: float,
               n_rings: int, nz_cold: int, nz_hot: int) -> dict:
    """The Rijke tube z ∈ [-L/2, L/2] with the flame slab [-fh, fh]:
    volumes Interior/Cold/Flame/Hot, surfaces Inlet/Outlet/Walls."""
    from scipy.spatial import Delaunay

    half = length / 2
    zs = np.concatenate([np.linspace(-half, -flame_halfwidth, nz_cold + 1),
                         [0.0],
                         np.linspace(flame_halfwidth, half, nz_hot + 1)])
    disk = _disk(radius, n_rings)
    points = np.concatenate([np.concatenate(
        [disk, np.full((len(disk), 1), z)], axis=1) for z in zs]).T
    tets = Delaunay(points.T).simplices.astype(np.int64)
    tets = canonical(tets[tet_volumes(points, tets) > 1e-18])
    tris, owner = boundary_faces(tets)
    z = points[2, tets].mean(axis=1)
    zt = points[2, tris].mean(axis=1)
    inlet = np.nonzero(np.abs(zt + half) < 1e-9)[0]
    outlet = np.nonzero(np.abs(zt - half) < 1e-9)[0]
    walls = np.setdiff1d(np.arange(len(tris)),
                         np.concatenate([inlet, outlet]))
    domains = {
        "Interior": (3, np.arange(len(tets))),
        "Cold": (3, np.nonzero(z < -flame_halfwidth)[0]),
        "Flame": (3, np.nonzero(np.abs(z) <= flame_halfwidth)[0]),
        "Hot": (3, np.nonzero(z > flame_halfwidth)[0]),
        "Inlet": (2, inlet), "Outlet": (2, outlet), "Walls": (2, walls)}
    return {"points": points, "tetrahedra": tets, "triangles": tris,
            "triangle_owner": owner,
            "domains": {k: {"dimension": d, "simplices": s}
                        for k, (d, s) in domains.items()}}


__all__ = ["rijke_tube", "canonical", "tet_volumes", "boundary_faces"]
