"""Structured tetrahedral mesh generators (box, cylinder/Rijke tube).

The reference ships meshes as gmsh files; for self-contained tests and
examples this module generates equivalent tetrahedral meshes directly:
a Kuhn-subdivided box and a Delaunay cylinder with the Rijke-tube domain
layout (Inlet/Outlet/Walls surfaces, Cold/Flame/Hot volumes) matching the
layout of the reference's Rijke_mm.msh, and the half-cell of a DOS-fold
annular duct that :func:`.annular.extend_mesh` turns into a Bloch unit
cell or a full annulus.  Host numpy/scipy, copied from the JAX package's
``mesh/generate.py``."""
from __future__ import annotations

import numpy as np

from .core import Mesh

_KUHN = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7), (0, 2, 6, 7),
         (0, 4, 5, 7), (0, 4, 6, 7)]


def box_mesh(lx=1.0, ly=1.0, lz=1.0, nx=4, ny=4, nz=4,
             origin=(0.0, 0.0, 0.0)) -> Mesh:
    """Box [0,lx]×[0,ly]×[0,lz] (shifted by origin), each cell split into
    6 Kuhn tetrahedra.  Domains: Interior (tets) and face surfaces
    Xmin/Xmax/Ymin/Ymax/Zmin/Zmax."""
    xs = np.linspace(0, lx, nx + 1) + origin[0]
    ys = np.linspace(0, ly, ny + 1) + origin[1]
    zs = np.linspace(0, lz, nz + 1) + origin[2]
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()])

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                corner = [nid(i + a, j + b, k + c)
                          for a in (0, 1) for b in (0, 1) for c in (0, 1)]
                # corner order: bits (a<<2 | b<<1 | c)
                for t in _KUHN:
                    tets.append([corner[v] for v in t])
    tets = np.asarray(tets, np.int64)
    mesh = Mesh(points, tetrahedra=tets, name="box")
    surface, interior = mesh.surface_and_interior_triangles()
    mesh.triangles = surface
    mesh.int_triangles = interior
    mesh.domains["Interior"] = {"dimension": 3,
                                "simplices": np.arange(len(tets))}
    mid = points[:, surface].mean(axis=2)  # [3, ntri]
    eps = 1e-9 * max(lx, ly, lz)
    for name, axis, val in (("Xmin", 0, origin[0]), ("Xmax", 0, origin[0] + lx),
                            ("Ymin", 1, origin[1]), ("Ymax", 1, origin[1] + ly),
                            ("Zmin", 2, origin[2]), ("Zmax", 2, origin[2] + lz)):
        idx = np.nonzero(np.abs(mid[axis] - val) < eps)[0]
        mesh.domains[name] = {"dimension": 2, "simplices": idx}
    return mesh


def cylinder_points(radius: float, zs: np.ndarray, n_rings: int):
    """Disk point layout per z-layer: center + concentric rings."""
    pts = [(0.0, 0.0)]
    for r_i in range(1, n_rings + 1):
        r = radius * r_i / n_rings
        n_phi = 6 * r_i
        for p in range(n_phi):
            phi = 2 * np.pi * p / n_phi
            pts.append((r * np.cos(phi), r * np.sin(phi)))
    disk = np.asarray(pts)
    out = []
    for z in zs:
        layer = np.concatenate([disk, np.full((len(disk), 1), z)], axis=1)
        out.append(layer)
    return np.concatenate(out).T  # [3, n]


def rijke_mesh(radius=0.025, length=0.5, flame_halfwidth=0.001,
               n_rings=3, nz_cold=12, nz_hot=12) -> Mesh:
    """Self-contained Rijke-tube mesh: cylinder z ∈ [-L/2, L/2] with a thin
    flame slab [-fh, +fh]; domains Interior/Cold/Flame/Hot (volumes) and
    Inlet (z=-L/2) / Outlet (z=+L/2) / Walls (surfaces) — the layout of the
    reference's Rijke_mm.msh."""
    from scipy.spatial import Delaunay

    L2 = length / 2
    zc = np.linspace(-L2, -flame_halfwidth, nz_cold + 1)
    zf = np.array([0.0])
    zh = np.linspace(flame_halfwidth, L2, nz_hot + 1)
    zs = np.concatenate([zc, zf, zh])
    points = cylinder_points(radius, zs, n_rings)
    tri = Delaunay(points.T)
    tets = tri.simplices.astype(np.int64)
    # drop degenerate slivers
    mesh0 = Mesh(points, tetrahedra=tets)
    vols = mesh0.tet_volumes()
    tets = tets[vols > 1e-18]
    mesh = Mesh(points, tetrahedra=tets, name="rijke_cylinder")
    surface, interior = mesh.surface_and_interior_triangles()
    mesh.triangles = surface
    mesh.int_triangles = interior
    cen = points[:, tets].mean(axis=2)  # [3, ntet]
    z = cen[2]
    mesh.domains = {
        "Interior": {"dimension": 3, "simplices": np.arange(len(tets))},
        "Cold": {"dimension": 3,
                 "simplices": np.nonzero(z < -flame_halfwidth)[0]},
        "Flame": {"dimension": 3,
                  "simplices": np.nonzero(np.abs(z) <= flame_halfwidth)[0]},
        "Hot": {"dimension": 3,
                "simplices": np.nonzero(z > flame_halfwidth)[0]},
    }
    mid = points[:, surface].mean(axis=2)
    eps = 1e-9
    inlet = np.nonzero(np.abs(mid[2] + L2) < eps)[0]
    outlet = np.nonzero(np.abs(mid[2] - L2) < eps)[0]
    walls = np.setdiff1d(np.arange(len(surface)),
                         np.concatenate([inlet, outlet]))
    mesh.domains["Inlet"] = {"dimension": 2, "simplices": inlet}
    mesh.domains["Outlet"] = {"dimension": 2, "simplices": outlet}
    mesh.domains["Walls"] = {"dimension": 2, "simplices": walls}
    return mesh


def annular_halfcell(DOS=8, r0=0.2, r1=0.3, lz=0.5, nr=2, nphi=2, nz=6,
                     with_axis=False) -> Mesh:
    """Half-cell of a DOS-fold annular duct: sector θ ∈ [0, π/DOS],
    r ∈ [r0, r1] (or [0, r1] with ``with_axis=True``), z ∈ [0, lz].
    Domains: Bloch (θ=0), Symmetry (θ=π/DOS), Interior, Inlet (z=0),
    Outlet (z=lz), Walls — the input layout of
    :func:`.annular.extend_mesh`."""
    phi_max = np.pi / DOS
    rs = np.linspace(0.0 if with_axis else r0, r1, nr + 1)
    phis = np.linspace(0.0, phi_max, nphi + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    pts = []
    index = {}
    for k, z in enumerate(zs):
        for i, r in enumerate(rs):
            for j, phi in enumerate(phis):
                if with_axis and r == 0.0 and j > 0:
                    index[(i, j, k)] = index[(i, 0, k)]
                    continue
                index[(i, j, k)] = len(pts)
                pts.append((r * np.cos(phi), r * np.sin(phi), z))
    points = np.asarray(pts).T
    tets = []
    for k in range(nz):
        for i in range(nr):
            for j in range(nphi):
                corner = [index[(i + a, j + b, k + c)]
                          for a in (0, 1) for b in (0, 1) for c in (0, 1)]
                for t in _KUHN:
                    tet = [corner[v] for v in t]
                    if len(set(tet)) == 4:
                        tets.append(tet)
    tets = np.asarray(tets, np.int64)
    mesh = Mesh(points, tetrahedra=tets, name="annular_halfcell")
    vols = mesh.tet_volumes()
    mesh.tetrahedra = tets = tets[vols > 1e-14]
    surface, interior = mesh.surface_and_interior_triangles()
    mesh.triangles = surface
    mesh.int_triangles = interior
    mid = points[:, surface].mean(axis=2)
    phi_mid = np.arctan2(mid[1], mid[0])
    eps = 1e-9
    bloch = np.nonzero(np.abs(phi_mid) < eps)[0]
    symm = np.nonzero(np.abs(phi_mid - phi_max) < eps)[0]
    inlet = np.nonzero(np.abs(mid[2]) < eps)[0]
    outlet = np.nonzero(np.abs(mid[2] - lz) < eps)[0]
    rest = np.setdiff1d(np.arange(len(surface)),
                        np.concatenate([bloch, symm, inlet, outlet]))
    mesh.domains = {
        "Interior": {"dimension": 3, "simplices": np.arange(len(tets))},
        "Bloch": {"dimension": 2, "simplices": bloch},
        "Symmetry": {"dimension": 2, "simplices": symm},
        "Inlet": {"dimension": 2, "simplices": inlet},
        "Outlet": {"dimension": 2, "simplices": outlet},
        "Walls": {"dimension": 2, "simplices": rest},
    }
    return mesh


__all__ = ["box_mesh", "rijke_mesh", "cylinder_points", "annular_halfcell"]

