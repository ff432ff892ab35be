"""Uniform hierarchical mesh refinement (host numpy, copied from the JAX
package's ``mesh/refine.py``).

``octosplit`` subdivides every tetrahedron 1→8 by bisecting all six edges
(octosplit, src/Meshutils.jl:589-747): four corner tets are always
present; the interior octahedron is cut into four tets along its
*shortest* diagonal (the quality-preserving choice).  Surface triangles
split 1→4 and lines 1→2, and every domain is remapped onto the child
elements.

Unlike the reference's per-element binary-search insertion loop, the split
here is fully vectorized: children are emitted parent-major so the domain
remap is a single index arithmetic, then :meth:`Mesh.from_raw` dedups and
re-indexes in bulk.  The point, element and domain order is the JAX
package's to the array, so an operator assembled on the refined mesh is
the same matrix in the same ordering.
"""
from __future__ import annotations

import numpy as np

from .core import Mesh

# interior-octahedron cut: for each of the three diagonals (pairs of
# opposite edge-midpoints) the four tets (diag0, diag1, ring_i, ring_{i+1})
# where the ring is the 4-cycle of the remaining midpoints.  Midpoint slot
# order: AB, AC, AD, BC, BD, CD.
_AB, _AC, _AD, _BC, _BD, _CD = range(6)
_OCT_CUTS = (
    # diagonal AB–CD, ring AC–AD–BD–BC
    ((_AB, _CD, _AC, _AD), (_AB, _CD, _AD, _BD),
     (_AB, _CD, _BD, _BC), (_AB, _CD, _BC, _AC)),
    # diagonal AC–BD, ring AB–AD–CD–BC
    ((_AC, _BD, _AB, _AD), (_AC, _BD, _AD, _CD),
     (_AC, _BD, _CD, _BC), (_AC, _BD, _BC, _AB)),
    # diagonal AD–BC, ring AC–CD–BD–AB
    ((_AD, _BC, _AC, _CD), (_AD, _BC, _CD, _BD),
     (_AD, _BC, _BD, _AB), (_AD, _BC, _AB, _AC)),
)


def octosplit(mesh: Mesh) -> Mesh:
    """Uniformly refine: every tet → 8, tri → 4, line → 2; domains follow
    their parents (Meshutils.jl:589-747)."""
    mesh.collect_lines()
    n_pts = mesh.n_points
    p = mesh.points

    mid = 0.5 * (p[:, mesh.lines[:, 0]] + p[:, mesh.lines[:, 1]])
    points = np.concatenate([p, mid], axis=1)

    # --- tetrahedra: [ne, 4] corners + [ne, 6] edge-midpoint DOFs ----------
    t = mesh.tetrahedra
    edges = np.stack([t[:, [0, 1]], t[:, [0, 2]], t[:, [0, 3]],
                      t[:, [1, 2]], t[:, [1, 3]], t[:, [2, 3]]], axis=1)
    m = mesh.edge_indices(edges.reshape(-1, 2)).reshape(-1, 6) + n_pts

    corner = np.stack([
        np.stack([t[:, 0], m[:, _AB], m[:, _AC], m[:, _AD]], axis=1),
        np.stack([t[:, 1], m[:, _AB], m[:, _BC], m[:, _BD]], axis=1),
        np.stack([t[:, 2], m[:, _AC], m[:, _BC], m[:, _CD]], axis=1),
        np.stack([t[:, 3], m[:, _AD], m[:, _BD], m[:, _CD]], axis=1),
    ], axis=1)  # [ne, 4, 4]

    dlen = np.stack([
        np.linalg.norm(points[:, m[:, _AB]] - points[:, m[:, _CD]], axis=0),
        np.linalg.norm(points[:, m[:, _AC]] - points[:, m[:, _BD]], axis=0),
        np.linalg.norm(points[:, m[:, _AD]] - points[:, m[:, _BC]], axis=0),
    ], axis=1)  # [ne, 3]
    cut = np.argmin(dlen, axis=1)  # [ne]

    octs = np.empty((len(t), 3, 4, 4), dtype=np.int64)
    for ci, tets4 in enumerate(_OCT_CUTS):
        for ti, slots in enumerate(tets4):
            for vi, s in enumerate(slots):
                octs[:, ci, ti, vi] = m[:, s]
    inner = octs[np.arange(len(t)), cut]  # [ne, 4, 4]
    tets = np.concatenate([corner, inner], axis=1).reshape(-1, 4)  # 8/parent

    # --- triangles 1→4 ------------------------------------------------------
    tr = mesh.triangles
    if len(tr):
        tedges = np.stack([tr[:, [0, 1]], tr[:, [0, 2]], tr[:, [1, 2]]],
                          axis=1)
        tm = mesh.edge_indices(tedges.reshape(-1, 2)).reshape(-1, 3) + n_pts
        ab, ac, bc = tm[:, 0], tm[:, 1], tm[:, 2]
        tris = np.stack([
            np.stack([tr[:, 0], ab, ac], axis=1),
            np.stack([tr[:, 1], ab, bc], axis=1),
            np.stack([tr[:, 2], ac, bc], axis=1),
            np.stack([ab, ac, bc], axis=1),
        ], axis=1).reshape(-1, 3)
    else:
        tris = np.zeros((0, 3), np.int64)

    # --- lines 1→2 -----------------------------------------------------------
    ln = mesh.lines
    lm = np.arange(len(ln), dtype=np.int64) + n_pts
    lns = np.stack([
        np.stack([ln[:, 0], lm], axis=1),
        np.stack([lm, ln[:, 1]], axis=1),
    ], axis=1).reshape(-1, 2)

    domains = {}
    for dom, dd in mesh.domains.items():
        dim = int(dd["dimension"])
        idx = np.asarray(dd["simplices"], dtype=np.int64)
        fan = {3: 8, 2: 4, 1: 2}[dim]
        kids = (idx[:, None] * fan + np.arange(fan)).ravel()
        domains[dom] = {"dimension": dim, "simplices": kids}

    return Mesh.from_raw(points, lns, tris, tets, domains,
                         name=mesh.name + "(octosplit)", file=mesh.file)


def p1_prolongation(coarse: Mesh):
    """P1 interpolation COO from ``coarse`` onto its :func:`octosplit`
    child: fine point i < n_c IS coarse point i; fine point n_c + e is the
    midpoint of coarse edge e, interpolated as the average of its two
    endpoints.  Returns ``(rows, cols, vals, (n_fine, n_coarse))``;
    compose across levels with :func:`compose_prolongations`."""
    coarse.collect_lines()
    n_c = coarse.n_points
    ln = np.asarray(coarse.lines)
    n_f = n_c + len(ln)
    e = np.arange(len(ln), dtype=np.int64)
    rows = np.concatenate([np.arange(n_c), n_c + e, n_c + e])
    cols = np.concatenate([np.arange(n_c), ln[:, 0], ln[:, 1]])
    vals = np.concatenate([np.ones(n_c), np.full(2 * len(ln), 0.5)])
    return rows, cols, vals, (n_f, n_c)


def compose_prolongations(P_fine, P_coarse):
    """Compose two :func:`p1_prolongation` COOs (finest-level first):
    returns the COO of P_fine @ P_coarse mapping the coarsest level
    directly to the finest."""
    import scipy.sparse as sp
    r1, c1, v1, s1 = P_fine
    r2, c2, v2, s2 = P_coarse
    M = (sp.coo_matrix((v1, (r1, c1)), shape=s1)
         @ sp.coo_matrix((v2, (r2, c2)), shape=s2)).tocoo()
    return (M.row.astype(np.int64), M.col.astype(np.int64),
            M.data, M.shape)


__all__ = ["octosplit", "p1_prolongation", "compose_prolongations"]
