"""Annular (rotationally symmetric) mesh machinery.

Re-implementation of the reference's half-cell → unit-cell / full-annulus
expansion (src/Mesh/annular_meshes.jl): plane geometry, sector index
arithmetic, point re-ordering into the canonical Bloch block layout

    [ axis | bloch-ref | body | symmetry | reflected-body | bloch-image ]

reflection across the symmetry plane, rotation into DOS sectors, per-sector
domain construction, and the SymInfo bookkeeping that the Bloch operator
reduction (fem/bloch.py) consumes.  ``bloch_expand`` reconstructs a
full-annulus eigenvector from a unit-cell solution (Bloch.jl:120-143).

Host numpy, copied from the JAX package's ``mesh/annular.py``: the point
order, the simplex and line orderings and the domains are the JAX
package's array for array, since they fix the DOF numbers of the P2 and
Bloch-reduced families."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .core import Mesh, SymInfo, find_simplices, unique_simplices


# ---------------------------------------------------------------------------
# plane geometry (annular_meshes.jl:14-121)


def three_points_to_plane(A: np.ndarray) -> np.ndarray:
    """Plane a·x+b·y+c·z+d=0 through the three column points of A."""
    a = np.cross(A[:, 0] - A[:, 2], A[:, 1] - A[:, 2])
    a = a / np.linalg.norm(a)
    d = -a @ A[:, 2]
    if abs(d) < 1e-7:
        d = 0.0
    return np.array([a[0], a[1], a[2], d])


def reflect_points_at_plane(pnts: np.ndarray, pln: np.ndarray) -> np.ndarray:
    """Reflect [3, n] points across the plane."""
    a, d = pln[:3], pln[3]
    k = -(a @ pnts) - d
    return pnts + 2 * np.outer(a, k)


def make_normal_outwards(pln, testpoint):
    a, d = pln[:3], pln[3]
    k = -(a @ testpoint) - d
    foot = testpoint + a * k
    s = a @ (np.asarray(testpoint) - foot)
    return pln * (-np.sign(s) if s != 0 else 1.0)


def plane_intersection(pln1, pln2):
    """Axis (point, direction) of two intersecting planes."""
    n = np.cross(pln1[:3], pln2[:3])
    n = n / np.linalg.norm(n)
    A = np.stack([pln1[:3], pln2[:3]])
    b = -np.array([pln1[3], pln2[3]])
    p, *_ = np.linalg.lstsq(A, b, rcond=None)
    return p, n


def rotation_matrix(n, alpha):
    n = np.asarray(n, float)
    c, s = np.cos(alpha), np.sin(alpha)
    K = np.array([[0, -n[2], n[1]], [n[2], 0, -n[0]], [-n[1], n[0], 0]])
    return c * np.eye(3) + s * K + (1 - c) * np.outer(n, n)


# ---------------------------------------------------------------------------
# sector index arithmetic (annular_meshes.jl:142-240)


def get_rotated_index(idx, sector, naxis, nxsector, DOS):
    """Point index after rotating by ``sector`` sectors (vectorized)."""
    idx = np.asarray(idx)
    out = np.where(idx < naxis, idx,
                   (idx - naxis + sector * nxsector) % (nxsector * DOS) + naxis)
    return out


def get_reflected_index(idx, naxis, nxbloch, nbody, shiftbody, nxsymmetry,
                        nxsector):
    """Point index after reflection across the symmetry plane (0-based,
    vectorized).  Blocks: [axis | bloch | body | symmetry]."""
    idx = np.asarray(idx)
    nbloch = naxis + nxbloch
    out = np.where(idx < naxis, idx,
          np.where(idx < nbloch, idx + nxsector,
          np.where(idx < nbloch + nbody, idx + shiftbody,
          np.where(idx < nbloch + nbody + nxsymmetry, idx, -1))))
    return out


def get_point_sector(idx, naxis, nxsector):
    idx = np.asarray(idx)
    return np.where(idx < naxis, np.iinfo(np.int64).max,
                    (idx - naxis) // nxsector)


# ---------------------------------------------------------------------------
# half-cell -> unit-cell / full-annulus expansion (annular_meshes.jl:269-570)


def _ordered_lines(tets: np.ndarray, naxis: int, nbloch: int) -> np.ndarray:
    """Unique tet edges ordered [axis-lines | bloch-lines | rest] by
    (max endpoint, min endpoint) — the grouping the Bloch line-DOF
    bookkeeping requires (annular_meshes.jl:470-482)."""
    edges = np.concatenate([tets[:, [0, 1]], tets[:, [0, 2]], tets[:, [0, 3]],
                            tets[:, [1, 2]], tets[:, [1, 3]], tets[:, [2, 3]]])
    edges = np.sort(edges, axis=1)
    edges = np.unique(edges, axis=0)
    order = np.lexsort((edges[:, 0], edges[:, 1]))
    return edges[order]


def extend_mesh(mesh: Mesh, doms: Sequence[Tuple[str, str]],
                sym_name: str = "Symmetry", blch_name: str = "Bloch",
                unit: bool = False) -> Mesh:
    """Create the unit cell (``unit=True``) or the full annulus from a
    half-cell mesh whose Bloch and symmetry planes are tagged as 2-D
    domains.  ``doms`` lists (domain, copy_degree) with copy_degree in
    {'full', 'unit', 'half'} (see annular_meshes.jl:255-268)."""
    npoints = mesh.n_points
    pts = mesh.points

    bloch_pts = np.unique(mesh.triangles[
        np.asarray(mesh.domains[blch_name]["simplices"], int)])
    sym_pts = np.unique(mesh.triangles[
        np.asarray(mesh.domains[sym_name]["simplices"], int)])
    axis_pts = np.intersect1d(bloch_pts, sym_pts)

    naxis = len(axis_pts)
    nbloch = len(bloch_pts)
    nsymmetry = len(sym_pts)
    nxsymmetry = nsymmetry - naxis
    nxbloch = nbloch - naxis
    nbody = npoints - nbloch - nxsymmetry
    shiftbody = npoints - nbloch
    nxsector = nxbloch + nbody + nxsymmetry + nbody
    nsector = nxsector + naxis

    # new point order: [axis | bloch\axis | body | symmetry\axis]
    isin = np.zeros(npoints, dtype=np.int8)
    isin[sym_pts] = 3
    isin[bloch_pts] = 2
    isin[axis_pts] = 1
    body_pts = np.nonzero(isin == 0)[0]
    xbloch_pts = np.setdiff1d(bloch_pts, axis_pts)
    xsym_pts = np.setdiff1d(sym_pts, axis_pts)
    new_order = np.concatenate([axis_pts, xbloch_pts, body_pts, xsym_pts])
    trace = np.empty(npoints, dtype=np.int64)
    trace[new_order] = np.arange(npoints)

    # planes (normals pointing away from the mesh interior)
    if mesh.tri2tet is None:
        mesh.link_triangles_to_tetrahedra()
    s_idx = int(np.asarray(mesh.domains[sym_name]["simplices"])[0])
    tri = mesh.triangles[s_idx]
    pln = three_points_to_plane(pts[:, tri])
    tet = mesh.tetrahedra[mesh.tri2tet[s_idx]]
    test = pts[:, [v for v in tet if v not in tri][0]]
    pln = make_normal_outwards(pln, test)

    b_idx = int(np.asarray(mesh.domains[blch_name]["simplices"])[0])
    trib = mesh.triangles[b_idx]
    bpln = three_points_to_plane(pts[:, trib])
    tetb = mesh.tetrahedra[mesh.tri2tet[b_idx]]
    testb = pts[:, [v for v in tetb if v not in trib][0]]
    bpln = make_normal_outwards(bpln, testb)

    # unit-cell points: append reflected body + reflected bloch points
    points = np.zeros((3, 2 * npoints - nsymmetry))
    points[:, :npoints] = pts[:, new_order]
    body_slice = points[:, nbloch:npoints - nxsymmetry]
    points[:, nbloch + shiftbody:npoints - nxsymmetry + shiftbody] = \
        reflect_points_at_plane(body_slice, pln)
    xb_slice = points[:, naxis:nbloch]
    points[:, naxis + nxsector:nbloch + nxsector] = \
        reflect_points_at_plane(xb_slice, pln)

    # degree of symmetry from the plane angle (annular_meshes.jl:371-373)
    phi = np.arccos(np.clip(pln[:3] @ (-bpln[:3]), -1, 1))
    DOS = int(round(np.pi / phi))
    p0, n0 = plane_intersection(pln, bpln)
    dphi = 2 * np.pi / DOS

    if unit:
        fpoints = points
        DOS_lim = 1
    else:
        DOS_lim = DOS
        nf = naxis + nxsector * DOS
        fpoints = np.zeros((3, nf))
        fpoints[:, :nsector] = points[:, :nsector]
        for s in range(1, DOS):
            R = rotation_matrix(n0, s * dphi)
            blk = points[:, naxis:naxis + nxsector]
            fpoints[:, naxis + nxsector * s:naxis + nxsector * (s + 1)] = \
                R @ (blk - p0[:, None]) + p0[:, None]

    def refl(idx):
        return get_reflected_index(idx, naxis, nxbloch, nbody, shiftbody,
                                   nxsymmetry, nxsector)

    def rot(idx, s):
        return get_rotated_index(idx, s, naxis, nxsector, DOS)

    # tetrahedra: original + reflected, rotated into each sector
    t0 = trace[mesh.tetrahedra]
    tr = refl(t0)
    tet_list = []
    for s in range(DOS_lim):
        tet_list.append(rot(t0, s))
        tet_list.append(rot(tr, s))
    tetrahedra, _ = unique_simplices(np.concatenate(tet_list))

    # triangles: skip symmetry always; skip bloch unless unit
    sym_set = set(np.asarray(mesh.domains[sym_name]["simplices"], int).tolist())
    blc_set = set(np.asarray(mesh.domains[blch_name]["simplices"], int).tolist())
    keep = [i for i in range(len(mesh.triangles))
            if i not in sym_set and (unit or i not in blc_set)]
    tri0 = trace[mesh.triangles[keep]]
    trir = refl(tri0)
    tri_list = []
    for s in range(DOS_lim):
        tri_list.append(rot(tri0, s))
        tri_list.append(rot(trir, s))
    triangles, _ = unique_simplices(np.concatenate(tri_list))

    # lines: ordered [axis | bloch | rest]; reflections added for non-bloch
    lines0 = _ordered_lines(trace[mesh.tetrahedra], naxis, nbloch)
    refl_lines = refl(lines0)
    keep_r = ~np.all(lines0 < nbloch, axis=1)
    all_lines = np.unique(np.sort(np.concatenate(
        [lines0, refl_lines[keep_r]]), axis=1), axis=0)
    order = np.lexsort((all_lines[:, 0], all_lines[:, 1]))
    lines = all_lines[order]
    naxis_ln = int(np.sum(np.all(lines < naxis, axis=1)))
    nbloch_ln = int(np.sum(np.all(lines < nbloch, axis=1)))
    nxbloch_ln = nbloch_ln - naxis_ln
    nsector_ln = len(lines)
    nxsector_ln = nsector_ln - naxis_ln
    if unit:
        # bloch-image line DOFs appended at the end (the quad Bloch
        # reduction removes exactly these, fem/bloch.py)
        img = rot(lines[naxis_ln:nbloch_ln], 1)
        lines = np.concatenate([lines, img])
    else:
        # full annulus needs no Bloch line bookkeeping — a plain unique
        # edge set suffices for P2 numbering
        extra = [rot(lines[naxis_ln:nsector_ln], s) for s in range(1, DOS)]
        lines = np.unique(np.sort(np.concatenate([lines] + extra), axis=1),
                          axis=0)

    # domains
    domains: Dict[str, Dict] = {}
    for dom, degree in doms:
        dim = int(mesh.domains[dom]["dimension"])
        src = mesh.tetrahedra if dim == 3 else mesh.triangles
        store = tetrahedra if dim == 3 else triangles
        sidx = np.asarray(mesh.domains[dom]["simplices"], int)
        smplx = trace[src[sidx]]
        rsmplx = refl(smplx)
        if degree == "full":
            buckets = {dom: []}
        elif degree == "unit":
            buckets = {f"{dom}#{s}": [] for s in range(DOS_lim)}
        elif degree == "half":
            buckets = {}
            for s in range(DOS_lim):
                buckets[f"{dom}#{s}.0"] = []
                buckets[f"{dom}#{s}.1"] = []
        else:
            raise ValueError(f"copy_degree {degree!r} not supported")
        for s in range(DOS_lim):
            idx = find_simplices(store, rot(smplx, s))
            ridx = find_simplices(store, rot(rsmplx, s))
            if degree == "full":
                buckets[dom] += [idx, ridx]
            elif degree == "unit":
                buckets[f"{dom}#{s}"] += [idx, ridx]
            else:
                buckets[f"{dom}#{s}.0"].append(idx)
                buckets[f"{dom}#{s}.1"].append(ridx)
        for name, parts in buckets.items():
            arr = np.unique(np.concatenate(parts))
            arr = arr[arr >= 0]
            domains[name] = {"dimension": dim, "simplices": arr}

    # per-unit-cell simplex counts (the reference documents these SymInfo
    # fields, Meshutils.jl:22-23, but always stores 0 at
    # annular_meshes.jl:565 — populated here: tets per cell, and surface
    # tris per cell excluding the Bloch plane and its image)
    nxsector_tet = len(tetrahedra) if unit else len(tetrahedra) // DOS
    if unit:
        on_bloch = np.all(triangles < nbloch, axis=1)
        img_lo, img_hi = naxis + nxsector, naxis + nxsector + nxbloch
        on_image = np.all((triangles < naxis)
                          | ((triangles >= img_lo) & (triangles < img_hi)),
                          axis=1)
        nxsector_tri = len(triangles) - int(on_bloch.sum()) \
            - int(on_image.sum())
    else:
        nxsector_tri = len(triangles) // DOS

    out = Mesh(fpoints, lines, triangles, None, tetrahedra, domains,
               name=("unit from " if unit else "extended from ") + mesh.name,
               file=mesh.file)
    out.dos = SymInfo(DOS, naxis, nxbloch, nbody, shiftbody, nxsymmetry,
                      nxsector, naxis_ln, nxbloch_ln, nxsector_ln,
                      nxsector_tri, nxsector_tet,
                      n=n0, pnt=p0, unit=unit)
    return out


def bloch_expand(mesh: Mesh, sol_or_vec, b=None,
                 full_mesh: Optional[Mesh] = None) -> np.ndarray:
    """Expand a unit-cell eigenvector to the full annulus:
    v_s = v·exp(+2πi·b·s/DOS) per sector (bloch_expand, Bloch.jl:120-143).

    Point (P1) DOFs follow the reference.  P2 vectors (point + edge DOFs)
    additionally need BOTH meshes of the extend_mesh pair — pass the
    second one as ``full_mesh`` (either order; they are told apart by
    ``dos.unit``).  Every full-annulus edge is rotated back into the
    reference sector, matched against the unit mesh's edge list (image
    edges map to the reference Bloch-plane edges with one extra sector
    phase), and phased by its owning sector — beyond the reference, whose
    ``bloch_expand`` is P1-only (Bloch.jl:120-143)."""
    dos = mesh.dos
    if hasattr(sol_or_vec, "v"):
        vec = sol_or_vec.v
        B = sol_or_vec.params[b if b is not None else "b"]
    else:
        vec = np.asarray(sol_or_vec)
        B = b if b is not None else 0
    naxis, nxs, DOS = dos.naxis, dos.nxsector, dos.DOS
    npt_full = naxis + nxs * DOS
    npt_red = naxis + nxs              # reduced point DOFs of the unit cell
    phases = np.exp(2j * np.pi / DOS * B * np.arange(DOS + 1))

    v = np.zeros(npt_full, dtype=np.complex128)
    v[:naxis] = vec[:naxis]
    for s in range(DOS):
        v[naxis + s * nxs:naxis + (s + 1) * nxs] = \
            vec[naxis:naxis + nxs] * phases[s]
    if len(vec) == npt_red:            # P1: points only
        return v

    # ---- P2: expand the edge DOFs --------------------------------------
    pair = (mesh, full_mesh) if full_mesh is not None else (mesh, None)
    unit_m = next((m for m in pair if m is not None and m.dos.unit), None)
    full_m = next((m for m in pair if m is not None and not m.dos.unit),
                  None)
    if unit_m is None or full_m is None:
        raise ValueError("bloch_expand of a P2 (quad) eigenvector needs "
                         "both meshes of the extend_mesh pair (pass the "
                         "other one as full_mesh=)")
    udos = unit_m.dos
    naxis_ln, nxbloch_ln = udos.naxis_ln, udos.nxbloch_ln
    nxsector_ln = udos.nxsector_ln
    nred_ln = naxis_ln + nxsector_ln   # reduced edge DOFs of the unit cell
    if len(vec) != npt_red + nred_ln:
        raise ValueError(f"vector length {len(vec)} is neither P1 "
                         f"({npt_red}) nor P2 ({npt_red + nred_ln})")
    ulines = np.sort(np.asarray(unit_m.lines), axis=1)
    # packed keys for unit edge lookup (shared n_max — see mesh.core)
    n_max = int(max(ulines.max(), naxis + nxs * DOS)) + 1
    ukey = ulines[:, 0].astype(np.int64) * n_max + ulines[:, 1]
    uorder = np.argsort(ukey)
    ukey_s = ukey[uorder]

    flines = np.sort(np.asarray(full_m.lines), axis=1)
    # owning sector: max over non-axis endpoints of their sector index,
    # except the wrap pair {0, DOS-1} which sector DOS-1 owns (its image
    # plane is sector 0's reference plane)
    sec = np.where(flines < naxis, -1, (flines - naxis) // nxs)
    s_lo, s_hi = sec.min(axis=1), sec.max(axis=1)
    # adjacent sectors (s, s+1): sector s owns the edge (the shared plane
    # is s's IMAGE plane = s+1's reference plane); wrap pair {0, DOS-1}
    # is owned by DOS-1 whose image plane is sector 0's reference plane
    owner = np.where(s_lo < 0, s_hi, s_lo)
    wrap = (s_lo == 0) & (s_hi == DOS - 1)
    owner = np.where(wrap, DOS - 1, owner)
    owner = np.where(s_hi < 0, 0, owner)          # pure axis edge
    # neighbor-sector endpoints (owner's image plane) rotate back to the
    # unit image block automatically via modular sector arithmetic
    back = get_rotated_index(flines, (-owner[:, None]) % DOS, naxis, nxs,
                             DOS)
    back = np.sort(back, axis=1)
    fkey = back[:, 0].astype(np.int64) * n_max + back[:, 1]
    pos = np.searchsorted(ukey_s, fkey)
    ok = (pos < len(ukey_s)) & (ukey_s[np.minimum(pos, len(ukey_s) - 1)]
                                == fkey)
    if not np.all(ok):
        raise ValueError("full-annulus edge has no unit-cell counterpart — "
                         "meshes are not an extend_mesh unit/full pair")
    uidx = uorder[pos]
    image_start = nred_ln              # image edges appended after reduced
    is_image = uidx >= image_start
    red_idx = np.where(is_image, naxis_ln + (uidx - image_start), uidx)
    ph = np.where(uidx < naxis_ln, np.ones_like(phases[0]),
                  phases[np.where(is_image, owner + 1, owner)])
    return np.concatenate([v, vec[npt_red + red_idx] * ph])


__all__ = ["extend_mesh", "bloch_expand", "three_points_to_plane",
           "reflect_points_at_plane", "rotation_matrix", "plane_intersection",
           "get_rotated_index", "get_reflected_index", "get_point_sector",
           "make_normal_outwards"]
