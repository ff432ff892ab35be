"""Tetrahedral mesh core.

Host numpy, copied from the JAX package's ``mesh/core.py``.  Counterpart
of the reference's Meshutils module (Mesh and SymInfo types,
src/Meshutils.jl:28-82) re-designed around *vectorized* canonical simplex
indexing: where the reference maintains lexicographically ordered lists
with O(log n) per-element binary-search insertion (src/Mesh/sorter.jl),
simplices here live in flat [n, k] integer arrays with packed sort keys —
dedup, lookup, edge enumeration and adjacency are single numpy array ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np


@dataclass
class SymInfo:
    """Symmetry metadata of annular meshes (Meshutils.jl:28-44)."""

    DOS: int
    naxis: int
    nxbloch: int
    nbody: int
    shiftbody: int
    nxsymmetry: int
    nxsector: int
    naxis_ln: int = 0
    nxbloch_ln: int = 0
    nxsector_ln: int = 0
    nxsector_tri: int = 0
    nxsector_tet: int = 0
    n: Optional[np.ndarray] = None
    pnt: Optional[np.ndarray] = None
    unit: bool = False


# ---------------------------------------------------------------------------
# canonical simplex keys


def simplex_keys(simplices: np.ndarray) -> np.ndarray:
    """Orientation-independent packed keys: vertices sorted ascending, then
    lexicographic encoding into a structured void view for O(n log n) bulk
    operations (replaces sorter.jl's compare/sort_smplx)."""
    s = np.sort(np.asarray(simplices, dtype=np.int64), axis=1)
    return s


def _key_view(sorted_simplices: np.ndarray, n_max: int = 0):
    """Sortable 1-D key array for canonically sorted simplex rows.

    When the vertex ids fit, rows are packed into single int64 mixed-radix
    keys (fast scalar sort); otherwise a structured void view is used
    (lexicographic compare per field, slower)."""
    a = np.ascontiguousarray(sorted_simplices)
    k = a.shape[1]
    if n_max <= 0:
        n_max = int(a.max()) + 1 if a.size else 1
    if n_max ** k < (1 << 62):
        key = a[:, 0].astype(np.int64)
        for j in range(1, k):
            key = key * n_max + a[:, j]
        return key
    return a.view([("", a.dtype)] * k).ravel()


def unique_simplices(simplices: np.ndarray):
    """Deduplicate rows by canonical key.  Returns (unique_rows [m,k] in
    canonical order, inverse map [n] original→unique index)."""
    simplices = np.asarray(simplices, dtype=np.int64)
    if simplices.size == 0:
        return simplices.reshape(0, simplices.shape[1] if simplices.ndim == 2 else 0), \
            np.zeros(0, dtype=np.int64)
    keys = _key_view(simplex_keys(simplices))
    _, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
    return simplices[first], inverse


def find_simplices(store: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Indices of ``query`` rows inside canonical ``store`` (-1 if absent);
    vectorized find_smplx (sorter.jl:158-169)."""
    if len(store) == 0:
        return np.full(len(query), -1, dtype=np.int64)
    query = np.asarray(query, dtype=np.int64)
    n_max = max(int(store.max()), int(query.max()) if query.size else 0) + 1
    skeys = _key_view(simplex_keys(store), n_max)
    qkeys = _key_view(simplex_keys(query), n_max)
    order = np.argsort(skeys)
    pos = np.searchsorted(skeys[order], qkeys)
    pos = np.clip(pos, 0, len(store) - 1)
    hit = skeys[order[pos]] == qkeys
    out = np.where(hit, order[pos], -1)
    return out


class Mesh:
    """Unstructured tetrahedral mesh (Meshutils.jl:71-82).

    points: [3, N] coordinates; lines/triangles/int_triangles/tetrahedra:
    [n, k] index arrays (0-based); domains: name -> {"dimension": d,
    "simplices": index array into the matching simplex list}."""

    def __init__(self, points, lines=None, triangles=None, int_triangles=None,
                 tetrahedra=None, domains=None, name="mesh", file=""):
        self.points = np.asarray(points, dtype=np.float64)
        self.lines = (np.zeros((0, 2), np.int64) if lines is None
                      else np.asarray(lines, dtype=np.int64))
        self.triangles = (np.zeros((0, 3), np.int64) if triangles is None
                          else np.asarray(triangles, dtype=np.int64))
        self.int_triangles = (np.zeros((0, 3), np.int64) if int_triangles is None
                              else np.asarray(int_triangles, dtype=np.int64))
        self.tetrahedra = (np.zeros((0, 4), np.int64) if tetrahedra is None
                           else np.asarray(tetrahedra, dtype=np.int64))
        self.domains: Dict[str, Dict] = domains if domains is not None else {}
        self.name = name
        self.file = file
        self.tri2tet: Optional[np.ndarray] = None
        self.dos: Optional[SymInfo] = None

    # -- basic info ---------------------------------------------------------
    @property
    def n_points(self) -> int:
        return self.points.shape[1]

    def __repr__(self):
        txt = (f"mesh: {self.name}\n#points: {self.n_points}\n"
               f"#lines: {len(self.lines)}\n#triangles: {len(self.triangles)}\n"
               f"#tetrahedra: {len(self.tetrahedra)}\n#domains: "
               f"{', '.join(self.domains.keys())}")
        return txt

    # -- construction helpers ----------------------------------------------
    @classmethod
    def from_raw(cls, points, lines, triangles, tetrahedra, domains,
                 name="mesh", file="", scale=1.0):
        """Dedup raw element lists and re-index domain references
        (Mesh constructor, Meshutils.jl:92-165)."""
        points = np.asarray(points, dtype=np.float64) * scale
        lines = np.asarray(lines, dtype=np.int64).reshape(-1, 2)
        triangles = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
        tetrahedra = np.asarray(tetrahedra, dtype=np.int64).reshape(-1, 4)
        ul, inv_l = unique_simplices(lines)
        ut, inv_t = unique_simplices(triangles)
        utt, inv_tt = unique_simplices(tetrahedra)
        inverse = {1: inv_l, 2: inv_t, 3: inv_tt}
        new_domains: Dict[str, Dict] = {}
        for dom, dd in domains.items():
            dim = int(dd["dimension"])
            idx = np.asarray(dd["simplices"], dtype=np.int64)
            if dim in inverse and len(idx):
                idx = inverse[dim][idx]
            new_domains[dom] = {"dimension": dim,
                                "simplices": np.unique(idx)}
        return cls(points, ul, ut, None, utt, new_domains, name=name, file=file)

    # -- topology -----------------------------------------------------------
    def collect_lines(self):
        """Populate ``lines`` with the unique edges of all tetrahedra —
        the P2 edge-DOF index space (collect_lines!, Meshutils.jl:831-848).

        Pre-existing line elements (e.g. gmsh curve groups) are kept and
        merged; dimension-1 domain indices are remapped to the dedup'd
        store."""
        t = self.tetrahedra
        edges = np.concatenate([t[:, [0, 1]], t[:, [0, 2]], t[:, [0, 3]],
                                t[:, [1, 2]], t[:, [1, 3]], t[:, [2, 3]]])
        if len(self.tetrahedra) == 0 and len(self.triangles) > 0:
            tr = self.triangles
            edges = np.concatenate([tr[:, [0, 1]], tr[:, [0, 2]],
                                    tr[:, [1, 2]]])
        n_old = len(self.lines)
        if n_old > 0:
            merged = np.concatenate([self.lines, edges])
            uniq, inv = unique_simplices(merged)
            if len(uniq) == n_old:
                return self.lines  # already complete
            self.lines = uniq
            for dd in self.domains.values():
                if dd["dimension"] == 1 and len(dd["simplices"]):
                    dd["simplices"] = np.unique(
                        inv[np.asarray(dd["simplices"], dtype=np.int64)])
        else:
            self.lines, _ = unique_simplices(np.sort(edges, axis=1))
        return self.lines

    def edge_indices(self, simplices_edges: np.ndarray) -> np.ndarray:
        """Vectorized get_line_idx: indices of given edges in the edge store."""
        self.collect_lines()
        idx = find_simplices(self.lines, simplices_edges)
        if np.any(idx < 0):
            raise KeyError("edge not present in mesh.lines")
        return idx

    def link_triangles_to_tetrahedra(self):
        """tri2tet adjacency: owning tetrahedron of each surface triangle
        (link_triangles_to_tetrahedra!, Meshutils.jl:516-548)."""
        t = self.tetrahedra
        faces = np.concatenate([t[:, [1, 2, 3]], t[:, [0, 2, 3]],
                                t[:, [0, 1, 3]], t[:, [0, 1, 2]]])
        owner = np.tile(np.arange(len(t)), 4)
        pos = find_simplices(faces, self.triangles)
        if np.any(pos < 0):
            # fall back: faces store is non-unique; build key match
            # (shared radix — keys from different arrays must agree)
            n_max = max(int(faces.max()), int(self.triangles.max())) + 1
            fkeys = _key_view(simplex_keys(faces), n_max)
            tkeys = _key_view(simplex_keys(self.triangles), n_max)
            order = np.argsort(fkeys)
            loc = np.searchsorted(fkeys[order], tkeys)
            loc = np.clip(loc, 0, len(faces) - 1)
            ok = fkeys[order[loc]] == tkeys
            if not np.all(ok):
                raise ValueError("surface triangle without owning tetrahedron")
            self.tri2tet = owner[order[loc]]
        else:
            self.tri2tet = owner[pos]
        return self.tri2tet

    def surface_and_interior_triangles(self):
        """Classify all tet faces into surface (appearing once) and interior
        (twice) triangles (assemble_triangles, Meshutils.jl:550-571)."""
        t = self.tetrahedra
        faces = np.concatenate([t[:, [1, 2, 3]], t[:, [0, 2, 3]],
                                t[:, [0, 1, 3]], t[:, [0, 1, 2]]])
        skeys = _key_view(simplex_keys(faces))
        uniq, first, counts = np.unique(skeys, return_index=True,
                                        return_counts=True)
        surface = faces[first[counts == 1]]
        interior = faces[first[counts == 2]]
        return surface, interior

    # -- metrics ------------------------------------------------------------
    def tet_volumes(self, idx=None) -> np.ndarray:
        t = self.tetrahedra if idx is None else self.tetrahedra[idx]
        p = self.points
        a = p[:, t[:, 0]] - p[:, t[:, 3]]
        b = p[:, t[:, 1]] - p[:, t[:, 3]]
        c = p[:, t[:, 2]] - p[:, t[:, 3]]
        det = (a[0] * (b[1] * c[2] - b[2] * c[1])
               - a[1] * (b[0] * c[2] - b[2] * c[0])
               + a[2] * (b[0] * c[1] - b[1] * c[0]))
        return np.abs(det) / 6.0

    def tri_areas(self, idx=None) -> np.ndarray:
        t = self.triangles if idx is None else self.triangles[idx]
        p = self.points
        a = p[:, t[:, 0]] - p[:, t[:, 2]]
        b = p[:, t[:, 1]] - p[:, t[:, 2]]
        n = np.cross(a.T, b.T)
        return 0.5 * np.linalg.norm(n, axis=1)

    def compute_size(self, domain: str) -> float:
        """Measure (volume/area/length) of a named domain; cached in the
        domain dict (compute_size!, Meshutils.jl:757-798)."""
        dd = self.domains[domain]
        if "size" in dd:
            return dd["size"]
        idx = np.asarray(dd["simplices"], dtype=np.int64)
        if dd["dimension"] == 3:
            size = float(self.tet_volumes(idx).sum())
        elif dd["dimension"] == 2:
            size = float(self.tri_areas(idx).sum())
        else:
            t = self.lines[idx]
            size = float(np.linalg.norm(
                self.points[:, t[:, 0]] - self.points[:, t[:, 1]], axis=0).sum())
        dd["size"] = size
        return size

    # -- domain operations (Meshutils.jl:818-882) ---------------------------
    def unify(self, new: str, *doms: str):
        """Merge domains of equal dimension into a new named domain
        (unify!, Meshutils.jl:849-882)."""
        dim = self.domains[doms[0]]["dimension"]
        idx = []
        for d in doms:
            if self.domains[d]["dimension"] != dim:
                raise ValueError("domains have mixed dimension")
            idx.append(np.asarray(self.domains[d]["simplices"]))
        self.domains[new] = {"dimension": dim,
                             "simplices": np.unique(np.concatenate(idx))}

    def keep(self, *doms: str):
        """Drop all domains except the given ones (keep!,
        Meshutils.jl:818-830)."""
        self.domains = {d: self.domains[d] for d in doms}

    # -- queries ------------------------------------------------------------
    def barycentric(self, x: np.ndarray, tets=None):
        """Barycentric coordinates of point x in every tetrahedron [nt, 4]."""
        t = self.tetrahedra if tets is None else tets
        p = self.points
        x = np.asarray(x, dtype=np.float64).reshape(3)
        v3 = p[:, t[:, 3]]
        T = np.stack([p[:, t[:, 0]] - v3, p[:, t[:, 1]] - v3,
                      p[:, t[:, 2]] - v3], axis=1)  # [3, 3, nt]
        rhs = (x[:, None] - v3)  # [3, nt]
        Tm = np.moveaxis(T, 2, 0)  # [nt, 3, 3]
        lam = np.linalg.solve(Tm, np.moveaxis(rhs, 1, 0)[:, :, None])[:, :, 0]
        lam4 = 1.0 - lam.sum(axis=1)
        return np.concatenate([lam, lam4[:, None]], axis=1)

    def find_tetrahedron_containing_point(self, x, tol=1e-10) -> int:
        """Index of a tetrahedron containing x (find_tetrahedron…,
        Meshutils.jl:800-815), vectorized over all tets."""
        lam = self.barycentric(x)
        inside = np.all(lam >= -tol, axis=1)
        hits = np.nonzero(inside)[0]
        if len(hits) == 0:
            raise ValueError(f"point {x} not inside any tetrahedron")
        return int(hits[0])

    def generate_field(self, fn: Callable, order: str = "lin") -> np.ndarray:
        """Sample scalar field fn(x,y,z) per mesh point (``order="lin"``) or
        per tetrahedron at the centroid (``order="const"``, the reference's
        default) (generate_field, Meshutils.jl:1079-1097)."""
        if order == "const":
            pts = self.points[:, self.tetrahedra].mean(axis=2)
        elif order == "lin":
            pts = self.points
        else:
            raise ValueError(f"field order {order!r} not supported")
        x, y, z = pts
        try:
            return np.asarray(fn(x, y, z), dtype=np.float64)
        except Exception:
            return np.array([fn(*p) for p in pts.T], dtype=np.float64)

    def get_surface_points(self, domains=None):
        """Unique point indices on the surface (optionally restricted to
        named 2-D domains) (get_surface_points, Meshutils.jl:884-968)."""
        if domains is None:
            tris = self.triangles
        else:
            idx = np.unique(np.concatenate([
                np.asarray(self.domains[d]["simplices"]) for d in domains]))
            tris = self.triangles[idx]
        return np.unique(tris)

    def get_normal_vectors(self, domains=None):
        """Area-weighted outward point normals on the surface
        (get_normal_vectors, Meshutils.jl:1030-1069).  Returns [3, N] with
        zeros off-surface; normals are normalized at surface points."""
        if self.tri2tet is None:
            self.link_triangles_to_tetrahedra()
        if domains is None:
            tri_idx = np.arange(len(self.triangles))
        else:
            tri_idx = np.unique(np.concatenate([
                np.asarray(self.domains[d]["simplices"]) for d in domains]))
        tris = self.triangles[tri_idx]
        p = self.points
        a = p[:, tris[:, 1]] - p[:, tris[:, 0]]
        b = p[:, tris[:, 2]] - p[:, tris[:, 0]]
        n = np.cross(a.T, b.T)  # [nt, 3], area-weighted (2A)
        # orient outward: away from the owning tet's opposite vertex
        own = self.tri2tet[tri_idx]
        tet = self.tetrahedra[own]
        # centroid of owning tet
        cen = p[:, tet].mean(axis=2).T  # [nt, 3]
        mid = p[:, tris].mean(axis=2).T
        flip = np.einsum("ij,ij->i", n, mid - cen) < 0
        n[flip] *= -1
        normals = np.zeros((3, self.n_points))
        for k in range(3):
            np.add.at(normals[k], tris[:, 0], n[:, k])
            np.add.at(normals[k], tris[:, 1], n[:, k])
            np.add.at(normals[k], tris[:, 2], n[:, k])
        pts = np.unique(tris)
        nrm = np.linalg.norm(normals[:, pts], axis=0)
        nrm[nrm == 0] = 1.0
        normals[:, pts] /= nrm
        return normals


def color_domains(mesh: Mesh, domains=()):
    """Integer color fields per domain for visualization
    (color_domains, Meshutils.jl:1139-1190).

    Returns (data, surf_keys, vol_keys): ``data`` maps each domain name to
    a per-cell integer field (triangles for 2-D domains, tets for 3-D),
    plus '__all_surfaces__' / '__all_volumes__' combined colorings;
    ``surf_keys``/``vol_keys`` map the domain names to their color index."""
    n_tri = len(mesh.triangles)
    n_tet = len(mesh.tetrahedra)
    tri_color = np.zeros(n_tri, dtype=np.int64)
    tet_color = np.zeros(n_tet, dtype=np.int64)
    data, surf_keys, vol_keys = {}, {}, {}
    if not domains:
        domains = sorted(mesh.domains.keys())
    surf_idx = vol_idx = 0
    for key in domains:
        if key not in mesh.domains:
            print(f"Warning: No domain named '{key}' in mesh.")
            continue
        dom = mesh.domains[key]
        smplcs = np.asarray(dom["simplices"], dtype=np.int64)
        if dom["dimension"] == 2:
            surf_idx += 1
            if np.any(tri_color[smplcs] != 0):
                print(f"domain {key} is overlapping")
            tri_color[smplcs] = surf_idx
            data[key] = np.zeros(n_tri, dtype=np.int64)
            data[key][smplcs] = surf_idx
            surf_keys[key] = surf_idx
        elif dom["dimension"] == 3:
            vol_idx += 1
            if np.any(tet_color[smplcs] != 0):
                print(f"domain {key} is overlapping")
            tet_color[smplcs] = vol_idx
            data[key] = np.zeros(n_tet, dtype=np.int64)
            data[key][smplcs] = vol_idx
            vol_keys[key] = vol_idx
    data["__all_surfaces__"] = tri_color
    data["__all_volumes__"] = tet_color
    return data, surf_keys, vol_keys


__all__ = ["Mesh", "SymInfo", "unique_simplices", "find_simplices",
           "simplex_keys", "color_domains"]
