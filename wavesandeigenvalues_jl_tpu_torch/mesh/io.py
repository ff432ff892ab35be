"""Mesh file readers: gmsh v4.1, gmsh v2.2, Nastran bulk data, ANSYS fluent.

Host Python, copied from the JAX package's ``mesh/io.py``.  Reference
parsers: read_msh4 (Meshutils.jl:272-402), read_msh2
(Meshutils.jl:412-499), read_nastran (src/Mesh/read_nastran.jl), fluent
(Meshutils.jl:1239-1341).  Node/element tags are converted to 0-based
indices; duplicate elements are removed and domain references re-indexed by
:meth:`Mesh.from_raw`."""
from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np

from .core import Mesh


def read_mesh(file_name: str, scale: float = 1.0) -> Mesh:
    """Dispatch on file extension like the reference Mesh constructor
    (Meshutils.jl:92-120)."""
    ext = file_name.rsplit(".", 1)[-1].lower()
    if ext == "msh":
        with open(file_name) as f:
            f.readline()
            ver = f.readline().strip()
        if ver.startswith("4"):
            raw = read_msh4(file_name)
        else:
            raw = read_msh2(file_name)
    elif ext in ("nas", "bdf"):
        raw = read_nastran(file_name)
    elif ext in ("cas", "flu"):
        raw = read_ansys(file_name)
    else:
        raise ValueError(f"mesh type .{ext} not supported")
    points, lines, triangles, tetrahedra, domains = raw
    return Mesh.from_raw(points, lines, triangles, tetrahedra, domains,
                         name=os.path.basename(file_name), file=file_name,
                         scale=scale)


def read_msh4(file_name: str):
    """gmsh v4.1 ASCII: PhysicalNames / Entities / Nodes / Elements."""
    tag2dom: Dict[str, str] = {}
    ent2dom = [dict() for _ in range(4)]
    domains: Dict[str, Dict] = {}
    points = None
    lines: List[List[int]] = []
    triangles: List[List[int]] = []
    tetrahedra: List[List[int]] = []
    with open(file_name) as fid:
        it = iter(fid)
        for line in it:
            fld = line.strip()
            if fld == "$PhysicalNames":
                n = int(next(it))
                for _ in range(n):
                    parts = next(it).split()
                    dim, tag = int(parts[0]), parts[1]
                    dom = " ".join(parts[2:]).strip('"')
                    tag2dom[tag] = dom
                    domains[dom] = {"dimension": dim, "simplices": []}
            elif fld == "$Entities":
                counts = [int(x) for x in next(it).split()]
                for d, cnt in enumerate(counts):
                    for _ in range(cnt):
                        parts = next(it).split()
                        ent_tag = parts[0]
                        # points entities: tag x y z numPhys phys...
                        # others: tag 6×bbox numPhys phys... (v4.1)
                        off = 4 if d == 0 else 7
                        n_phys = int(parts[off])
                        phys = parts[off + 1: off + 1 + n_phys]
                        ent2dom[d][ent_tag] = [tag2dom[t] for t in phys
                                               if t in tag2dom]
            elif fld == "$Nodes":
                nblocks, nnodes, _, maxtag = (int(x) for x in next(it).split())
                points = np.zeros((3, maxtag))
                used = np.zeros(maxtag, dtype=bool)
                for _ in range(nblocks):
                    _, _, parametric, nb = (int(x) for x in next(it).split())
                    tags = [int(next(it)) for _ in range(nb)]
                    for t in tags:
                        xyz = [float(x) for x in next(it).split()]
                        points[:, t - 1] = xyz[:3]
                        used[t - 1] = True
            elif fld == "$Elements":
                nblocks, *_ = (int(x) for x in next(it).split())
                for _ in range(nblocks):
                    parts = next(it).split()
                    ent_dim, ent_tag = int(parts[0]), parts[1]
                    etype, nb = int(parts[2]), int(parts[3])
                    doms = ent2dom[ent_dim].get(ent_tag, [])
                    for _ in range(nb):
                        nodes = [int(x) - 1 for x in next(it).split()[1:]]
                        if etype == 1:
                            lines.append(nodes[:2])
                            for dm in doms:
                                domains[dm]["simplices"].append(len(lines) - 1)
                        elif etype == 2:
                            triangles.append(nodes[:3])
                            for dm in doms:
                                domains[dm]["simplices"].append(len(triangles) - 1)
                        elif etype == 4:
                            tetrahedra.append(nodes[:4])
                            for dm in doms:
                                domains[dm]["simplices"].append(len(tetrahedra) - 1)
    lines = np.asarray(lines, np.int64).reshape(-1, 2)
    triangles = np.asarray(triangles, np.int64).reshape(-1, 3)
    tetrahedra = np.asarray(tetrahedra, np.int64).reshape(-1, 4)
    return points, lines, triangles, tetrahedra, domains


def read_msh2(file_name: str):
    """gmsh v2.2 ASCII (legacy) reader."""
    tag2dom: Dict[int, str] = {}
    domains: Dict[str, Dict] = {}
    points = None
    lines, triangles, tetrahedra = [], [], []
    with open(file_name) as fid:
        it = iter(fid)
        for line in it:
            fld = line.strip()
            if fld == "$PhysicalNames":
                n = int(next(it))
                for _ in range(n):
                    parts = next(it).split()
                    dim, tag = int(parts[0]), int(parts[1])
                    dom = " ".join(parts[2:]).strip('"')
                    tag2dom[tag] = dom
                    domains[dom] = {"dimension": dim, "simplices": []}
            elif fld == "$Nodes":
                n = int(next(it))
                points = np.zeros((3, n))
                for _ in range(n):
                    parts = next(it).split()
                    points[:, int(parts[0]) - 1] = [float(x) for x in parts[1:4]]
            elif fld == "$Elements":
                n = int(next(it))
                for _ in range(n):
                    parts = [int(x) for x in next(it).split()]
                    etype, ntags = parts[1], parts[2]
                    tags = parts[3:3 + ntags]
                    nodes = [x - 1 for x in parts[3 + ntags:]]
                    phys = tags[0] if tags else None
                    dom = tag2dom.get(phys)
                    if etype == 1:
                        lines.append(nodes[:2])
                        if dom:
                            domains[dom]["simplices"].append(len(lines) - 1)
                    elif etype == 2:
                        triangles.append(nodes[:3])
                        if dom:
                            domains[dom]["simplices"].append(len(triangles) - 1)
                    elif etype == 4:
                        tetrahedra.append(nodes[:4])
                        if dom:
                            domains[dom]["simplices"].append(len(tetrahedra) - 1)
    lines = np.asarray(lines, np.int64).reshape(-1, 2)
    triangles = np.asarray(triangles, np.int64).reshape(-1, 3)
    tetrahedra = np.asarray(tetrahedra, np.int64).reshape(-1, 4)
    return points, lines, triangles, tetrahedra, domains


def _nas_number(txt: str) -> float:
    """Nastran exponent-less float format: '1.5-3' == 1.5e-3."""
    t = txt.strip()
    if not t:
        return 0.0
    m = re.fullmatch(r"([+-]?[\d.]+)([+-]\d+)", t)
    if m:
        return float(m.group(1) + "e" + m.group(2))
    return float(t)


def _nas_fields(line: str, fmt: str = "short") -> List[str]:
    if "," in line:
        return [x.strip() for x in line.split(",")]
    if fmt == "long":
        out = [line[:8]]
        rest = line[8:]
        for i in range(0, len(rest), 16):
            out.append(rest[i:i + 16])
        return out
    return [line[i:i + 8] for i in range(0, len(line), 8)]


def read_nastran(file_name: str):
    """Nastran bulk data: GRID/GRID*/CTRIA3/CTRIA6/CTETRA with ANSA and
    HMNAME comment name-tags (read_nastran.jl:9-255)."""
    name_tags: Dict[str, str] = {}
    pts: Dict[int, List[float]] = {}
    triangles, tetrahedra = [], []
    domains: Dict[str, Dict] = {}

    def dom_name(tag: str, kind: str) -> str:
        tag = tag.strip()
        if tag in name_tags:
            return name_tags[tag]
        return (("surf" if kind == "s" else "vol") + tag.zfill(4))

    with open(file_name) as fid:
        it = iter(fid)
        for line in it:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] == "$":
                if line[1:18] == "ANSA_NAME_COMMENT":
                    data = line[1:].split(";")
                    if len(data) > 3 and data[2] in ("PSOLID", "PSHELL"):
                        name_tags[data[1]] = data[3]
                elif line[1:12] == "HMNAME COMP":
                    data = line[13:].strip().split('"')
                    if len(data) >= 2:
                        name_tags[data[0].strip()] = data[1]
                continue
            if len(line) < 8:
                continue
            head = line[:8]
            if head == "GRID    " or head.startswith("GRID,"):
                d = _nas_fields(line)
                pts[int(d[1])] = [_nas_number(d[3]), _nas_number(d[4]),
                                  _nas_number(d[5])]
            elif head == "GRID*   ":
                d = _nas_fields(line, "long")
                idx = int(d[1])
                x, y = _nas_number(d[3]), _nas_number(d[4])
                d2 = _nas_fields(next(it), "long")
                pts[idx] = [x, y, _nas_number(d2[1])]
            elif head[:6] in ("CTRIA3", "CTRIA6"):
                d = _nas_fields(line)
                dom = dom_name(d[2], "s")
                triangles.append([int(d[3]) - 1, int(d[4]) - 1, int(d[5]) - 1])
                domains.setdefault(dom, {"dimension": 2, "simplices": []})[
                    "simplices"].append(len(triangles) - 1)
            elif head[:6] == "CTETRA":
                d = _nas_fields(line)
                dom = dom_name(d[2], "v")
                tetrahedra.append([int(d[3]) - 1, int(d[4]) - 1,
                                   int(d[5]) - 1, int(d[6]) - 1])
                domains.setdefault(dom, {"dimension": 3, "simplices": []})[
                    "simplices"].append(len(tetrahedra) - 1)
    n = max(pts) if pts else 0
    points = np.zeros((3, n))
    for i, xyz in pts.items():
        points[:, i - 1] = xyz
    # trim unused trailing points (read_nastran.jl:166-183)
    used = set()
    for t in tetrahedra:
        used.update(t)
    for t in triangles:
        used.update(t)
    if used:
        points = points[:, :max(used) + 1]
    lines = np.zeros((0, 2), np.int64)
    return (points, lines, np.asarray(triangles, np.int64).reshape(-1, 3),
            np.asarray(tetrahedra, np.int64).reshape(-1, 4), domains)


def read_ansys(file_name: str):
    """ANSYS Fluent ASCII mesh (.cas/.msh scheme sections)
    (read_ansys, Meshutils.jl:1239-1341).

    Sections parsed: ``(10 …)`` nodes, ``(13 …)`` triangular faces with
    left/right cell adjacency (cells are reconstructed as the union of
    their faces' points — tetrahedra have exactly 4 distinct points),
    ``(12 …)`` cell zones, ``(45 …)`` zone names.  Boundary faces
    (one adjacent cell id 0) become surface triangles; boundary face zones
    become dimension-2 domains, cell zones dimension-3 domains."""
    points = None
    cell_pts: List[set] = []
    triangles: List[List[int]] = []
    tri_zone: List[tuple] = []
    cell_zones: Dict[str, np.ndarray] = {}
    names: Dict[str, str] = {}

    with open(file_name) as fid:
        it = iter(fid)
        for line in it:
            s = line.split()
            if not s:
                continue
            if s[0] == "(10" and s[1] == "(0":
                points = np.zeros((3, int(s[3], 16)))
            elif s[0] == "(10":
                first, last = int(s[2], 16), int(s[3], 16)
                for idx in range(first, last + 1):
                    xyz = [float(x) for x in next(it).split()[:3]]
                    points[:len(xyz), idx - 1] = xyz
            elif s[0] == "(12" and s[1] == "(0":
                n_cells = int(s[3], 16)
                cell_pts = [set() for _ in range(n_cells)]
            elif s[0] == "(12":
                zone = s[1][1:]
                first, last = int(s[2], 16), int(s[3], 16)
                cell_zones[zone] = np.arange(first - 1, last)
            elif s[0] == "(13" and s[1] != "(0":
                zone = s[1][1:]
                first, last = int(s[2], 16), int(s[3], 16)
                zone_tris = []
                for _ in range(first, last + 1):
                    f = next(it).split()
                    # mixed face sections lead with a vertex count
                    if len(f) == 6 and f[0] == "3":
                        f = f[1:]
                    tri = [int(x, 16) - 1 for x in f[:3]]
                    left, right = int(f[-2], 16), int(f[-1], 16)
                    for c in (left, right):
                        if c != 0:
                            cell_pts[c - 1].update(tri)
                    if left == 0 or right == 0:
                        triangles.append(tri)
                        zone_tris.append(len(triangles) - 1)
                if zone_tris:
                    tri_zone.append((zone, zone_tris))
            elif s[0] == "(45" and len(s) >= 4:
                # (45 (zone-id zone-type zone-name)())
                names[s[1][1:]] = s[3].strip("()")

    bad = [i for i, c in enumerate(cell_pts) if len(c) != 4]
    if bad:
        raise ValueError(f"non-tetrahedral fluent cells (first: {bad[0]}, "
                         f"{len(cell_pts[bad[0]])} points) are not supported")
    tetrahedra = np.array([sorted(c) for c in cell_pts],
                          dtype=np.int64).reshape(-1, 4)
    domains: Dict[str, Dict] = {}
    for zone, tris in tri_zone:
        domains[names.get(zone, "surf" + zone)] = {
            "dimension": 2, "simplices": np.asarray(tris, np.int64)}
    for zone, cells in cell_zones.items():
        domains[names.get(zone, "vol" + zone)] = {
            "dimension": 3, "simplices": cells}
    lines = np.zeros((0, 2), np.int64)
    return (points, lines,
            np.asarray(triangles, np.int64).reshape(-1, 3),
            tetrahedra, domains)


__all__ = ["read_mesh", "read_msh4", "read_msh2", "read_nastran",
           "read_ansys"]
