"""VTU (VTK XML unstructured-grid) output.

Host Python, copied from the JAX package's ``mesh/vtk.py``: the files are
byte for byte the JAX package's.  ``vtk_write(filename, mesh, data)``
mirrors the reference dispatcher (vtk_write,
src/Mesh/vtk_write.jl:272-304): the data dict is
split by array length into up to four files

- ``<name>_const.vtu`` — per-tetrahedron cell data (len == #tets)
- ``<name>_lin.vtu``   — P1 point data (len == #points)
- ``<name>_quad.vtu``  — P2 data on 10-node quadratic tets
  (len == #points + #edges)
- ``<name>_tri.vtu``   — per-surface-triangle cell data (len == #triangles)

Complex fields are written as two arrays ``<key>.real`` / ``<key>.imag``
(ParaView has no native complex type).  Encodings: ``ascii`` (default),
inline base64 ``binary`` (vtk_write.jl:332-409) or ``compressed`` — zlib
block compression, which the reference stubs out (vtk_write.jl:410).
"""
from __future__ import annotations

import base64
import struct
from typing import Dict

import numpy as np

from .core import Mesh

VTK_TETRA = 10
VTK_QUADRATIC_TETRA = 24
VTK_TRIANGLE = 5

# VTK quadratic-tet edge order (0,1),(1,2),(2,0),(0,3),(1,3),(2,3) expressed
# in our edge-DOF slot order AB,AC,AD,BC,BD,CD (fem.assembly.TET_EDGES)
_P2_EDGE_PERM = [0, 3, 1, 2, 4, 5]


def _da(name, arr, fmt: str) -> str:
    arr = np.asarray(arr)
    ncomp = 1 if arr.ndim == 1 else arr.shape[1]
    if arr.dtype.kind in "iu":
        vtype = "Int64"
        arr = arr.astype(np.int64)
    else:
        vtype = "Float64"
        arr = arr.astype(np.float64)
    head = (f'<DataArray type="{vtype}" Name="{name}" '
            f'NumberOfComponents="{ncomp}" '
            f'format="{"ascii" if fmt == "ascii" else "binary"}">')
    if fmt == "ascii":
        body = " ".join(repr(x) for x in arr.ravel().tolist())
    elif fmt == "binary":  # inline base64: uint32 byte-count header + payload
        raw = arr.tobytes()
        body = base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()
    else:  # zlib block compression — implements the stub at vtk_write.jl:410
        # VTK inline-compressed layout: the UInt32 block table
        # [#blocks, blocksize, last-blocksize, compressed-size...] and the
        # zlib payload are base64-encoded SEPARATELY, then concatenated.
        import zlib
        raw = arr.tobytes()
        comp = zlib.compress(raw, 6)
        header = struct.pack("<4I", 1, len(raw), len(raw), len(comp))
        body = (base64.b64encode(header).decode()
                + base64.b64encode(comp).decode())
    return head + "\n" + body + "\n</DataArray>"


def _split_complex(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in data.items():
        v = np.asarray(v)
        if np.iscomplexobj(v):
            out[k + ".real"] = v.real
            out[k + ".imag"] = v.imag
        else:
            out[k] = v
    return out


def _write_vtu(path, points, cells, cell_type, point_data, cell_data, fmt):
    n_pts = points.shape[1]
    n_cells = len(cells)
    compressor = (' compressor="vtkZLibDataCompressor"'
                  if fmt == "compressed" else "")
    parts = ['<?xml version="1.0"?>',
             '<VTKFile type="UnstructuredGrid" version="0.1" '
             f'byte_order="LittleEndian"{compressor}>',
             "<UnstructuredGrid>",
             f'<Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">',
             "<Points>", _da("Points", points.T.reshape(-1, 3), fmt),
             "</Points>", "<Cells>",
             _da("connectivity", cells.ravel(), fmt),
             _da("offsets",
                 np.arange(1, n_cells + 1) * cells.shape[1], fmt),
             _da("types", np.full(n_cells, cell_type, np.int64), fmt),
             "</Cells>"]
    if point_data:
        parts.append("<PointData>")
        for k, v in point_data.items():
            parts.append(_da(k, v, fmt))
        parts.append("</PointData>")
    if cell_data:
        parts.append("<CellData>")
        for k, v in cell_data.items():
            parts.append(_da(k, v, fmt))
        parts.append("</CellData>")
    parts += ["</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    with open(path, "w") as f:
        f.write("\n".join(parts))


def vtk_write(filename: str, mesh: Mesh, data: Dict[str, np.ndarray],
              fmt: str = "ascii"):
    """Write mesh + fields to VTU file(s); dispatch per data length
    (vtk_write.jl:272-304).  Returns the list of files written."""
    if fmt not in ("ascii", "binary", "compressed"):
        raise ValueError("fmt must be 'ascii', 'binary' or 'compressed'")
    data = _split_complex(data)
    n_pts = mesh.n_points
    n_tet = len(mesh.tetrahedra)
    n_tri = len(mesh.triangles)
    n_p2 = n_pts + len(mesh.lines) if len(mesh.lines) else -1

    n_herm = 4 * n_pts + len(mesh.triangles) + len(mesh.int_triangles) \
        if len(mesh.int_triangles) else -1

    const_d, lin_d, quad_d, tri_d = {}, {}, {}, {}
    for k, v in data.items():
        n = len(np.asarray(v))
        if n == n_pts:
            lin_d[k] = v
        elif n == n_tet:
            const_d[k] = v
        elif n == n_p2:
            quad_d[k] = v
        elif n == n_tri:
            tri_d[k] = v
        elif n == n_herm:
            # Hermite solution: write the vertex value DOFs as point data
            lin_d[k] = np.asarray(v)[:n_pts]
        else:
            raise ValueError(
                f"data {k!r} length {n} matches neither points ({n_pts}), "
                f"tets ({n_tet}), P2 DOFs ({n_p2}) nor triangles ({n_tri})")

    written = []
    if const_d:
        p = filename + "_const.vtu"
        _write_vtu(p, mesh.points, mesh.tetrahedra, VTK_TETRA,
                   {}, const_d, fmt)
        written.append(p)
    if lin_d:
        p = filename + "_lin.vtu"
        _write_vtu(p, mesh.points, mesh.tetrahedra, VTK_TETRA,
                   lin_d, {}, fmt)
        written.append(p)
    if quad_d:
        from ..fem.assembly import aggregate_elements
        _, tet_dofs, dim = aggregate_elements(mesh, "quad")
        conn = np.concatenate(
            [tet_dofs[:, :4],
             tet_dofs[:, 4:][:, _P2_EDGE_PERM]], axis=1)
        mids = 0.5 * (mesh.points[:, mesh.lines[:, 0]]
                      + mesh.points[:, mesh.lines[:, 1]])
        pts = np.concatenate([mesh.points, mids], axis=1)
        p = filename + "_quad.vtu"
        _write_vtu(p, pts, conn, VTK_QUADRATIC_TETRA, quad_d, {}, fmt)
        written.append(p)
    if tri_d:
        written.append(vtk_write_tri(filename, mesh, tri_d, fmt))
    return written


def vtk_write_tri(filename: str, mesh: Mesh, data: Dict[str, np.ndarray],
                  fmt: str = "ascii") -> str:
    """Write per-surface-triangle cell data to ``<filename>_tri.vtu``
    (vtk_write_tri, vtk_write.jl:201-270).  Use this instead of the
    length dispatcher when cell counts collide (e.g. #tris == #tets)."""
    data = _split_complex(data)
    path = filename if filename.endswith(".vtu") else filename + "_tri.vtu"
    _write_vtu(path, mesh.points, mesh.triangles, VTK_TRIANGLE,
               {}, data, fmt)
    return path


__all__ = ["vtk_write", "vtk_write_tri"]
