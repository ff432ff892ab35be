"""The port's mesh I/O (mesh/io, mesh/vtk and the domain operations of
mesh/core) against the JAX package on the CPU: the readers on the
synthesized fixtures of tests/test_mesh_readers.py and
tests/test_mesh_tools.py, gmsh files of a generated Rijke tube written by
``chip_smoke.py``'s writers, the VTU files byte for byte in every format,
and unify/keep/color_domains/the surface normals array for array."""
import importlib
import os

import numpy as np
import pytest

import chip_smoke
from wavesandeigenvalues_jl_tpu_torch.mesh import (Mesh, color_domains,
                                                   read_ansys, vtk_write,
                                                   vtk_write_tri)
from wavesandeigenvalues_jl_tpu_torch.mesh.generate import (box_mesh,
                                                            rijke_mesh)

from port_threads import one_thread  # noqa: F401

PKGS = ("wavesandeigenvalues_jl_tpu", "wavesandeigenvalues_jl_tpu_torch")
MESH_ATTRS = ("points", "lines", "triangles", "tetrahedra")


def _fixture(name):
    """A reader fixture of the JAX package's tests, by name."""
    if name == "NAS":
        return importlib.import_module("test_mesh_readers")._nas_fixture()
    if name == "FLUENT_TET":
        return importlib.import_module("test_mesh_tools").FLUENT_TET
    return getattr(importlib.import_module("test_mesh_readers"), name)


def _assert_same_mesh(a, b):
    for attr in MESH_ATTRS:
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    assert a.domains.keys() == b.domains.keys()
    for k in a.domains:
        assert a.domains[k]["dimension"] == b.domains[k]["dimension"]
        np.testing.assert_array_equal(a.domains[k]["simplices"],
                                      b.domains[k]["simplices"])


def _read_both(path, **kw):
    return [importlib.import_module(f"{p}.mesh").read_mesh(str(path), **kw)
            for p in PKGS]


@pytest.mark.parametrize("name,fixture", [("t.msh2.msh", "MSH2"),
                                          ("t.msh4.msh", "MSH4"),
                                          ("t.nas", "NAS")])
def test_readers_twin(tmp_path, name, fixture):
    """The unit-tet fixtures of tests/test_mesh_readers.py: the port's
    mesh equals the JAX package's array for array, and passes that
    file's checks."""
    p = tmp_path / name
    p.write_text(_fixture(fixture))
    mesh_jax, mesh = _read_both(p)
    _assert_same_mesh(mesh, mesh_jax)
    importlib.import_module("test_mesh_readers")._check(mesh)


def test_reader_scale_twin(tmp_path):
    p = tmp_path / "scaled.msh"
    p.write_text(_fixture("MSH2"))
    mesh_jax, mesh = _read_both(p, scale=1e-3)
    _assert_same_mesh(mesh, mesh_jax)
    assert abs(mesh.tet_volumes()[0] - 1e-9 / 6) < 1e-22


def test_read_ansys_twin(tmp_path):
    """The fluent fixture of tests/test_mesh_tools.py:154-177."""
    from wavesandeigenvalues_jl_tpu.mesh import read_ansys as read_ansys_jax
    p = tmp_path / "one.cas"
    p.write_text(_fixture("FLUENT_TET"))
    raw, raw_jax = read_ansys(str(p)), read_ansys_jax(str(p))
    for a, b in zip(raw[:4], raw_jax[:4]):
        np.testing.assert_array_equal(a, b)
    assert raw[4].keys() == raw_jax[4].keys() == {"volume", "walls"}
    for k in raw[4]:
        np.testing.assert_array_equal(raw[4][k]["simplices"],
                                      raw_jax[4][k]["simplices"])
    m = Mesh.from_raw(*raw)
    assert (m.n_points, len(m.tetrahedra), len(m.triangles)) == (4, 1, 4)
    assert np.isclose(m.compute_size("volume"), 1 / 6)


@pytest.mark.parametrize("version", ["4.1", "2.2"])
def test_gmsh_rijke_round_trip(tmp_path, version):
    """A generated Rijke tube (n = 437) written as gmsh by chip_smoke.py's
    writer (path J1 does the same at 7,259 DOF): both packages read it
    back as the generated mesh in Mesh.from_raw's canonical order,
    overlapping domains included."""
    m = rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
    path = tmp_path / "rijke.msh"
    writer = {"4.1": chip_smoke.write_gmsh41,
              "2.2": chip_smoke.write_gmsh22}[version]
    writer(str(path), m)
    assert open(path).readlines()[1].split()[0] == version
    ref = Mesh.from_raw(m.points, m.lines, m.triangles, m.tetrahedra,
                        m.domains)
    mesh_jax, mesh = _read_both(path)
    _assert_same_mesh(mesh, ref)
    _assert_same_mesh(mesh_jax, ref)
    assert len(mesh.domains["Interior"]["simplices"]) == len(m.tetrahedra)


def _vtk_case():
    """box_mesh(2, 2, 3): all four data lengths distinct (the dispatch
    case of tests/test_mesh_tools.py:87), complex P2 data included."""
    pkg_meshes = []
    for p in PKGS:
        m = importlib.import_module(f"{p}.mesh.generate").box_mesh(
            nx=2, ny=2, nz=3)
        m.collect_lines()
        pkg_meshes.append(m)
    m = pkg_meshes[1]
    data = {"a": np.arange(m.n_points, dtype=float) * np.pi,
            "b": np.arange(len(m.tetrahedra), dtype=np.int64),
            "c": np.arange(m.n_points + len(m.lines)) * (1.0 + 2.0j) / 3,
            "d": np.linspace(0, 1, len(m.triangles))}
    return pkg_meshes, data


@pytest.mark.parametrize("fmt", ["ascii", "binary", "compressed"])
def test_vtk_files_byte_equal(tmp_path, fmt):
    """vtk_write (all four files) and vtk_write_tri write the JAX
    package's bytes in every format."""
    (mesh_jax, mesh), data = _vtk_case()
    outs = []
    for p, m in zip(PKGS, (mesh_jax, mesh)):
        vtk = importlib.import_module(f"{p}.mesh.vtk")
        d = tmp_path / p
        d.mkdir()
        files = vtk.vtk_write(str(d / "out"), m, data, fmt=fmt)
        files.append(vtk.vtk_write_tri(str(d / "surf"), m,
                                       {"id": data["d"] + 1j}, fmt))
        outs.append(files)
    assert [os.path.basename(f) for f in outs[1]] == [
        "out_const.vtu", "out_lin.vtu", "out_quad.vtu", "out_tri.vtu",
        "surf_tri.vtu"]
    for fj, ft in zip(*outs):
        assert open(fj, "rb").read() == open(ft, "rb").read(), ft


def test_vtk_bad_length_and_tri_collision(tmp_path):
    """A length matching no mesh entity raises; where #tris == #tets the
    explicit surface writer takes the field (tests/test_domain_ops.py)."""
    with pytest.raises(ValueError):
        vtk_write(str(tmp_path / "x"), box_mesh(nx=1, ny=1, nz=1),
                  {"a": np.zeros(3)})
    mesh = box_mesh(nx=2, ny=2, nz=2)
    assert len(mesh.triangles) == len(mesh.tetrahedra)
    p = vtk_write_tri(str(tmp_path / "surf"), mesh,
                      {"id": np.arange(len(mesh.triangles), dtype=float)})
    txt = open(p).read()
    assert "UnstructuredGrid" in txt and 'Name="id"' in txt


def test_unify_and_keep_twin():
    """tests/test_domain_ops.py:10 in both packages, domain for domain."""
    meshes = []
    for p in PKGS:
        mesh = importlib.import_module(f"{p}.mesh.generate").box_mesh(
            nx=2, ny=2, nz=3)
        n_ends = sum(len(mesh.domains[d]["simplices"])
                     for d in ("Zmin", "Zmax"))
        mesh.unify("Ends", "Zmin", "Zmax")
        assert mesh.domains["Ends"]["dimension"] == 2
        assert len(mesh.domains["Ends"]["simplices"]) == n_ends
        with pytest.raises(ValueError):
            mesh.unify("Bad", "Interior", "Zmin")
        mesh.keep("Interior", "Ends")
        assert sorted(mesh.domains) == ["Ends", "Interior"]
        meshes.append(mesh)
    _assert_same_mesh(meshes[1], meshes[0])


def test_color_domains_twin():
    from wavesandeigenvalues_jl_tpu.mesh import \
        color_domains as color_domains_jax
    from wavesandeigenvalues_jl_tpu.mesh.generate import \
        box_mesh as box_mesh_jax
    data, surf, vol = color_domains(box_mesh(nx=2, ny=2, nz=3))
    data_j, surf_j, vol_j = color_domains_jax(box_mesh_jax(nx=2, ny=2,
                                                           nz=3))
    assert (surf, vol) == (surf_j, vol_j)
    assert vol == {"Interior": 1} and len(surf) == 6
    assert data.keys() == data_j.keys()
    for k in data:
        np.testing.assert_array_equal(data[k], data_j[k])
    assert np.all(data["__all_surfaces__"] > 0)


def test_surface_points_and_normals_twin():
    """get_surface_points and get_normal_vectors (area-weighted, outward)
    on the Rijke tube, all and per domain, equal the JAX package's."""
    mesh, mesh_jax = (importlib.import_module(f"{p}.mesh.generate")
                      .rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
                      for p in reversed(PKGS))
    for doms in (None, ["Outlet"], ["Inlet", "Walls"]):
        np.testing.assert_array_equal(mesh.get_surface_points(doms),
                                      mesh_jax.get_surface_points(doms))
        np.testing.assert_array_equal(mesh.get_normal_vectors(doms),
                                      mesh_jax.get_normal_vectors(doms))
    nrm = mesh.get_normal_vectors(["Outlet"])
    pts = mesh.get_surface_points(["Outlet"])
    np.testing.assert_allclose(nrm[2, pts], 1.0, rtol=0, atol=1e-12)
