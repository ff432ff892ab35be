"""The port's mesh refinement (mesh/refine, Mesh.from_raw, collect_lines,
edge_indices) and the passive large-operator family against the JAX
package, array for array, on small generated meshes."""
import numpy as np
import pytest

from wavesandeigenvalues_jl_tpu.mesh.generate import box_mesh as box_mesh_jax
from wavesandeigenvalues_jl_tpu.mesh.generate import \
    rijke_mesh as rijke_mesh_jax
from wavesandeigenvalues_jl_tpu.mesh.refine import \
    compose_prolongations as compose_jax
from wavesandeigenvalues_jl_tpu.mesh.refine import octosplit as octosplit_jax
from wavesandeigenvalues_jl_tpu.mesh.refine import \
    p1_prolongation as p1_prolongation_jax
from wavesandeigenvalues_jl_tpu.models import discretize as discretize_jax
from wavesandeigenvalues_jl_tpu_torch.mesh import (box_mesh,
                                                   compose_prolongations,
                                                   octosplit, p1_prolongation,
                                                   rijke_mesh)
from wavesandeigenvalues_jl_tpu_torch.models.rijke import (
    large_operator_family, passive_rijke_setup)

from port_threads import one_thread  # noqa: F401

OMEGA = 2 * np.pi * 300.0
RIJKE = dict(n_rings=2, nz_cold=10, nz_hot=10)
BOX = dict(lx=1.0, ly=0.7, lz=0.4, nx=3, ny=2, nz=2)
MESHES = {"rijke": (rijke_mesh, rijke_mesh_jax, RIJKE),
          "box": (box_mesh, box_mesh_jax, BOX)}


def _assert_same_mesh(m, mj):
    for name in ("points", "lines", "triangles", "tetrahedra"):
        np.testing.assert_array_equal(getattr(m, name), getattr(mj, name),
                                      err_msg=name)
    assert list(m.domains) == list(mj.domains)
    for dom, dd in mj.domains.items():
        assert m.domains[dom]["dimension"] == dd["dimension"]
        np.testing.assert_array_equal(m.domains[dom]["simplices"],
                                      dd["simplices"], err_msg=dom)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_octosplit_equals_jax(kind):
    """Same points, lines, triangles, tetrahedra and domain simplices in
    the same order: any difference would permute the refined operator."""
    make, make_jax, kw = MESHES[kind]
    m, mj = make(**kw), make_jax(**kw)
    np.testing.assert_array_equal(m.collect_lines(), mj.collect_lines())
    fine, fine_jax = octosplit(m), octosplit_jax(mj)
    _assert_same_mesh(fine, fine_jax)
    assert fine.name == fine_jax.name
    assert fine.n_points == m.n_points + len(m.lines)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_edge_indices_equals_jax(kind):
    make, make_jax, kw = MESHES[kind]
    m, mj = make(**kw), make_jax(**kw)
    t = m.tetrahedra
    edges = np.concatenate([t[:, [1, 0]], t[:, [3, 2]]])
    np.testing.assert_array_equal(m.edge_indices(edges),
                                  mj.edge_indices(edges))
    with pytest.raises(KeyError):
        m.edge_indices(np.array([[0, 0]]))


def test_prolongations_equal_jax():
    coarse, coarse_jax = rijke_mesh(**RIJKE), rijke_mesh_jax(**RIJKE)
    P1, P1j = p1_prolongation(coarse), p1_prolongation_jax(coarse_jax)
    fine, fine_jax = octosplit(coarse), octosplit_jax(coarse_jax)
    P2, P2j = p1_prolongation(fine), p1_prolongation_jax(fine_jax)
    for P, Pj in ((P1, P1j), (P2, P2j), (compose_prolongations(P2, P1),
                                         compose_jax(P2j, P1j))):
        for a, b in zip(P[:3], Pj[:3]):
            np.testing.assert_array_equal(a, b)
        assert tuple(P[3]) == tuple(Pj[3])
    # P2·P1 interpolates a linear field exactly onto the finest points
    rows, cols, vals, shape = compose_prolongations(P2, P1)
    f = octosplit(fine).points[2]
    y = np.zeros(shape[0])
    np.add.at(y, rows, vals * coarse.points[2][cols])
    np.testing.assert_allclose(y, f, atol=1e-15)


def test_passive_family_equals_jax():
    """The passive family on the octosplit mesh at ω = 2π·300: the same
    union pattern and data within 1e-12 relative (per-point c, as
    ``bench.py:551-556``)."""
    fine = octosplit(rijke_mesh(**RIJKE))
    fine_jax = octosplit_jax(rijke_mesh_jax(**RIJKE))
    dscrp, c = passive_rijke_setup(fine)
    assert c.shape == (fine.n_points,)
    gamma, R, Tu, Tb = 1.4, 287.05, 300.0, 1200.0
    c_jax = fine_jax.generate_field(
        lambda x, y, z: np.where(z < 0, np.sqrt(gamma * R * Tu),
                                 np.sqrt(gamma * R * Tb)))
    np.testing.assert_array_equal(c, c_jax)
    Lj = discretize_jax(fine_jax, {"Interior": ("interior", ()),
                                   "Outlet": ("admittance", ("Y", 1e15))},
                        c_jax)
    L = large_operator_family(**RIJKE)
    assert L.size == Lj.size == fine.n_points
    for fam in (L, Lj):
        fam.params[fam.eigval] = OMEGA
    A, Aj = L.assemble({}), Lj.assemble({})
    np.testing.assert_array_equal(A.indptr, Aj.indptr)
    np.testing.assert_array_equal(A.indices, Aj.indices)
    rel = np.abs(A.data - Aj.data).max() / np.abs(Aj.data).max()
    assert rel <= 1e-12


def test_refine_counts_passes():
    """refine=0 is the passive family on the unrefined mesh."""
    L0 = large_operator_family(**RIJKE, refine=0)
    assert L0.size == rijke_mesh(**RIJKE).n_points
    assert large_operator_family(**RIJKE).size == \
        octosplit(rijke_mesh(**RIJKE)).n_points
