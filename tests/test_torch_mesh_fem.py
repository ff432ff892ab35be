"""The port's host model slice (mesh → FEM → operator family) against the
JAX package, on the small active Rijke tube (n = 437)."""
import importlib

import numpy as np
import pytest

from wavesandeigenvalues_jl_tpu_torch.models.rijke import active_rijke_setup

from port_threads import one_thread  # noqa: F401

PKGS = ("wavesandeigenvalues_jl_tpu", "wavesandeigenvalues_jl_tpu_torch")


def _active_family(pkg):
    """The active Rijke family (n = 437) built by the package ``pkg``
    alone, from the port's description of the flagship problem."""
    rijke_mesh = importlib.import_module(f"{pkg}.mesh.generate").rijke_mesh
    discretize = importlib.import_module(f"{pkg}.models.helmholtz").discretize
    mesh = rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
    return discretize(mesh, *active_rijke_setup(mesh))


@pytest.fixture(scope="module")
def families():
    return {p: _active_family(p) for p in PKGS}


def test_rijke_mesh_identical():
    mj, mt = (importlib.import_module(f"{p}.mesh.generate").rijke_mesh(
        n_rings=2, nz_cold=10, nz_hot=10) for p in PKGS)
    for attr in ("points", "tetrahedra", "triangles", "int_triangles"):
        np.testing.assert_array_equal(getattr(mj, attr), getattr(mt, attr))
    assert mj.domains.keys() == mt.domains.keys()
    for k in mj.domains:
        assert mj.domains[k]["dimension"] == mt.domains[k]["dimension"]
        np.testing.assert_array_equal(mj.domains[k]["simplices"],
                                      mt.domains[k]["simplices"])


def test_family_terms_and_union_pattern(families):
    Lj, Lt = families[PKGS[0]], families[PKGS[1]]
    assert Lt.size == Lj.size == 437
    assert [t.symbol for t in Lt.terms] == [t.symbol for t in Lj.terms]
    assert [t.operator for t in Lt.terms] == [t.operator for t in Lj.terms]
    assert Lt.params == Lj.params
    Sj, St = Lj._stack(), Lt._stack()
    np.testing.assert_array_equal(St.indptr, Sj.indptr)
    np.testing.assert_array_equal(St.indices, Sj.indices)
    # the same float64 numpy operations: agreement to 1e-14 per term
    Vj, Vt = np.asarray(Sj.values), np.asarray(St.values)
    assert Vt.shape == Vj.shape == (5, Sj.nnz)
    for k in range(Vj.shape[0]):
        scale = np.abs(Vj[k]).max()
        assert np.abs(Vt[k] - Vj[k]).max() <= 1e-14 * scale, k


@pytest.mark.parametrize("z", [340 * 2 * np.pi,
                               1074.9 + 373.2j,
                               -250.0 + 1800.0j])
@pytest.mark.parametrize("deriv", [0, 1])
def test_family_apply_matches(families, z, deriv):
    """L(z)·x and ∂_ω L(z)·x agree to 1e-13 on a seeded complex x."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(437) + 1j * rng.standard_normal(437)
    ys = []
    for p in PKGS:
        L = families[p]
        A = L(z) if deriv == 0 else L(z, deriv)
        ys.append(A @ x)
    yj, yt = ys
    assert np.linalg.norm(yt - yj) <= 1e-13 * np.linalg.norm(yj)
