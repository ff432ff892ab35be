"""The distributed layer of the port (port parallel/) against the JAX
package's on the CPU, in one process.

The port runs in a one-rank gloo world (a FileStore in a temporary
directory, 60 s timeouts) with 8 row parts on that rank, so the partition
is the JAX package's over its 8 virtual devices and every halo between
parts is real; the JAX side runs on those 8 devices (tests/conftest.py).
Twins of tests/test_parallel.py, tests/test_dist_solve.py and
tests/test_multihost.py; the exchange between ranks is
tests/test_torch_parallel_ranks.py."""
import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import init_device_mesh

from wavesandeigenvalues_jl_tpu.nlevp import gallery as gallery_jax
from wavesandeigenvalues_jl_tpu.ops.sparse import CSR as CSRJax
from wavesandeigenvalues_jl_tpu.parallel import dist_beyn as dist_beyn_jax
from wavesandeigenvalues_jl_tpu.parallel import dist_solve as dist_solve_jax
from wavesandeigenvalues_jl_tpu.parallel import dist_spmv as dist_spmv_jax
from wavesandeigenvalues_jl_tpu.parallel import partition as partition_jax
from wavesandeigenvalues_jl_tpu.parallel import scaling as scaling_jax
from wavesandeigenvalues_jl_tpu_torch.nlevp import gallery
from wavesandeigenvalues_jl_tpu_torch.ops.gmres import gmres_impl
from wavesandeigenvalues_jl_tpu_torch.ops.sparse import CSR
from wavesandeigenvalues_jl_tpu_torch.parallel import (dist_beyn, dist_solve,
                                                       dist_spmv, multihost,
                                                       partition, scaling)

from port_threads import one_thread  # noqa: F401

#: the twins' bars: the JAX tests' own (tests/test_dist_solve.py) for
#: solutions and modes, 1e-12 between the two packages' products
SOLVE_RTOL, MODE_ATOL, PRODUCT_ATOL = 1e-8, 1e-7, 1e-12


def test_init_multihost_noop_without_config(monkeypatch):
    """Twin of tests/test_multihost.py:13 (first, before the module's
    world exists): without arguments and without torchrun's environment,
    nothing is initialised."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert multihost.init_multihost() is False
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("world") / "store"),
                           1)
    dist.init_process_group("gloo", store=store, world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def row_mesh(world):
    return init_device_mesh("cpu", (1,), mesh_dim_names=("row",))


@pytest.fixture(scope="module")
def grid_mesh(world):
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("shift", "row"))


@pytest.fixture(scope="module")
def jax_row():
    return Mesh(np.array(jax.devices()), ("row",))


def banded_matrix(n=257, seed=0, band=9):
    """tests/test_parallel.py:17."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n), complex)
    for k in range(-band // 2, band // 2 + 1):
        d = (rng.standard_normal(n - abs(k))
             + 1j * rng.standard_normal(n - abs(k)))
        A += np.diag(d, k)
    return A


def unstructured_matrix():
    """tests/test_parallel.py:45: a random pattern whose halo is wider
    than a part (several hops)."""
    rng = np.random.default_rng(3)
    n = 190
    A = np.zeros((n, n), complex)
    for i in range(n):
        for j in rng.choice(n, 4):
            A[i, j] = rng.standard_normal() + 1j * rng.standard_normal()
        A[i, i] += 1.0
    return A, rng


def both_csr(A):
    Aj = CSRJax.from_dense(A)
    return Aj, CSR(Aj.indptr, Aj.indices, Aj.data, Aj.shape)


@pytest.fixture(scope="module")
def rijke1d():
    """tests/test_dist_solve.py:19 in both packages."""
    L, _ = gallery.rijke_tube(96)
    Lj, _ = gallery_jax.rijke_tube(96)
    Sj, St = Lj._stack(), L._stack()
    np.testing.assert_array_equal(St.values, Sj.values)
    return L, Lj


def _equal_parts(pt, pj):
    for key in ("cols", "values", "row_mask", "perm"):
        np.testing.assert_array_equal(getattr(pt, key), getattr(pj, key))
    assert (pt.m, pt.halo, pt.n, pt.n_parts) == (pj.m, pj.halo, pj.n,
                                                 pj.n_parts)


@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("kind", ["rows", "stack"])
def test_partition_equals_jax(kind, P, reorder, rijke1d):
    """partition_rows (the banded matrix of tests/test_parallel.py) and
    partition_stack (the 1-D Rijke family) array for array equal to the
    JAX package's."""
    if kind == "rows":
        Aj, At = both_csr(banded_matrix(257))
        pj = partition_jax.partition_rows(Aj, P, reorder=reorder)
        pt = partition.partition_rows(At, P, reorder=reorder)
    else:
        L, Lj = rijke1d
        pj = partition_jax.partition_stack(Lj._stack(), P, reorder=reorder)
        pt = partition.partition_stack(L._stack(), P, reorder=reorder)
    _equal_parts(pt, pj)


@pytest.mark.parametrize("m,halo,r", [(10, 3, None), (4, 9, None),
                                      (6, 0, None), (5, 7, 3)])
def test_halo_exchange_windows(m, halo, r, row_mesh, jax_row):
    """halo_exchange's windows equal the JAX package's ppermute windows
    over 8 parts, one hop, several hops (H = 9 > m = 4), none, and with a
    trailing panel axis."""
    rng = np.random.default_rng(m + halo)
    shape = (8 * m,) + (() if r is None else (r,))
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    f = shard_map(lambda v: dist_spmv_jax.halo_exchange(v, halo, "row")[None],
                  mesh=jax_row, in_specs=JP("row"), out_specs=JP("row"))
    want = np.asarray(jax.jit(f)(x))
    got = dist_spmv.halo_exchange(
        torch.from_numpy(x.reshape((8, m) + shape[1:])), halo, row_mesh)
    assert got.shape == (8, m + 2 * halo + 1) + shape[1:]
    np.testing.assert_array_equal(got.numpy(), want)


def _spmv_both(A, mesh, jmesh, x, coeffs=None, P=8, reorder=True):
    Aj, At = both_csr(A)
    pj = partition_jax.partition_rows(Aj, P, reorder=reorder)
    pt = partition.partition_rows(At, P, reorder=reorder)
    fj, shj, unj = dist_spmv_jax.make_dist_spmv(pj, jmesh)
    ft, sht, unt = dist_spmv.make_dist_spmv(pt, mesh)
    return unt(ft(sht(x))), unj(fj(shj(x)))


def test_partition_spmv_matches_dense(row_mesh, jax_row):
    """Twin of tests/test_parallel.py:31."""
    A = banded_matrix(257)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(257) + 1j * rng.standard_normal(257)
    y, yj = _spmv_both(A, row_mesh, jax_row, x)
    np.testing.assert_allclose(y, yj, rtol=0, atol=PRODUCT_ATOL)
    assert np.allclose(y, A @ x, atol=1e-12)


def test_partition_unstructured_spmv(row_mesh, jax_row):
    """Twin of tests/test_parallel.py:42: several halo hops between the
    parts of one rank."""
    A, rng = unstructured_matrix()
    x = rng.standard_normal(190) + 1j * rng.standard_normal(190)
    Aj, At = both_csr(A)
    pt = partition.partition_rows(At, 8)
    assert pt.halo > pt.m                      # more than one hop
    y, yj = _spmv_both(A, row_mesh, jax_row, x)
    np.testing.assert_allclose(y, yj, rtol=0, atol=PRODUCT_ATOL)
    assert np.allclose(y, A @ x, atol=1e-11)


def test_partition_stack_family(row_mesh, jax_row, rijke1d):
    """Twin of tests/test_parallel.py:60 (on the 96-point tube): the
    coefficient contraction + halo SpMV equals L(z) @ x."""
    L, Lj = rijke1d
    z = 1.1 + 0.4j
    L.params["ω"] = Lj.params["ω"] = z
    coeffs = L.coefficients({})
    pj = partition_jax.partition_stack(Lj._stack(), 8)
    pt = partition.partition_stack(L._stack(), 8)
    fj, shj, unj = dist_spmv_jax.make_dist_spmv(pj, jax_row)
    ft, sht, unt = dist_spmv.make_dist_spmv(pt, row_mesh)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(L.size) + 1j * rng.standard_normal(L.size)
    y, yj = unt(ft(sht(x), coeffs)), unj(fj(shj(x), coeffs))
    np.testing.assert_allclose(y, yj, rtol=0, atol=PRODUCT_ATOL * abs(
        yj).max())
    assert np.allclose(y, L(z) @ x, rtol=1e-10, atol=1e-10)


def test_dist_dot(row_mesh, jax_row):
    """Twin of tests/test_parallel.py:77."""
    from jax.sharding import NamedSharding
    n = 8 * 13
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    spec = NamedSharding(jax_row, JP("row"))
    dj = np.complex128(dist_spmv_jax.dist_dot(
        jax.device_put(x, spec), jax.device_put(y, spec), jax_row))
    d = complex(dist_spmv.dist_dot(torch.from_numpy(x.reshape(8, 13)),
                                   torch.from_numpy(y.reshape(8, 13)),
                                   row_mesh))
    assert abs(d - np.vdot(x, y)) < 1e-12 * abs(np.vdot(x, y))
    assert abs(d - dj) < 1e-12 * abs(dj)


def test_dist_spmm_panel(row_mesh, jax_row):
    """Twin of tests/test_parallel.py:180: one halo exchange moves the
    whole panel."""
    A = banded_matrix(193, seed=5, band=11)
    Aj, At = both_csr(A)
    pj = partition_jax.partition_rows(Aj, 8)
    pt = partition.partition_rows(At, 8)
    fj, shj, unj = dist_spmv_jax.make_dist_spmm(pj, jax_row)
    ft, sht, unt = dist_spmv.make_dist_spmm(pt, row_mesh)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((193, 6)) + 1j * rng.standard_normal((193, 6))
    Y, Yj = unt(ft(sht(X))), unj(fj(shj(X)))
    np.testing.assert_allclose(Y, Yj, rtol=0, atol=PRODUCT_ATOL)
    assert np.allclose(Y, A @ X, atol=1e-11)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_row_sharded_gmres_matches_serial(row_mesh, jax_row, rijke1d):
    """Twin of tests/test_dist_solve.py:25: 8 row parts, block-Jacobi."""
    L, Lj = rijke1d
    z = 1.2 + 0.4j
    L.params[L.eigval] = Lj.params[Lj.eigval] = z
    coeffs = L.coefficients({})[None]
    rng = np.random.default_rng(0)
    d = L.size
    B = rng.standard_normal((1, 2, d)) + 1j * rng.standard_normal((1, 2, d))
    X, res = dist_solve.make_dist_gmres(
        partition.partition_stack(L._stack(), 8), row_mesh, bs=8,
        tol=1e-12)(coeffs, B)
    Xj, resj = dist_solve_jax.make_dist_gmres(
        partition_jax.partition_stack(Lj._stack(), 8), jax_row, bs=8,
        tol=1e-12)(coeffs, B)
    A = L(z).to_dense()
    assert res.shape == (1, 2) and res.max() <= 1e-12
    for j in range(2):
        assert _rel(X[0, j], np.linalg.solve(A, B[0, j])) < SOLVE_RTOL
        assert _rel(X[0, j], Xj[0, j]) < SOLVE_RTOL


def test_shift_by_row_mesh_beyn_node_solve(grid_mesh, rijke1d):
    """Twin of tests/test_dist_solve.py:46: 2 shifts and 4 row parts (on
    the one rank here, on a 2 × 4 mesh in the JAX package), an l = 3
    probe panel."""
    from wavesandeigenvalues_jl_tpu.ops.linsolve import factorize
    L, Lj = rijke1d
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("shift", "row"))
    d, l = L.size, 3
    V = np.zeros((d, l), np.complex128)
    V[:l, :l] = np.eye(l)
    zs = np.array([0.9 + 0.3j, 1.7 - 0.2j])
    X, res = dist_solve.dist_beyn_node_solve(L, zs, V, grid_mesh,
                                             n_row_parts=4, bs=8, tol=1e-12)
    Xj, _ = dist_solve_jax.dist_beyn_node_solve(Lj, zs, V, jmesh,
                                                n_row_parts=4, bs=8,
                                                tol=1e-12)
    assert X.shape == (2, d, l) and res.shape == (2, l)
    for s, z in enumerate(zs):
        Xd = factorize(Lj(complex(z))).solve(V)
        assert _rel(X[s], Xd) < SOLVE_RTOL
        assert _rel(X[s], Xj[s]) < SOLVE_RTOL


def test_fully_distributed_beyn(grid_mesh, rijke1d):
    """Twin of tests/test_dist_solve.py:65: every quadrature solve
    row-sharded; the modes equal the JAX package's beyn_dist and its
    serial host Beyn to 1e-7."""
    from wavesandeigenvalues_jl_tpu.nlevp.solvers import beyn
    L, Lj = rijke1d
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("shift", "row"))
    Gamma = [0.5 - 0.5j, 2.5 - 0.5j, 2.5 + 1.0j, 0.5 + 1.0j]
    Om_h, _ = beyn(Lj, Gamma, l=5, N=16, rtol=1e-12)
    Om_j, _ = dist_beyn_jax.beyn_dist(Lj, Gamma, jmesh, n_row_parts=4, l=5,
                                      N=16, rtol=1e-12, bs=8, tol=1e-12)
    Om, P, info = dist_beyn.beyn_dist(L, Gamma, grid_mesh, n_row_parts=4,
                                      l=5, N=16, rtol=1e-12, bs=8, tol=1e-12,
                                      return_info=True)
    assert len(Om) == len(Om_h) == len(Om_j) > 0
    for ref in (Om_h, Om_j):
        assert np.max(np.abs(np.sort_complex(Om) - np.sort_complex(ref))) \
            < MODE_ATOL
    assert info["solves"] == 64 and info["max_res"] <= 1e-12


def _fem_families(levels, nz):
    """The two packages' passive Rijke families on one octosplit chain
    (tests/test_dist_solve.py:97-106), coarse first, and the JAX
    package's prolongations between them."""
    from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh as rmj
    from wavesandeigenvalues_jl_tpu.mesh.refine import (octosplit as osj,
                                                        p1_prolongation)
    from wavesandeigenvalues_jl_tpu.models import discretize as discj
    from wavesandeigenvalues_jl_tpu_torch.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu_torch.mesh.refine import octosplit
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    ds = {"Interior": ("interior", ()),
          "Outlet": ("admittance", ("Y", 1e15))}
    fld = lambda m: m.generate_field(                    # noqa: E731
        lambda x, y, z: np.where(z < 0, 347.0, 694.0))
    out = []
    for rm, osp, disc in ((rijke_mesh, octosplit, discretize),
                          (rmj, osj, discj)):
        meshes = [rm(n_rings=2, nz_cold=nz, nz_hot=nz)]
        for _ in range(levels):
            meshes.append(osp(meshes[-1]))
        out.append([disc(m, ds, fld(m)) for m in meshes])
    return out[0], out[1], [p1_prolongation(m) for m in meshes[:-1]]


@pytest.mark.parametrize("kind", ["two_grid", "multigrid"])
def test_dist_coarse_gmres(kind, row_mesh, jax_row):
    """Twins of tests/test_dist_solve.py:85 (CoarseGrid two-grid) and :123
    (MultiGrid V-cycle over two octosplits): the coarse correction inside
    the row-sharded GMRES over 8 parts, against the JAX package's and a
    serial sparse solve."""
    from wavesandeigenvalues_jl_tpu.ops import panel_solve as psj
    from wavesandeigenvalues_jl_tpu.ops.linsolve import factorize
    from wavesandeigenvalues_jl_tpu_torch.ops import panel_solve as pst
    levels, nz, seed = (1, 6, 7) if kind == "two_grid" else (2, 5, 3)
    fams, fams_j, Ps = _fem_families(levels, nz)
    if kind == "two_grid":
        coarse = pst.CoarseGrid(fams[0], Ps[0])
        coarse_j = psj.CoarseGrid(fams_j[0], Ps[0])
    else:
        coarse = pst.MultiGrid(fams[-2::-1], Ps[::-1], bs=16)
        coarse_j = psj.MultiGrid(fams_j[-2::-1], Ps[::-1], bs=16)
    Lf, Lfj = fams[-1], fams_j[-1]
    kw = dict(bs=16, tol=1e-11, restart=25, max_restarts=8)
    solve = dist_solve.make_dist_gmres(
        partition.partition_stack(Lf._stack(), 8), row_mesh, coarse=coarse,
        **kw)
    solve_j = dist_solve_jax.make_dist_gmres(
        partition_jax.partition_stack(Lfj._stack(), 8), jax_row,
        coarse=coarse_j, **kw)
    z = 2 * np.pi * (300 + 5j)
    Lf.params[Lf.eigval] = Lfj.params[Lfj.eigval] = z
    coeffs = Lf.coefficients({})[None]
    rng = np.random.default_rng(seed)
    d = Lf.size
    B = rng.standard_normal((1, 2, d)) + 1j * rng.standard_normal((1, 2, d))
    X, res = solve(coeffs, B)
    Xj, _ = solve_j(coeffs, B)
    A = factorize(Lfj(z))
    for j in range(2):
        assert _rel(X[0, j], A.solve(B[0, j])) < SOLVE_RTOL
        assert _rel(X[0, j], Xj[0, j]) < SOLVE_RTOL


def test_dist_gmres_coarse_type_error(row_mesh):
    """Twin of tests/test_dist_solve.py:165; and a mesh that is not a
    DeviceMesh, or lacks the axis named, is refused."""
    L, _ = gallery.rijke_tube(48)
    part = partition.partition_stack(L._stack(), 2)
    with pytest.raises(TypeError, match="CoarseGrid or MultiGrid"):
        dist_solve.make_dist_gmres(part, row_mesh, coarse=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        dist_solve.make_dist_gmres(part, object())
    with pytest.raises(ValueError, match="no axis 'shift'"):
        dist_solve.make_dist_gmres(part, row_mesh, row_axis="shift")


def test_batched_moments_mesh_matches_jax(world):
    """Twin of tests/test_parallel.py:101 on a shift mesh: the moments
    equal the host quadrature and the JAX package's batched moments."""
    from wavesandeigenvalues_jl_tpu.nlevp.solvers import \
        compute_moment_matrices
    Tj = gallery_jax.qep3()
    T = gallery.qep3()
    Gamma = [-2 - 2j, 2 - 2j, 2 + 2j, -2 + 2j]
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("shift",))
    A = dist_beyn.batched_moments(T, Gamma, l=3, K=1, N=16, mesh=mesh,
                                  device="cpu")
    A_host = compute_moment_matrices(Tj, Gamma, l=3, K=1, N=16)
    A_jax = dist_beyn_jax.batched_moments(Tj, Gamma, l=3, K=1, N=16,
                                          dtype=np.complex128)
    assert np.allclose(A, A_host, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(A, A_jax, rtol=1e-12, atol=1e-12)


def test_beyn_batched_sharded(world):
    """Twin of tests/test_parallel.py:113: shift-sharded Beyn on the QEP
    finds the five eigenvalues, each the JAX package's (over its 8-device
    shift mesh) to 1e-10; with dense=False a mesh is refused."""
    T = gallery.qep3()
    Gamma = [-2 - 2j, 2 - 2j, 2 + 2j, -2 + 2j]
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("shift",))
    Om, P = dist_beyn.beyn_batched(T, Gamma, l=6, N=32, mesh=mesh,
                                   device="cpu")
    Om_j, _ = dist_beyn_jax.beyn_batched(
        gallery_jax.qep3(), Gamma, l=6, N=32, dtype=np.complex128,
        mesh=Mesh(np.array(jax.devices()), ("shift",)))
    for target in (1 / 3, 0.5, 1.0, 1j, -1j):
        assert np.min(np.abs(Om - target)) < 1e-8, target
        # the sixth candidate is round-off in both packages
        near, near_j = (O[np.argmin(np.abs(O - target))] for O in (Om, Om_j))
        assert abs(near - near_j) < 1e-10, target
    with pytest.raises(ValueError, match="beyn_dist"):
        dist_beyn.beyn_batched(T, Gamma, mesh=mesh, dense=False,
                               device="cpu")


def test_gmres_reduce_fn_none_is_bitwise():
    """gmres_impl(reduce_fn=None) is the call without it, bit for bit;
    an identity reduce_fn (the summed-norm path) agrees to round-off."""
    rng = np.random.default_rng(4)
    n, k = 60, 3
    A = torch.from_numpy(np.eye(n) * 4 + rng.standard_normal((n, n)) * 0.3
                         + 1j * rng.standard_normal((n, n)) * 0.3)
    b = torch.from_numpy(rng.standard_normal((k, n))
                         + 1j * rng.standard_normal((k, n)))
    mv = lambda x: x @ A.T                              # noqa: E731
    kw = dict(tol=1e-12, restart=15, max_restarts=10)
    x0, r0, i0 = gmres_impl(mv, b, **kw)
    x1, r1, i1 = gmres_impl(mv, b, reduce_fn=None, **kw)
    assert torch.equal(x0, x1) and torch.equal(r0, r1) and torch.equal(i0, i1)
    x2, r2, _ = gmres_impl(mv, b, reduce_fn=lambda t: t, **kw)
    assert float((x2 - x0).abs().max()) < 1e-10 and float(r2.max()) < 1e-12


def test_gmres_comm_accounting_equals_jax():
    for args in ((57210, 4, 310, 8, 80, 1), (4096, 1, 15, 2, 20, 2),
                 (1000, 8, 300, 3, 10, 4)):
        assert scaling.gmres_comm_accounting(*args) == \
            scaling_jax.gmres_comm_accounting(*args)


def test_weak_scaling_harness(row_mesh):
    """Twin of tests/test_parallel.py:136 (8 parts on one rank); every
    record names its part count and its ranks."""
    recs = scaling.spmv_scaling_report(device_counts=(1, 2, 4, 8),
                                       rows_per_device=512, reps=5,
                                       mesh=row_mesh)
    assert [r["n_devices"] for r in recs] == [1, 2, 4, 8]
    for r in recs:
        assert r["rows"] == 512 * r["n_devices"] and r["n_ranks"] == 1
        assert r["nnz_per_s"] > 0 and 0 < r["efficiency_vs_1"]
        assert r["baseline_n_devices"] == 1
    assert recs[0]["efficiency_vs_1"] == 1.0
    recs2 = scaling.spmv_scaling_report(device_counts=(2, 4),
                                        rows_per_device=512, reps=2,
                                        verify=False, mesh=row_mesh)
    assert "efficiency_vs_1" not in recs2[0]
    assert recs2[0]["baseline_n_devices"] == 2
    assert recs2[0]["efficiency_vs_smallest"] == 1.0


def test_dist_gmres_scaling_report(row_mesh):
    """Twin of tests/test_parallel.py:161."""
    recs = scaling.dist_gmres_scaling_report(
        device_counts=(1, 4), rows_per_device=256, restart=5,
        max_restarts=1, bs=16, mesh=row_mesh)
    assert [r["n_devices"] for r in recs] == [1, 4]
    for r in recs:
        assert r["rows"] == 256 * r["n_devices"] and r["n_ranks"] == 1
        assert r["matvec_nnz_per_s"] > 0 and r["baseline_n_devices"] == 1
    assert recs[0]["efficiency_vs_1"] == 1.0
    rep = scaling.dist_gmres_comm_report(rows_per_device=256, restart=5,
                                         max_restarts=1, bs=16,
                                         mesh=row_mesh)
    assert rep["t_compute_per_iter_s"] > 0 and "modeled" not in rep
    assert rep["accounting"] == scaling_jax.gmres_comm_accounting(
        256, 1, 15, 2, 5, 1)


def test_dist_gmres_strong_report_shape(row_mesh):
    """Twin of tests/test_parallel.py:195."""
    A = scaling._banded_operator(2048, band=15)
    np.testing.assert_array_equal(
        A.data, scaling_jax._banded_operator(2048, band=15).data)
    rep = scaling.dist_gmres_strong_report(A, device_counts=(1, 4), l=1,
                                           restart=8, max_restarts=1, bs=16,
                                           mesh=row_mesh)
    recs = rep["records"]
    assert [r["n_devices"] for r in recs] == [1, 4]
    for r in recs:
        assert 0.0 < r["strong_efficiency"] <= 1.0
        assert r["t_iter_measured_s"] > 0
    assert rep["halo_rows"] == 7


def test_pod_mesh_axes(world):
    """Twin of tests/test_multihost.py:19 on the one-rank world: the axes
    and the "per-host" refusal (a [2, 4] grid of ranks, as the JAX test's
    device grid)."""
    mesh = multihost.pod_mesh()
    assert mesh.mesh_dim_names == ("host", "shift", "row")
    assert tuple(mesh.shape) == (1, 1, 1)
    with pytest.raises(ValueError, match="per-host"):
        multihost.pod_mesh(n_shift=3, n_row=2,
                           ranks=np.arange(8).reshape(2, 4))
    with pytest.raises(ValueError, match="per-host"):
        multihost.pod_mesh(n_shift=2, n_row=1)
