"""The port's large-operator apply (ops/window_spmm: the CSR SpMM that
stands for kernels K4 and K5; ops/device ELL and device-stacked family;
operator_apply(kernel="window")) against the JAX package on the CPU, where
the wrapper runs its plain PyTorch version.  K4 (``WindowSpmm``) and K5
(``ChunkSpmm``) run in Pallas interpret mode, as
tests/test_window_spmm.py runs them."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from wavesandeigenvalues_jl_tpu.mesh.generate import \
    rijke_mesh as rijke_mesh_jax
from wavesandeigenvalues_jl_tpu.mesh.refine import octosplit as octosplit_jax
from wavesandeigenvalues_jl_tpu.models import discretize as discretize_jax
from wavesandeigenvalues_jl_tpu.ops.device import \
    DeviceStackedOperator as DeviceStackedJax
from wavesandeigenvalues_jl_tpu.ops.device import EllOperator as EllJax
from wavesandeigenvalues_jl_tpu.ops.reorder import \
    cuthill_mckee as cuthill_mckee_jax
from wavesandeigenvalues_jl_tpu.ops.reorder import \
    permute_csr as permute_csr_jax
from wavesandeigenvalues_jl_tpu.ops.sparse import CSR as CSRJax
from wavesandeigenvalues_jl_tpu.ops.sparse import \
    StackedOperator as StackedJax
from wavesandeigenvalues_jl_tpu.ops.sparse import csr_to_ell as csr_to_ell_jax
from wavesandeigenvalues_jl_tpu.ops.window_spmm import (TILE, WindowBsr,
                                                        WindowSpmm as K4)
from wavesandeigenvalues_jl_tpu.ops.window_spmm2 import ChunkBsr
from wavesandeigenvalues_jl_tpu.ops.window_spmm2 import ChunkSpmm as K5
from wavesandeigenvalues_jl_tpu_torch.models.rijke import (
    active_rijke_family, large_operator_family)
from wavesandeigenvalues_jl_tpu_torch.ops.bsr_spmm import (operator_apply,
                                                            random_panel)
from wavesandeigenvalues_jl_tpu_torch.ops.device import (
    DeviceStackedOperator, EllOperator, spmv_ell)
from wavesandeigenvalues_jl_tpu_torch.ops.sparse import (CSR,
                                                         StackedOperator,
                                                         csr_to_ell)
from wavesandeigenvalues_jl_tpu_torch.ops.reorder import (cuthill_mckee,
                                                          permute_csr)
from wavesandeigenvalues_jl_tpu_torch.ops.window_spmm import (
    CHUNK, CONSUMER_WARPS, RING_ROWS, RING_STAGES, ROWS_A_WARP, STAGE_ROWS,
    TILE_ROWS, WindowSpmm, plan, window_spmm, window_spmm_ref)
from wavesandeigenvalues_jl_tpu_torch.utils import timing

from port_threads import one_thread  # noqa: F401


def _counts(kernel):
    """(launches, plain calls) of a kernel wrapper so far."""
    return (timing.total(f"{kernel}.launches"),
            timing.total(f"{kernel}.twin_calls"))


OMEGA = 2 * np.pi * 300.0
#: the JAX tests' bar for each kernel against the host product
#: (tests/test_window_spmm.py:36,76,108)
JAX_BAR = 5e-6
#: port against the JAX kernel, per entry relative to (|A|·|X|):
#: float32 sums in another order
PORT_VS_JAX = 1e-6


def _banded(n, band, seed=0, deg=12):
    """The banded operator of tests/test_window_spmm.py:14-21."""
    rng = np.random.default_rng(seed)
    ii = np.repeat(np.arange(n), deg)
    jj = np.clip(ii + rng.integers(-band, band + 1, len(ii)), 0, n - 1)
    v = rng.standard_normal(len(ii)) + 1j * rng.standard_normal(len(ii))
    A = sp.csr_matrix((v, (ii, jj)), shape=(n, n))
    A.sum_duplicates()
    return A


def _chunk_operator():
    """The operator of tests/test_window_spmm.py:86-98 (n 2,200)."""
    rng = np.random.default_rng(1)
    n, band, nnz_row = 2200, 350, 10
    rows, cols = [], []
    for i in range(n):
        lo, hi = max(0, i - band), min(n, i + band)
        c = rng.choice(np.arange(lo, hi), size=min(nnz_row, hi - lo),
                       replace=False)
        rows += [i] * len(c)
        cols += list(c)
    vals = rng.standard_normal(len(rows)) + 1j * rng.standard_normal(len(rows))
    A = CSRJax.from_coo(np.array(rows), np.array(cols), vals, (n, n))
    return sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape), A


def _helmholtz_operator():
    """The Cuthill–McKee-ordered Helmholtz operator of
    tests/test_window_spmm.py:55-66, assembled by the JAX package."""
    mesh = rijke_mesh_jax(n_rings=2, nz_cold=12, nz_hot=12)
    c = mesh.generate_field(lambda x, y, z: 340.0 * np.ones_like(z))
    L = discretize_jax(mesh, {"Interior": ("interior", ()),
                              "Outlet": ("admittance", ("Y", 1e15))}, c)
    L.params["ω"] = OMEGA
    A = L.assemble({})
    Ar = permute_csr_jax(A, cuthill_mckee_jax(A))
    return sp.csr_matrix((Ar.data, Ar.indices, Ar.indptr), shape=Ar.shape), Ar


def _rowwise(Y, Yref, A, X):
    """max over entries of |Y − Y_ref| / (|A|·|X|): the Y = 1e15 penalty
    rows would swamp a global norm."""
    scale = abs(sp.csr_matrix(A)) @ np.abs(X).astype(np.float64)
    return float((np.abs(Y - Yref) / np.maximum(scale, 1e-300)).max())


def _global(Y, Yref):
    return float(np.linalg.norm(Y - Yref) / np.linalg.norm(Yref))


def _port(A, nrhs):
    """The port's operator from a scipy CSR (plain numpy arrays)."""
    return WindowSpmm.from_csr(A, nrhs=nrhs, device="cpu")


def _case(name):
    """(scipy A, the JAX kernel on it, X) of each JAX test's operator."""
    if name == "banded-900":
        A = _banded(900, 300)
        jax_op = K4(WindowBsr.from_csr(CSRJax(
            A.indptr, A.indices, A.data.astype(np.complex128), A.shape)),
            nrhs=16, interpret=True)
        r, seed = 16, 1
    elif name == "banded-2500":
        A = _banded(2500, 800)
        jax_op = K4(WindowBsr.from_csr(CSRJax(
            A.indptr, A.indices, A.data.astype(np.complex128), A.shape)),
            nrhs=16, interpret=True)
        r, seed = 16, 1
    elif name == "chunk-2200":
        A, Aj = _chunk_operator()
        jax_op = K5(ChunkBsr.from_csr(Aj), nrhs=128, interpret=True)
        r, seed = 128, 2
    else:
        A, Ar = _helmholtz_operator()
        jax_op = K4(WindowBsr.from_csr(Ar), nrhs=8, interpret=True)
        r, seed = 8, 2
    return A, jax_op, random_panel(A.shape[0], r, seed=seed)


@pytest.mark.parametrize("name", ["banded-900", "banded-2500", "chunk-2200",
                                  "helmholtz"])
def test_ref_matches_jax_window_kernels(name):
    """The plain version against K4 (banded and Helmholtz operators,
    ``WindowSpmm``) and K5 (``ChunkSpmm``) in interpret mode: each within
    the JAX test's 5e-6 of the host product, and port against JAX
    row-wise within 1e-6."""
    A, jax_op, X = _case(name)
    n = A.shape[0]
    calls = timing.total("window_spmm.twin_calls")
    Y = _port(A, X.shape[1])(X)
    assert timing.total("window_spmm.twin_calls") == calls + 1
    Yj = np.asarray(jax_op(X))[:n]
    Yref = A @ X.astype(np.complex128)
    assert Y.shape == (n, X.shape[1]) and Y.dtype == np.complex64
    assert _global(Y, Yref) < JAX_BAR
    assert _global(Yj, Yref) < JAX_BAR
    assert _rowwise(Y, Yj, A, X) <= PORT_VS_JAX


def _wide_band():
    """The operator K4 refuses (tests/test_window_spmm.py:39-49): the
    identity and the two far corners."""
    n = 4 * TILE
    A = sp.csr_matrix((np.ones(2), ([0, n - 1], [n - 1, 0])), shape=(n, n))
    return (A + sp.eye(n)).tocsr().astype(np.complex128)


def test_wide_band_beyond_the_tpu_window():
    """The operator K4 refuses: the kernel reads a nonzero outside its
    tile's ring window from global memory, so the port gets the right Y."""
    A = _wide_band()
    n = A.shape[0]
    with pytest.raises(ValueError, match="bandwidth"):
        WindowBsr.from_csr(CSRJax(A.indptr, A.indices, A.data, A.shape))
    X = random_panel(n, 8, seed=4)
    Y = _port(A, 8)(X)
    np.testing.assert_allclose(Y, A @ X.astype(np.complex128), rtol=1e-6,
                               atol=1e-6)


def test_chain_matches_jax_chain_fn():
    """chain(3) against K4's chain_fn(3) in interpret mode: three applies,
    each scaled by 1/max(‖Y‖_F, 1e-30), to 5e-6 relative; the plain chain
    (``spmm=window_spmm_ref``) is the same computation."""
    A = _banded(900, 300)
    jax_op = K4(WindowBsr.from_csr(CSRJax(
        A.indptr, A.indices, A.data.astype(np.complex128), A.shape)),
        nrhs=16, interpret=True)
    X = random_panel(900, 16, seed=5)
    yr, yi = jax_op.chain_fn(3)(*jax_op.split_panels(X))
    Yj = (np.asarray(yr) + 1j * np.asarray(yi)).reshape(-1, 16)[:900]
    op = _port(A, 16)
    Xd = op.panel(X)
    Y = op.chain(3)(Xd).numpy()
    assert _global(Y, Yj) <= JAX_BAR
    assert abs(np.linalg.norm(Y) - 1.0) <= 1e-6
    np.testing.assert_array_equal(op.chain(3, window_spmm_ref)(Xd).numpy(), Y)


def test_wrapper_checks_and_counts():
    A = _banded(300, 40)
    op = _port(A, 8)
    X = op.panel(random_panel(300, 8))
    launches, calls = _counts("window_spmm")
    op.apply(X)
    assert _counts("window_spmm") == \
        (launches, calls + 1)
    with pytest.raises(TypeError):
        window_spmm(op.indptr, op.cols, op.vals.to(torch.complex128), X)
    with pytest.raises(TypeError):
        window_spmm(op.indptr, op.cols.long(), op.vals, X)
    with pytest.raises(ValueError):
        window_spmm(op.indptr, op.cols, op.vals, X.to("meta"))
    with pytest.raises(ValueError):
        window_spmm(op.indptr, op.cols, op.vals[:-1], X)
    with pytest.raises(ValueError):
        window_spmm(op.indptr, op.cols, op.vals, X.t())
    with pytest.raises(ValueError, match="column index"):
        WindowSpmm(A.indptr, A.indices, A.data, (300, 200), device="cpu")
    with pytest.raises(ValueError, match="row pointer"):
        WindowSpmm(A.indptr[:-1], A.indices, A.data, A.shape, device="cpu")
    assert op.stream_bytes == 12 * A.nnz + 4 * 301 + 8 * 600 * 8


def test_plan_is_tied_to_its_structure():
    """A launch plan holds the structure tensors it was made from and the
    wrapper takes it only with those very tensors at its width: a plan of
    another operator of the same structure, of the same arrays copied, or
    of another width is refused (on CPU tensors too)."""
    A = _banded(300, 40)
    op, twin = _port(A, 8), _port(A, 8)
    X = op.panel(random_panel(300, 8))
    lp = plan(op.indptr, op.cols, 8, 132)
    assert lp.indptr is op.indptr and lp.cols is op.cols
    copied = plan(A.indptr, A.indices, 8, 132)
    for field in ("tiles", "streams", "slots", "order"):
        assert torch.equal(getattr(lp, field), getattr(copied, field))
    np.testing.assert_array_equal(
        window_spmm(op.indptr, op.cols, op.vals, X, lp).numpy(),
        op.apply(X).numpy())
    for other in (plan(twin.indptr, twin.cols, 8, 132), copied,
                  plan(op.indptr, op.cols, 16, 132)):
        with pytest.raises(ValueError, match="launch plan"):
            window_spmm(op.indptr, op.cols, op.vals, X, other)


def _octosplit_2996():
    """The 2,996-DOF octosplit passive family at 2π·300 in Cuthill–McKee
    order (the operator of path C, cut to the test family)."""
    L = large_operator_family(n_rings=2, nz_cold=10, nz_hot=10)
    L.params[L.eigval] = OMEGA
    A = L.assemble({})
    Ar = permute_csr(A, cuthill_mckee(A))
    return sp.csr_matrix((Ar.data, Ar.indices, Ar.indptr), shape=Ar.shape)


def _walk(lp, t0, t1, q):
    """The tiles of range q in the order its blocks walk them."""
    return range(t1 - 1, t0 - 1, -1) if q % 2 else range(t0, t1)


def _outside_brute_force(A, q_of_tile, n_tiles):
    """Nonzeros outside their tile's ring window, tile by tile from the
    definitions: walking forward, the window starts at the stage of the
    least column of the tile and the range's later tiles; walking
    backward, it ends at the stage of the largest column of the tile and
    the range's earlier tiles."""
    out = 0
    for t in range(n_tiles):
        q = q_of_tile[t]
        rows = A[t * TILE_ROWS:(t + 1) * TILE_ROWS]
        if rows.nnz == 0:
            continue
        same = np.flatnonzero(q_of_tile == q)
        if q % 2 == 0:
            rest = A[t * TILE_ROWS:(same[-1] + 1) * TILE_ROWS]
            start = rest.indices.min() // STAGE_ROWS * STAGE_ROWS
            out += int((rows.indices >= start + RING_ROWS).sum())
        else:
            rest = A[same[0] * TILE_ROWS:(t + 1) * TILE_ROWS]
            end = (rest.indices.max() // STAGE_ROWS + 1) * STAGE_ROWS
            out += int((rows.indices < end - RING_ROWS).sum())
    return out


def _ring_walk(A, lp, X):
    """Y from the plan alone, as the kernel's blocks would form it: each
    range's producer stages X while the ring has a free buffer, each tile
    reads its in-window nonzeros' X rows from the ring buffer its slot
    names (which must hold that row's stage then) and the others from X,
    and then releases the stages before the next tile's first."""
    n = A.shape[0]
    n_tiles = lp.tiles.shape[0]
    tiles, streams, slots = (lp.tiles.numpy(), lp.streams.numpy(),
                             lp.slots.numpy())
    Xr = np.empty((len(slots), X.shape[1]), X.dtype)
    for q in range(lp.ranges):
        t0, t1 = q * n_tiles // lp.ranges, (q + 1) * n_tiles // lp.ranges
        first, count = streams[q]
        stage = (lambda i: first - i) if q % 2 else (lambda i: first + i)
        ring = {}                                 # buffer -> X stage
        loaded = released = 0
        walk = list(_walk(lp, t0, t1, q))
        for p, t in enumerate(walk):
            while loaded < count and loaded - RING_STAGES < released:
                ring[stage(loaded) % RING_STAGES] = stage(loaded)
                loaded += 1
            far, near = tiles[t]
            assert far < loaded                   # never waits forever
            for k in range(A.indptr[t * TILE_ROWS],
                           A.indptr[min((t + 1) * TILE_ROWS, n)]):
                s = slots[k]
                if s < 0:
                    Xr[k] = X[-1 - s]
                    continue
                j = ring[s // STAGE_ROWS]
                row = j * STAGE_ROWS + s % STAGE_ROWS
                assert row == A.indices[k]
                i = first - j if q % 2 else j - first
                assert near <= i <= far
                Xr[k] = X[row]
            if p + 1 < len(walk):
                released = max(released, min(tiles[walk[p + 1]][1], count))
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    Y = np.zeros((n, X.shape[1]), complex)
    np.add.at(Y, rows, A.data[:, None] * Xr)
    return Y


@pytest.mark.parametrize("r,n_sm", [(128, 132), (128, 114), (16, 132),
                                    (260, 132)])
@pytest.mark.parametrize("name", ["octosplit-2996", "banded-2500",
                                  "wide-band"])
def test_launch_plan(name, r, n_sm):
    """The kernel's launch plan (ops/window_spmm.plan) on three operators,
    at the main path's r = 128 on an H100 SXM's 132 SMs and an H100 PCIe's
    114, at r = 16, and at r = 260 (a ragged last chunk).  The blocks fit
    the SMs and the ranges cover the tiles; each tile's rows are dealt out
    to the warps longest first, group g of ROWS_A_WARP to warp g − t;
    along each range's walk the window never moves back; every nonzero in
    its tile's window lies in a stage the tile waits for, at ring row
    col % RING_ROWS; the count of nonzeros outside equals a brute-force
    count (0 on the reordered octosplit operator); and a walk of the ring
    by the plan alone, its producer running ahead as far as the ring
    allows, forms the product."""
    A = {"octosplit-2996": _octosplit_2996,
         "banded-2500": lambda: _banded(2500, 800),
         "wide-band": _wide_band}[name]()
    n = A.shape[0]
    lp = plan(A.indptr, A.indices, r, n_sm)
    n_tiles = -(-n // TILE_ROWS)
    assert lp.chunks == -(-r // CHUNK) and lp.blocks <= n_sm
    assert lp.tiles.shape == (n_tiles, 2) and lp.slots.shape == (A.nnz,)
    q_of_tile = np.empty(n_tiles, int)
    tiles, streams = lp.tiles.numpy(), lp.streams.numpy()
    for q in range(lp.ranges):
        t0, t1 = q * n_tiles // lp.ranges, (q + 1) * n_tiles // lp.ranges
        assert t1 > t0
        q_of_tile[t0:t1] = q
        walk = list(_walk(lp, t0, t1, q))
        edge = lp.window[walk, 1 if q % 2 else 0]
        assert np.all(np.diff(edge) * (-1 if q % 2 else 1) >= 0)
        assert np.all(np.diff(tiles[walk, 1]) >= 0)
        for t in walk:
            far, near = tiles[t]
            if far >= 0:
                assert 0 <= near <= far < streams[q, 1]
                assert far - near < RING_STAGES
    length = np.diff(A.indptr)
    order = lp.order.numpy().reshape(n_tiles, CONSUMER_WARPS, ROWS_A_WARP)
    for t in range(n_tiles):
        rows = np.roll(order[t], t, axis=0).reshape(-1)
        real = rows[rows >= 0]
        np.testing.assert_array_equal(
            np.sort(real), np.arange(t * TILE_ROWS, min(n, (t + 1) *
                                                       TILE_ROWS)))
        assert np.all(rows[len(real):] == -1)
        assert np.all(np.diff(length[real]) <= 0)
    slots = lp.slots.numpy()
    inside = slots >= 0
    assert np.all(slots[inside] == A.indices[inside] % RING_ROWS)
    assert np.all(-1 - slots[~inside] == A.indices[~inside])
    assert lp.out_of_window == int((~inside).sum()) == \
        _outside_brute_force(A, q_of_tile, n_tiles)
    if name == "octosplit-2996":
        assert lp.out_of_window == 0
    else:
        assert lp.out_of_window > 0
    X = random_panel(n, 4, seed=r).astype(np.complex128)
    np.testing.assert_allclose(_ring_walk(A, lp, X), A @ X, rtol=1e-12,
                               atol=1e-12)


def _random_sparse(n, per_row, seed):
    """The matrices of tests/test_device_ops.py:16-22."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n), complex)
    for i in range(n):
        for j in rng.choice(n, per_row):
            A[i, j] = rng.standard_normal() + 1j * rng.standard_normal()
    return A


def test_ell_equals_jax():
    """csr_to_ell, EllOperator.pack/matvec/matmat and spmv_ell against the
    JAX package (the twin of tests/test_device_ops.py:25)."""
    A = _random_sparse(300, 6, 0)
    C, Cj = CSR.from_dense(A), CSRJax.from_dense(A)
    for a, b in zip(csr_to_ell(C.indptr, C.indices, 300),
                    csr_to_ell_jax(Cj.indptr, Cj.indices, 300)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        csr_to_ell(C.indptr, C.indices, 300, width=1)
    ell, ellj = EllOperator.from_csr(C, device="cpu"), EllJax.from_csr(Cj)
    vals = ell.pack(torch.from_numpy(C.data))
    np.testing.assert_array_equal(vals.numpy(),
                                  np.asarray(ellj.pack(Cj.data)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    xt = torch.from_numpy(x)
    y = ell.matvec(vals, xt).numpy()
    np.testing.assert_allclose(y, np.asarray(ellj.matvec(ellj.pack(Cj.data),
                                                         x)), rtol=1e-13)
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(spmv_ell(vals, ell.cols, xt).numpy(), y)
    Y = ell.matmat(vals, torch.stack([xt, 2 * xt], dim=1)).numpy()
    np.testing.assert_allclose(Y[:, 1], 2 * (A @ x), rtol=1e-12, atol=1e-12)


def test_device_stacked_operator_equals_jax():
    """data/matvec/dense against the JAX class in complex128 (the twin of
    tests/test_device_ops.py:78), single and batched coefficients."""
    A, B = _random_sparse(200, 5, 5), _random_sparse(200, 5, 6)
    st = StackedOperator.from_csrs([CSR.from_dense(A), CSR.from_dense(B)])
    stj = StackedJax.from_csrs([CSRJax.from_dense(A), CSRJax.from_dense(B)])
    dso = DeviceStackedOperator(st, device="cpu")
    dsoj = DeviceStackedJax(stj, dtype=np.complex128)
    assert dso.values.dtype == torch.complex128
    c = np.array([0.3 + 1j, -2.0], complex)
    C = np.stack([c, 2 * c])
    x = random_panel(200, 1, seed=7)[:, 0].astype(np.complex128)
    for coeffs in (c, C):
        np.testing.assert_allclose(dso.data(coeffs).numpy(),
                                   np.asarray(dsoj.data(coeffs)), rtol=1e-15)
        np.testing.assert_allclose(dso.dense(coeffs).numpy(),
                                   np.asarray(dsoj.dense(coeffs)),
                                   rtol=1e-15)
    np.testing.assert_allclose(dso.matvec(c, x).numpy(),
                               np.asarray(dsoj.matvec(c, x)), rtol=1e-13)
    np.testing.assert_allclose(dso.dense(c).numpy(), c[0] * A + c[1] * B,
                               rtol=1e-15)


def test_operator_apply_window_reuses_plan():
    """The entry point on the CPU with kernel="window" on the 437-DOF
    family: Y row-wise within 1e-6 of the complex128 host CSR product; the
    second call at another z reuses the plan and evaluates the family
    anew; the BSR plan is a separate one."""
    L = active_rijke_family()
    L.params[L.eigval] = OMEGA
    A = L.assemble({})
    X = random_panel(L.size, 32, seed=3)
    operator_apply(L, 340 * 2 * np.pi, X, kernel="window", device="cpu")
    plan = L._window_plan[2]
    calls = timing.total("window_spmm.twin_calls")
    Y = operator_apply(L, OMEGA, X, kernel="window", device="cpu")
    assert L._window_plan[2] is plan
    assert timing.total("window_spmm.twin_calls") == calls + 1
    assert Y.shape == X.shape and Y.dtype == np.complex64
    As = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
    assert _rowwise(Y, As @ X.astype(np.complex128), As, X) <= 1e-6
    assert getattr(L, "_bsr_plan", None) is None
    with pytest.raises(ValueError, match="kernel"):
        operator_apply(L, OMEGA, X, kernel="csr", device="cpu")


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_large_operator_apply_matches_jax_bench_path(kernel):
    """The slice as a whole on a small octosplit family (2,996 DOF): the
    port's operator_apply(kernel="window") against the JAX bench's path
    (``bench.py:550-585``: discretize on the octosplit mesh, assemble at
    2π·300, Cuthill–McKee, WindowSpmm or ChunkSpmm in interpret mode),
    row-wise within 1e-6, and both within the bench's 5e-5 of the host
    product."""
    L = large_operator_family(n_rings=2, nz_cold=10, nz_hot=10)
    mesh = octosplit_jax(rijke_mesh_jax(n_rings=2, nz_cold=10, nz_hot=10))
    gamma, R, Tu, Tb = 1.4, 287.05, 300.0, 1200.0
    c = mesh.generate_field(
        lambda x, y, z: np.where(z < 0, np.sqrt(gamma * R * Tu),
                                 np.sqrt(gamma * R * Tb)))
    Lj = discretize_jax(mesh, {"Interior": ("interior", ()),
                               "Outlet": ("admittance", ("Y", 1e15))}, c)
    Lj.params["ω"] = OMEGA
    Aj = Lj.assemble({})
    perm = cuthill_mckee_jax(Aj)
    Ajr = permute_csr_jax(Aj, perm)
    op = (K4(WindowBsr.from_csr(Ajr), nrhs=8, interpret=True)
          if kernel == "K4" else
          K5(ChunkBsr.from_csr(Ajr), nrhs=8, interpret=True))
    n = L.size
    X = random_panel(n, 8, seed=9)
    Yj = np.empty((n, 8), np.complex64)
    Yj[perm] = np.asarray(op(X[perm]))[:n]
    Y = operator_apply(L, OMEGA, X, kernel="window", device="cpu")
    As = sp.csr_matrix((Aj.data, Aj.indices, Aj.indptr), shape=Aj.shape)
    Yref = As @ X.astype(np.complex128)
    assert _rowwise(Y, Yj, As, X) <= PORT_VS_JAX
    assert _rowwise(Y, Yref, As, X) <= PORT_VS_JAX
    assert _global(Y, Yref) < 5e-5 and _global(Yj, Yref) < 5e-5
