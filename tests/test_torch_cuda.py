"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).  They skip
where torch sees no card.  This file imports no jax, so on a machine
without jax it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

import scipy.sparse as sp

from wavesandeigenvalues_jl_tpu_torch.models.rijke import (
    active_rijke_family, large_operator_family)
from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local import \
    FusedPencilSolver
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
    FusedSlabPencilSolver
from wavesandeigenvalues_jl_tpu_torch.ops.bsr_spmm import (
    BsrSpmm, bsr_spmm, bsr_spmm_packed_ref, operator_apply, random_panel)
from wavesandeigenvalues_jl_tpu_torch.ops.dense_gmres import (
    N_MAX, build, dense_gmres, dense_gmres_ref, launch)
from wavesandeigenvalues_jl_tpu_torch.ops.device import BsrOperator
from wavesandeigenvalues_jl_tpu_torch.ops.gmres import gmres_test_problem
from wavesandeigenvalues_jl_tpu_torch.ops.reorder import (cuthill_mckee,
                                                          permute_csr)
from wavesandeigenvalues_jl_tpu_torch.ops.sparse import CSR
from wavesandeigenvalues_jl_tpu_torch.ops.slab_solve import SlabSolver
from wavesandeigenvalues_jl_tpu_torch.ops.slab_thomas import (S_MAX,
                                                               slab_thomas,
                                                               slab_thomas_ref)
from wavesandeigenvalues_jl_tpu_torch.ops.window_spmm import (
    WindowSpmm, launch as window_launch, window_spmm, window_spmm_ref)
from wavesandeigenvalues_jl_tpu_torch.ops.window_spmm import \
    build as window_build
from wavesandeigenvalues_jl_tpu_torch.utils import timing


def _counts(kernel):
    """(launches, plain calls) of a kernel wrapper so far."""
    return (timing.total(f"{kernel}.launches"),
            timing.total(f"{kernel}.twin_calls"))


pytestmark = pytest.mark.cuda

Z0 = 340 * 2 * np.pi
#: JAX host mslp (complex128 sparse LU) on the 437-DOF active family
OMEGA_437 = 1074.9363291294444 + 373.1589412263712j
#: K1, K2 and K3 are held against their plain versions on this many
#: launches, each into its own output: a race in their barriers shows on
#: some only
REPEATS = 50


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("sides,m,s", [(2, 60, 256), (2, 13, 128),
                                       (2, 5, 384), (1, 1, 128),
                                       (2, 20, 1280), (2, 24, 640)])
def test_kernel_matches_twin(cuda, sides, m, s):
    """K3 against its plain version on the card, to 1e-5 relative (float32
    sums in another order over a 2m-step recursion), on every one of
    REPEATS launches made back to back; (2, 20, 1280) and (2, 24, 640) are
    the Hermite Rijke's and the APE duct's slab shapes (chip_smoke.py path
    I)."""
    rng = np.random.default_rng(m * s)
    shp = (sides, 2 * m, s, s)
    stream = ((rng.standard_normal(shp) + 1j * rng.standard_normal(shp))
              * (0.5 / s)).astype(np.complex64)
    bt = (rng.standard_normal((sides, m, s))
          + 1j * rng.standard_normal((sides, m, s))).astype(np.complex64)
    st, b = torch.from_numpy(stream).to(cuda), torch.from_numpy(bt).to(cuda)
    _check_k3(st, b)


def _check_k3(st, b):
    """REPEATS launches of K3, each within 1e-5 relative of the plain
    version, and no plain call."""
    launches, calls = _counts("slab_thomas")
    xs = [slab_thomas(st, b) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    assert _counts("slab_thomas") == \
        (launches + REPEATS, calls)
    ref = slab_thomas_ref(st, b)
    rel = max(((x - ref).abs().max() / ref.abs().max()).item() for x in xs)
    assert rel <= 1e-5


@pytest.mark.parametrize("sides,m,s", [(1, 3, 2304), (1, 2, 4608),
                                       (1, 1, S_MAX)])
def test_kernel_wide_slabs(cuda, sides, m, s):
    """K3 on slabs wider than one TMA box a stripe (s > 2048: several boxes
    a chunk, shallower chunks, several columns a thread), up to the widest
    it takes, against its plain version as above."""
    g = torch.Generator(device=cuda).manual_seed(s)
    st = torch.randn((sides, 2 * m, s, s), dtype=torch.complex64,
                     device=cuda, generator=g) * (0.5 / s)
    b = torch.randn((sides, m, s), dtype=torch.complex64, device=cuda,
                    generator=g)
    _check_k3(st, b)


def test_slab_thomas_refuses(cuda):
    """K3's wrapper raises on s no multiple of 128 and on s above S_MAX,
    and launches nothing."""
    launches = timing.total("slab_thomas.launches")
    for s in (200, S_MAX + 128):
        st = torch.empty((1, 2, s, s), dtype=torch.complex64, device=cuda)
        b = torch.zeros((1, 1, s), dtype=torch.complex64, device=cuda)
        with pytest.raises(ValueError, match="multiple of 128"):
            slab_thomas(st, b)
        del st
    assert timing.total("slab_thomas.launches") == launches


def test_step_on_card_matches_cpu(cuda):
    """One fused step on the card against the same step on the CPU (the
    plain K3): dz and λ to 2e-6 relative — the complex64 factorization
    runs through other BLAS and LAPACK kernels, in another summation order
    (7.7e-7 measured on an H100)."""
    L = active_rijke_family()
    n = L.size
    out = []
    for dev in ("cpu", cuda):
        solver = FusedSlabPencilSolver(L, dev)
        out.append(solver.step(complex(Z0),
                               torch.ones(2, n, dtype=torch.complex64,
                                          device=dev), 0.0 + 0.0j))
    (dz_c, lam_c, _, _), (dz_g, lam_g, carries, res) = out
    assert carries.device.type == "cuda"
    assert abs(dz_g - dz_c) <= 2e-6 * abs(dz_c)
    assert abs(lam_g - lam_c) <= 2e-6 * abs(lam_c)
    assert res.max() < 1e-5


def test_mslp_on_card(cuda):
    """The slab engine forced at n = 437 (below FUSED_MAX_DIM)."""
    L = active_rijke_family()
    L._fused_solver = (L._stack(), FusedSlabPencilSolver(L, cuda))
    launches, calls = _counts("slab_thomas")
    sol, n_it, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device=cuda)
    om = sol.params[sol.eigval]
    assert flag == 0
    assert abs(om - OMEGA_437) <= 1e-8 * abs(OMEGA_437)
    assert timing.total("slab_thomas.launches") > launches
    assert timing.total("slab_thomas.twin_calls") == calls


def test_step_spans_on_card(cuda):
    """The slab engine's device spans on the card: ``factor`` and ``solves``
    hold stream times, positive and within their step's wall, and the
    request counted K3's launches under (2, m, s), three a device step."""
    L = active_rijke_family()
    solver = FusedSlabPencilSolver(L, cuda)
    L._fused_solver = (L._stack(), solver)
    timing.reset()
    _, _, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device=cuda)
    spans = timing.spans()
    root, = [s for s in spans if s.id == s.request]
    assert flag == 0 and root.attrs["flag"] == 0
    assert root.attrs["engine"] == "FusedSlabPencilSolver"
    steps = {s.id: s for s in spans if s.path == "fused_local.device_step"}
    assert len(steps) == root.attrs["device_steps"] >= 1
    dev = [s for s in spans if s.name in ("factor", "solves")]
    assert len(dev) == 2 * len(steps)
    for s in dev:
        assert 0 < s.device_ms <= steps[s.parent].wall_s * 1e3
    assert timing.counts("slab_thomas.launches", request=root.id) == {
        (2, solver.m, solver.s): 3 * len(steps)}
    timing.reset()


def _solve_data(solver, z, sigma=0.0):
    """Both sides' complex128 solve data g [2, nnz] of ``solver`` at z."""
    c, _ = solver.coefficients(complex(z))
    dev = solver.device
    return solver.solve_data(torch.from_numpy(c).to(dev),
                             torch.tensor(complex(sigma), device=dev,
                                          dtype=torch.complex128))[1]


def _solve_loop_factor(solver, g, dtype=torch.complex64):
    """The slab factor as it ran before the CUDA graph: equilibration,
    scatter and m batched ``torch.linalg.solve`` steps, launched eagerly,
    in ``dtype`` (the panels rounded to complex64 first, as the engine
    has them).  Returns (DT, stream)."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp.pencil import _pad0
    m, s = solver.m, solver.s
    rm = solver._ell(_pad0(g.abs())).amax(-1)
    scale = 1.0 / torch.where(rm == 0, 1.0, rm)
    gs = (g * scale.gather(1, solver.rows2)).to(torch.complex64).to(dtype)
    blk = gs.new_zeros(2 * m * 3 * s * s)
    blk.index_put_((solver.dest2.view(-1),), gs.view(-1))
    blk = blk.view(2, m, 3, s, s)
    eye = torch.eye(s, dtype=dtype, device=blk.device).expand(2, s, s)
    pad = solver.pad.to(dtype)
    DT = blk.new_empty(2, m, s, s)
    stream = blk.new_empty(2, 2 * m, s, s)
    C = blk.new_zeros(2, s, s)
    for i in range(m):
        Lb, Db, Ub = blk[:, i, 0], blk[:, i, 1], blk[:, i, 2]
        Dtinv = torch.linalg.solve(Db - Lb @ C + torch.diag(pad[i]), eye)
        C = Dtinv @ Ub
        DT[:, i] = Dtinv
        stream[:, i] = (Dtinv @ Lb).transpose(1, 2)
        stream[:, 2 * m - 1 - i] = C.transpose(1, 2)
    return DT, stream


def _rel(a, b):
    """Largest entry of a − b over b's largest entry."""
    return ((a.to(b.dtype) - b).abs().max() / b.abs().max()).item()


def _check_factor(solver, g, DT, stream):
    """DT and the K3 stream of the slab factor at g: against the same
    recursion in complex128, no farther than the loop of batched
    ``torch.linalg.solve`` that the graph replaced (on an H100: 1.2e-5
    against 1.3e-4 at (2, 59, 256), both for the inverses).  The two
    complex64 routes differ from each other by that loop's own rounding,
    so they are not compared with each other."""
    exact = _solve_loop_factor(solver, g, torch.complex128)
    loop = _solve_loop_factor(solver, g)
    for got, old, ref in zip((DT, stream), loop, exact):
        assert _rel(got, ref) <= _rel(old, ref)


#: rijke_mesh arguments of active families and their slab shapes (m, s):
#: the benchmark cell's (2, 59, 256) at 7,259 DOF, and (2, 48, 128) at
#: 1,805 DOF (path H1's shape)
SLAB_MESHES = {(4, 59, 57): (59, 256), (2, 46, 46): (48, 128)}


@pytest.mark.parametrize("mesh", list(SLAB_MESHES), ids=["2x59x256",
                                                         "2x48x128"])
def test_factor_graph_matches_solve_loop(cuda, mesh):
    """The replayed factor graph is as close to the complex128 recursion
    as the batched-solve loop it replaced (``_check_factor``), and every
    one of 20 replays on the same input gives the same bits (the sides'
    two streams share no scratch)."""
    solver = FusedSlabPencilSolver(active_rijke_family(*mesh), cuda)
    assert (solver.m, solver.s) == SLAB_MESHES[mesh]
    g = _solve_data(solver, Z0)
    DT, stream, _ = solver._factor(g)
    assert solver._graph is not None
    first = (DT.clone(), stream.clone())
    _check_factor(solver, g, *first)
    for _ in range(20):
        DT, stream, _ = solver._factor(g)
        assert torch.equal(DT, first[0]) and torch.equal(stream, first[1])


def test_factor_graph_refreshes_its_inputs(cuda):
    """Two replays on different solve data each give their own input's
    factor: the graph reads the static input buffer anew."""
    solver = FusedSlabPencilSolver(active_rijke_family(2, 46, 46), cuda)
    gs = [_solve_data(solver, Z0), _solve_data(solver, 1.7 * Z0, 50.0)]
    got = []
    for g in gs:
        DT, stream, _ = solver._factor(g)
        got.append((DT.clone(), stream.clone()))
    for g, factor in zip(gs, got):
        _check_factor(solver, g, *factor)
    assert _rel(got[0][1], got[1][1]) > 1e-2


def test_factor_graph_counts(cuda):
    """An mslp through a new slab solver on the card captures the factor
    once, at its first device step, and replays it at every step; nothing
    runs eagerly."""
    L = active_rijke_family()
    solver = FusedSlabPencilSolver(L, cuda)
    L._fused_solver = (L._stack(), solver)
    timing.reset()
    _, _, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device=cuda)
    root, = [s for s in timing.spans() if s.id == s.request]
    assert flag == 0
    assert timing.counts("fused_slab.factor") == {
        "capture": 1, "replay": root.attrs["device_steps"]}
    _, _, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device=cuda)
    counts = timing.counts("fused_slab.factor")
    assert flag == 0 and counts["capture"] == 1
    assert set(counts) == {"capture", "replay"}
    timing.reset()


def test_factor_graph_singular_raises(cuda):
    """Solve data that leave a Dt_i singular (all zero: each slab's Dt is
    0 on its rows) raise ``LinAlgError`` after the replay, as the batched
    ``torch.linalg.solve`` did; the next replay on sound data gives the
    same bits as before it."""
    solver = FusedSlabPencilSolver(active_rijke_family(2, 46, 46), cuda)
    g = _solve_data(solver, Z0)
    DT, stream, _ = solver._factor(g)
    first = (DT.clone(), stream.clone())
    with pytest.raises(torch.linalg.LinAlgError, match="singular"):
        solver._factor(torch.zeros_like(g))
    DT, stream, _ = solver._factor(g)
    assert torch.equal(DT, first[0]) and torch.equal(stream, first[1])


@pytest.mark.parametrize("sides,N,m,cycles,tol", [
    (2, 256, 30, 2, 1e-5), (2, 512, 80, 1, 1e-5), (2, 1408, 80, 1, 1e-4),
    (1, 128, 10, 1, 1e-5)])
def test_dense_gmres_matches_twin(cuda, sides, N, m, cycles, tol):
    """K2 against its plain version on the card, relative to ``tol``
    (float32 sums in another order; 1e-4 over the 80 steps at the main
    path's N = 1,408), on every one of REPEATS launches made back to back,
    each into its own output; every launch gives the same bits (all sums
    in a fixed order).  At (2, 256, 30, 2) each side's true residual is
    ≤ 5e-6, the bar of the JAX package's test_pallas_gmres.py:49."""
    P, b0, Gs, b = gmres_test_problem(N)
    Pt = torch.from_numpy(P[:sides].copy()).to(cuda)
    bt = torch.from_numpy(b0[:sides].copy()).to(cuda)
    launches, calls = _counts("dense_gmres")
    xs = [dense_gmres(Pt, bt, m, cycles) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    assert _counts("dense_gmres") == \
        (launches + REPEATS, calls)
    ref = dense_gmres_ref(Pt, bt, m, cycles)
    rel = max(((x - ref).abs().max() / ref.abs().max()).item() for x in xs)
    assert rel <= tol
    assert all(torch.equal(x, xs[0]) for x in xs)
    if cycles == 2:
        xh = xs[0].cpu().numpy()
        for s in range(sides):
            res = np.linalg.norm(Gs[s] @ xh[s] - b) / np.linalg.norm(b)
            assert res <= 5e-6


def test_dense_gmres_plan_of_fewer_sms(cuda):
    """K2 at the main path's (2, 1408, 80, 1) launched with the plan of a
    114-SM card (an H100 PCIe): 26 rows a block, 9 of them streamed, the
    last one read from L2 in the matvec.  Within 1e-4 of the plain version
    on every one of REPEATS launches, all with the same bits."""
    P, b0, _, _ = gmres_test_problem(N_MAX)
    Pt, bt = torch.from_numpy(P).to(cuda), torch.from_numpy(b0).to(cuda)
    lib = build()["lib"]
    xs = [launch(lib, Pt, bt, 80, 1, n_sm=114) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    ref = dense_gmres_ref(Pt, bt, 80, 1)
    rel = max(((x - ref).abs().max() / ref.abs().max()).item() for x in xs)
    assert rel <= 1e-4
    assert all(torch.equal(x, xs[0]) for x in xs)


def test_dense_gmres_refuses(cuda):
    """K2's wrapper raises on N above N_MAX, on three sides and on an m
    whose Givens block does not fit shared memory, and launches nothing."""
    launches = timing.total("dense_gmres.launches")
    for S, N, m in ((2, N_MAX + 128, 10), (3, 128, 10), (2, 128, 200)):
        P = torch.zeros((S, N, N), dtype=torch.complex64, device=cuda)
        b = torch.ones((S, N), dtype=torch.complex64, device=cuda)
        with pytest.raises(ValueError):
            dense_gmres(P, b, m, 1)
    assert timing.total("dense_gmres.launches") == launches


def test_dense_mslp_on_card(cuda):
    """The dense engine at n = 437: flag 0, OMEGA_437 to 1e-8, through K2
    and never its plain version."""
    L = active_rijke_family()
    launches, calls = _counts("dense_gmres")
    sol, n_it, flag = mslp(L, Z0, maxiter=30, tol=1e-11)
    om = sol.params[sol.eigval]
    assert isinstance(L._fused_solver[1], FusedPencilSolver)
    assert flag == 0
    assert abs(om - OMEGA_437) <= 1e-8 * abs(OMEGA_437)
    assert timing.total("dense_gmres.launches") > launches
    assert timing.total("dense_gmres.twin_calls") == calls


def test_dense_spans_on_card(cuda):
    """The dense engine's records on the card: K2's launches keyed by the
    launch shape (2, 512, 80, 1), three a device step, and one
    ``bj_refresh`` span for each count of the block-Jacobi refresh, at
    least one a request."""
    L = active_rijke_family()
    timing.reset()
    _, _, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device=cuda)
    spans = timing.spans()
    root, = [s for s in spans if s.id == s.request]
    assert flag == 0 and root.attrs["engine"] == "FusedPencilSolver"
    assert timing.counts("dense_gmres.launches", request=root.id) == {
        (2, 512, 80, 1): 3 * root.attrs["device_steps"]}
    assert timing.total("dense_gmres.twin_calls") == 0
    refreshes = [s for s in spans if s.name == "bj_refresh"]
    assert len(refreshes) == timing.total("fused_local.bj_refresh") >= 1
    timing.reset()


@pytest.fixture(scope="module")
def reordered_437():
    """The reordered 437-DOF operator at ω = 2π·300 (host CSR)."""
    L = active_rijke_family()
    L.params[L.eigval] = 2 * np.pi * 300.0
    A = L.assemble({})
    return permute_csr(A, cuthill_mckee(A))


@pytest.mark.parametrize("r", [32, 128, 160])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_bsr_spmm_matches_twin(cuda, reordered_437, bs, r):
    """K1 against its plain version on the card, on the reordered 437-DOF
    operator, row-wise to 1e-6 on every one of REPEATS launches.  437 is no
    multiple of bs, so the last block row has padding rows without
    nonzeros, which must come out 0."""
    Ar = reordered_437
    Ys = _check_k1(Ar, bs, r, cuda)
    assert all((Y.reshape(-1, r)[Ar.shape[0]:] == 0).all() for Y in Ys)


def _check_k1(A, bs, r, cuda):
    """REPEATS launches of K1 on A at (bs, r), each row-wise within 1e-6 of
    the plain version, and no plain call; returns the outputs."""
    op = BsrSpmm(BsrOperator.from_csr(A, bs=bs), cuda, nrhs=r)
    Xp = op.panel(random_panel(A.shape[0], r, seed=bs + r))
    args = (op.row_ptr, op.lcol, op.vals, op.block_cols, Xp)
    launches, calls = _counts("bsr_spmm")
    Ys = [bsr_spmm(*args) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    assert _counts("bsr_spmm") == \
        (launches + REPEATS, calls)
    ref = bsr_spmm_packed_ref(*args)
    scale = bsr_spmm_packed_ref(op.row_ptr, op.lcol,
                                op.vals.abs().to(torch.complex64),
                                op.block_cols,
                                Xp.abs().to(torch.complex64)).real
    rel = max(((Y - ref).abs() / scale.clamp_min(1e-30)).max().item()
              for Y in Ys)
    assert rel <= 1e-6
    return Ys


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_bsr_spmm_wide_window(cuda, bs):
    """K1 on a band of ±800 rows: 51, 27 and 15 slots at bs 32, 64 and 128,
    more than shared memory holds at once (28, 14, 7), so the window is
    staged in two or three passes; against its plain version as above."""
    A = _banded(2500, 800)
    _check_k1(CSR(A.indptr, A.indices, A.data, A.shape), bs, 64, cuda)


def test_bsr_spmm_refuses(cuda, reordered_437):
    """K1's wrapper raises on a panel width that is no multiple of 32 and
    on a CPU/CUDA mix, and launches nothing."""
    op = BsrSpmm(BsrOperator.from_csr(reordered_437, bs=64), cuda, nrhs=48)
    Xp = op.panel(random_panel(reordered_437.shape[0], 48))
    launches = timing.total("bsr_spmm.launches")
    with pytest.raises(ValueError, match="multiple"):
        bsr_spmm(op.row_ptr, op.lcol, op.vals, op.block_cols, Xp)
    with pytest.raises(ValueError):
        bsr_spmm(op.row_ptr.cpu(), op.lcol, op.vals, op.block_cols,
                 Xp[..., :32].contiguous())
    assert timing.total("bsr_spmm.launches") == launches


def test_operator_apply_on_card(cuda):
    """The entry point with its default device: one K1 launch and no plain
    call per apply, the plan reused across z, and Y row-wise within 1e-5 of
    the complex128 host CSR product."""
    L = active_rijke_family()
    X = random_panel(L.size, 128, seed=5)
    operator_apply(L, Z0, X)
    plan = L._bsr_plan[2]
    launches, calls = _counts("bsr_spmm")
    Y = operator_apply(L, 2 * np.pi * 300.0, X)
    assert _counts("bsr_spmm") == (launches + 1, calls)
    assert L._bsr_plan[2] is plan
    A = L.assemble({})
    scale = np.abs(A.to_dense()) @ np.abs(X.astype(np.complex128))
    err = np.abs(Y - A @ X.astype(np.complex128)) / np.maximum(scale, 1e-300)
    assert err.max() <= 1e-5


def _banded(n, band, seed=0, deg=12):
    rng = np.random.default_rng(seed)
    ii = np.repeat(np.arange(n), deg)
    jj = np.clip(ii + rng.integers(-band, band + 1, len(ii)), 0, n - 1)
    v = rng.standard_normal(len(ii)) + 1j * rng.standard_normal(len(ii))
    A = sp.csr_matrix((v, (ii, jj)), shape=(n, n))
    A.sum_duplicates()
    return A


def _check_window(op, Xd, outs):
    """Every output of ``outs`` (launches on Xd) row-wise within 1e-6 of
    the plain version (float32 sums in another order), all the same
    bits."""
    torch.cuda.synchronize()
    ref = window_spmm_ref(op.indptr, op.cols, op.vals, Xd)
    scale = window_spmm_ref(op.indptr, op.cols,
                            op.vals.abs().to(torch.complex64),
                            Xd.abs().to(torch.complex64)).real
    for Y in outs:
        assert torch.equal(Y, outs[0])
        assert ((Y - ref).abs() / scale.clamp_min(1e-30)).max().item() <= 1e-6


@pytest.mark.parametrize("r", [128, 16, 260])
def test_window_spmm_matches_twin(cuda, r):
    """The CSR SpMM kernel (K4/K5) against its plain version on the card on
    a banded operator whose band exceeds the ring (so some nonzeros are
    read from global memory), on REPEATS launches; r = 260 ends on a ragged
    column chunk."""
    A = _banded(2500, 800)
    op = WindowSpmm.from_csr(A, nrhs=r, device=cuda)
    assert op.launch_plan(r).out_of_window > 0
    Xd = op.panel(random_panel(2500, r, seed=r))
    launches, calls = _counts("window_spmm")
    outs = [op.apply(Xd) for _ in range(REPEATS)]
    assert _counts("window_spmm") == \
        (launches + REPEATS, calls)
    _check_window(op, Xd, outs)


def _wide_band():
    """Identity plus the two far corners (the operator the JAX K4 refuses,
    tests/test_window_spmm.py:39-49)."""
    n = 4096
    A = sp.csr_matrix((np.ones(2), ([0, n - 1], [n - 1, 0])), shape=(n, n))
    return (A + sp.eye(n)).tocsr().astype(np.complex128)


def _octosplit_2996():
    """The reordered 2,996-DOF octosplit passive family at 2π·300."""
    L = large_operator_family(n_rings=2, nz_cold=10, nz_hot=10)
    L.params[L.eigval] = 2 * np.pi * 300.0
    A = L.assemble({})
    Ar = permute_csr(A, cuthill_mckee(A))
    return sp.csr_matrix((Ar.data, Ar.indices, Ar.indptr), shape=Ar.shape)


@pytest.mark.parametrize("name", ["wide-band", "octosplit-2996"])
def test_window_spmm_operators(cuda, name):
    """The kernel on REPEATS launches at r = 128 on the wide-band operator
    (its two corners outside every ring window, read from global memory)
    and on the reordered 2,996-DOF octosplit operator (every nonzero in
    its window)."""
    A = _wide_band() if name == "wide-band" else _octosplit_2996()
    op = WindowSpmm.from_csr(A, nrhs=128, device=cuda)
    assert op.launch_plan(128).out_of_window == (2 if name == "wide-band"
                                                 else 0)
    Xd = op.panel(random_panel(A.shape[0], 128, seed=8))
    _check_window(op, Xd, [op.apply(Xd) for _ in range(REPEATS)])


@pytest.mark.parametrize("name", ["banded-2500", "octosplit-2996"])
def test_window_spmm_plan_of_fewer_sms(cuda, name):
    """The launch plan of an H100 PCIe's 114 SMs (14 ranges at r = 128),
    run on this card, on REPEATS launches."""
    A = _banded(2500, 800) if name == "banded-2500" else _octosplit_2996()
    op = WindowSpmm.from_csr(A, nrhs=128, device=cuda)
    lp = op.launch_plan(128, n_sm=114)
    assert lp.blocks <= 114
    Xd = op.panel(random_panel(A.shape[0], 128, seed=9))
    lib = window_build()["lib"]
    _check_window(op, Xd, [window_launch(lib, op.vals, Xd, lp)
                           for _ in range(REPEATS)])


def test_window_spmm_refuses(cuda):
    """The wrapper raises on a CPU/CUDA mix, on a width the kernel does
    not take, without a launch plan, on another width's plan and on the
    plan of another operator of the same size, and launches nothing."""
    A = _banded(300, 40)
    op = WindowSpmm.from_csr(A, device=cuda)
    twin = WindowSpmm.from_csr(A, device=cuda)
    launches = timing.total("window_spmm.launches")
    X = random_panel(300, 8)
    with pytest.raises(ValueError):
        window_spmm(op.indptr, op.cols, op.vals, torch.from_numpy(X))
    with pytest.raises(ValueError):
        window_spmm(op.indptr.cpu(), op.cols, op.vals, op.panel(X))
    with pytest.raises(ValueError, match="multiple"):
        window_spmm(op.indptr, op.cols, op.vals, op.panel(X[:, :6]))
    with pytest.raises(ValueError, match="launch plan"):
        window_spmm(op.indptr, op.cols, op.vals, op.panel(X))
    for other in (op.launch_plan(16), twin.launch_plan(128)):
        with pytest.raises(ValueError, match="launch plan"):
            window_spmm(op.indptr, op.cols, op.vals, op.panel(X), other)
    assert timing.total("window_spmm.launches") == launches


def test_operator_apply_window_on_card(cuda):
    """The entry point with kernel="window" on a small octosplit family
    (2,996 DOF): one launch and no plain call per apply, the plan reused
    across z, and Y row-wise within 1e-5 and globally within 5e-5 of the
    complex128 scipy product."""
    L = large_operator_family(n_rings=2, nz_cold=10, nz_hot=10)
    X = random_panel(L.size, 128, seed=6)
    operator_apply(L, Z0, X, kernel="window")
    plan = L._window_plan[2]
    launches, calls = _counts("window_spmm")
    Y = operator_apply(L, 2 * np.pi * 300.0, X, kernel="window")
    assert _counts("window_spmm") == \
        (launches + 1, calls)
    assert L._window_plan[2] is plan
    A = L.assemble({})
    As = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
    ref = As @ X.astype(np.complex128)
    scale = abs(As) @ np.abs(X).astype(np.float64)
    assert (np.abs(Y - ref) / np.maximum(scale, 1e-300)).max() <= 1e-5
    assert np.linalg.norm(Y - ref) / np.linalg.norm(ref) < 5e-5


def test_slab_solver_on_card_matches_cpu(cuda):
    """The contour's slab direct solver on the card (complex64
    factorization and re-solves, complex128 host refinement) on the
    437-DOF passive family: max relres < 1e-10 and every shift within 1e-8
    relative of the same solver on the CPU (test_torch_contour.py)."""
    from wavesandeigenvalues_jl_tpu_torch.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        passive_rijke_setup
    mesh = rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
    L = discretize(mesh, *passive_rijke_setup(mesh))
    zs = 2 * np.pi * np.array([250 + 5j, 400 - 5j, 600 + 5j])
    rng = np.random.default_rng(0)
    V = (rng.standard_normal((L.size, 3))
         + 1j * rng.standard_normal((L.size, 3)))
    X, info = SlabSolver(L, chunk=4, device=cuda).solve(zs, V)
    Xc, info_c = SlabSolver(L, chunk=4, device="cpu").solve(zs, V)
    assert info["max_relres"] < 1e-10
    assert info["timings"]["factor_steps"] == info_c["timings"]["factor_steps"]
    for j in range(len(zs)):
        assert np.linalg.norm(X[j] - Xc[j]) / np.linalg.norm(Xc[j]) < 1e-8, j


def _penalty_system(n=96):
    """The penalty system of tests/test_device_backend.py:18-28."""
    rng = np.random.default_rng(0)
    A = (np.eye(n) * 4 + 0.3 * rng.standard_normal((n, n))
         + 0.1j * rng.standard_normal((n, n)))
    A[0] *= 1e12
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return A, b


@pytest.mark.parametrize("kind", ["lu", "gmres"])
def test_device_solve_on_card_matches_cpu(cuda, kind):
    """``DeviceLU`` (complex128 LU on the card) and ``DeviceGMRES`` on the
    penalty system, every transpose and a 3-column panel: within 1e-10 of
    their CPU twins and 1e-8 of the direct solve (the JAX test's bar);
    the LU's factors lie on the card in complex128."""
    from wavesandeigenvalues_jl_tpu_torch.ops.device_solve import (
        DeviceGMRES, DeviceLU)
    A, b = _penalty_system()
    B = np.stack([b, 2 * b, 1j * b], axis=1)
    make = ((lambda dev: DeviceLU(CSR.from_dense(A), device=dev))
            if kind == "lu" else
            (lambda dev: DeviceGMRES(CSR.from_dense(A), bs=16, tol=1e-10,
                                     device=dev)))
    F, Fc = make(cuda), make("cpu")
    if kind == "lu":
        assert F._fac[0].device.type == "cuda"
        assert F._fac[0].dtype == torch.complex128
    for trans, M in (("N", A), ("T", A.T), ("H", A.conj().T)):
        for rhs in (b, B):
            x, xc = F.solve(rhs, trans), Fc.solve(rhs, trans)
            ref = np.linalg.solve(M, rhs)
            assert np.linalg.norm(x - ref) / np.linalg.norm(ref) < 1e-8
            assert np.linalg.norm(x - xc) / np.linalg.norm(xc) < 1e-10


def test_householder_order3_on_card(cuda):
    """The general engine on the card: householder(order=3) on the 437-DOF
    active family through DeviceLU in complex128 gives flag 0 in 4
    iterations (as JAX host) and ω within 1e-10·|ω| of OMEGA_437 (JAX host
    mslp; JAX host householder(order=3) is 5e-14·|ω| from it)."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp import householder
    sol, n_it, flag = householder(active_rijke_family(), Z0, maxiter=12,
                                  tol=1e-9, order=3, device=cuda)
    om = sol.params[sol.eigval]
    assert (flag, n_it) == (0, 4)
    assert abs(om - OMEGA_437) <= 1e-10 * abs(OMEGA_437)


#: the benchmark's 7,259-DOF configuration (cell ``rijke7259.mslp_map``)
RIJKE_7259 = os.path.join(os.path.dirname(__file__), "..", "portbench",
                          "configs", "rijke_tube_7259.json")


def _polish_loop(L, z, v, w, device, tol):
    """The fused engine's polish loop (``nlevp/fused_local.py``) from
    (z, v, w): (z, v, w, converged, steps)."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp.polish import polish_step
    for steps in range(1, 4):
        dz, _, vh, wh = polish_step(L, z, v, w, device)
        if not (np.isfinite(dz) and abs(dz) < 1e-2 * max(abs(z), 1.0)):
            return z, v, w, False, steps
        z, v, w = z + dz, vh, wh
        if abs(dz) <= tol:
            return z, v, w, True, steps
    return z, v, w, False, 3


def _residuals(L, om, v, w):
    """‖L(ω)v‖/‖v‖ and ‖L(ω)ᴴw‖/‖w‖."""
    A = L(om)
    return (np.linalg.norm(A @ v) / np.linalg.norm(v),
            np.linalg.norm(A.conj_transpose() @ w) / np.linalg.norm(w))


def _polish_on_device_and_host(L, device, z0=Z0, tol=1e-11, maxiter=20):
    """One mslp on ``device`` (device polish), the device iterate its
    polish started from, and the polish loop run again from that iterate
    factored on ``device`` and on the host.  Returns (mslp's flag and ω,
    {side: (ω, v, w, converged, steps, counts of ``polish.factor``)})."""
    import wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local as fused_local
    from wavesandeigenvalues_jl_tpu_torch.nlevp import polish
    first = {}
    real = fused_local.polish_step

    def recording(L_, z, v, w, dev):
        first.setdefault("it", (z, v.copy(), w.copy()))
        return real(L_, z, v, w, dev)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(fused_local, "polish_step", recording)
        sol, _, flag = mslp(L, z0, maxiter=maxiter, tol=tol, device=device)
        mp.undo()
        out = {}
        for side, cap in (("device", polish.POLISH_DEVICE_MAX_DIM),
                          ("host", 0)):
            mp.setattr(polish, "POLISH_DEVICE_MAX_DIM", cap)
            timing.reset()
            out[side] = (_polish_loop(L, *first["it"], device, tol)
                         + (timing.counts("polish.factor"),))
            mp.undo()
    finally:
        mp.undo()
    return (flag, sol.params[sol.eigval]), out


def test_polish_on_card_matches_host_at_7259(cuda):
    """The polish at 7,259 DOF (the benchmark's configuration, slab
    engine): from the device iterate of one mslp, factored on the card
    (complex128 LU, one ``lu_solve`` an Arnoldi step) and on the host
    (SuperLU), the polish converges in as many steps to ω within 1e-11
    relative, each factor counted under its key, and both eigenvectors'
    residuals ‖L(ω)v‖/‖v‖ lie within 10× of the host's.  The mslp itself
    (device polish) ends with flag 0 at the same ω."""
    import json
    from portbench.problems import rijke_tube
    with open(RIJKE_7259) as f:
        cfg = json.load(f)
    L = rijke_tube.port_family(rijke_tube.mesh(cfg), cfg)
    assert L.size == cfg["dof"] == 7259
    (flag, om), out = _polish_on_device_and_host(L, cuda)
    om_d, v_d, w_d, conv_d, steps_d, counts_d = out["device"]
    om_h, v_h, w_h, conv_h, steps_h, counts_h = out["host"]
    assert flag == 0 and conv_d and conv_h and steps_d == steps_h
    assert counts_d == {"device": steps_d} and counts_h == {"host": steps_h}
    assert abs(om_d - om_h) <= 1e-11 * abs(om_h)
    assert abs(om - om_h) <= 1e-11 * abs(om_h)
    for r_d, r_h in zip(_residuals(L, om_d, v_d, w_d),
                        _residuals(L, om_h, v_h, w_h)):
        assert r_d <= 10 * r_h, (r_d, r_h)
