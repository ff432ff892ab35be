"""Kernel K2 of the port (ops/dense_gmres.py) against the JAX package's
Pallas dense GMRES (interpret mode) on the CPU, where the wrapper runs its
plain PyTorch version; and the block-Jacobi inverses it is fed with."""
import numpy as np
import pytest
import torch

from wavesandeigenvalues_jl_tpu.ops.gmres import \
    BatchedBlockDiagInv as BatchedBlockDiagInvJax
from wavesandeigenvalues_jl_tpu.ops.pallas_gmres import build_dense_gmres
from wavesandeigenvalues_jl_tpu_torch.models.rijke import active_rijke_family
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local import (
    FUSED_MAX_DIM, GMRES_M)
from wavesandeigenvalues_jl_tpu_torch.ops.dense_gmres import (
    N_MAX, SMEM_MAX, dense_gmres, dense_gmres_ref, plan)
from wavesandeigenvalues_jl_tpu_torch.ops.gmres import (BatchedBlockDiagInv,
                                                        gmres_test_problem)
from wavesandeigenvalues_jl_tpu_torch.utils import timing

from port_threads import one_thread  # noqa: F401


def _counts(kernel):
    """(launches, plain calls) of a kernel wrapper so far."""
    return (timing.total(f"{kernel}.launches"),
            timing.total(f"{kernel}.twin_calls"))



def test_ref_matches_pallas_interpret():
    """(sides, N, m, cycles) = (2, 256, 30, 2): x agrees with the Pallas
    kernel to 1e-5 relative (float32 sums in another order), and each
    side's true residual ‖G x − b‖/‖b‖ is ≤ 5e-6 (test_pallas_gmres.py:49)."""
    N, m, cycles = 256, 30, 2
    P, b0, Gs, b = gmres_test_problem(N)
    f = build_dense_gmres(N, m, cycles=cycles, sides=2, interpret=True)
    xr, xi = f(np.ascontiguousarray(P.real), np.ascontiguousarray(P.imag),
               np.ascontiguousarray(b0.real), np.ascontiguousarray(b0.imag))
    xj = np.asarray(xr) + 1j * np.asarray(xi)
    xt = dense_gmres_ref(torch.from_numpy(P), torch.from_numpy(b0), m,
                         cycles).numpy()
    for s in range(2):
        rel = np.linalg.norm(xt[s] - xj[s]) / np.linalg.norm(xj[s])
        assert rel <= 1e-5, f"side {s}: port vs JAX {rel:.3e}"
        res = np.linalg.norm(Gs[s] @ xt[s] - b) / np.linalg.norm(b)
        assert res <= 5e-6, f"side {s}: relres {res:.3e}"


def test_wrapper_on_cpu_runs_plain_version():
    P, b0, _, _ = gmres_test_problem(128, seed=1)
    P, b0 = torch.from_numpy(P), torch.from_numpy(b0)
    launches, calls = _counts("dense_gmres")
    x = dense_gmres(P, b0, 10, 1)
    assert _counts("dense_gmres") == \
        (launches, calls + 1)
    torch.testing.assert_close(x, dense_gmres_ref(P, b0, 10, 1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("sides,N", [(3, 128), (1, N_MAX + 128)])
def test_wrapper_on_cpu_takes_what_the_kernel_refuses(sides, N):
    """The kernel's limits (sides 1 or 2, N up to N_MAX) are not the plain
    version's: on CPU tensors the wrapper runs it at any sides and N."""
    rng = np.random.default_rng(N + sides)
    P = (np.eye(N) + 0.1 * (rng.standard_normal((sides, N, N)) + 1j
                            * rng.standard_normal((sides, N, N))) / np.sqrt(N))
    b = rng.standard_normal((sides, N)) + 1j * rng.standard_normal((sides, N))
    P = torch.from_numpy(P.astype(np.complex64))
    b = torch.from_numpy(b.astype(np.complex64))
    calls = timing.total("dense_gmres.twin_calls")
    x = dense_gmres(P, b, 4, 1)
    assert timing.total("dense_gmres.twin_calls") == calls + 1
    torch.testing.assert_close(x, dense_gmres_ref(P, b, 4, 1), rtol=0,
                               atol=0)


@pytest.mark.parametrize("case", ["dtype", "rank", "square", "lane",
                                  "contiguous", "m"])
def test_wrapper_rejects_bad_input(case):
    P = torch.zeros(2, 128, 128, dtype=torch.complex64)
    b = torch.zeros(2, 128, dtype=torch.complex64)
    m = 10
    if case == "dtype":
        P = P.to(torch.complex128)
    elif case == "rank":
        b = b[0]
    elif case == "square":
        P = torch.zeros(2, 128, 256, dtype=torch.complex64)
    elif case == "lane":
        P, b = P[:, :100, :100].contiguous(), b[:, :100].contiguous()
    elif case == "contiguous":
        P = torch.zeros(2, 128, 256, dtype=torch.complex64)[:, :, ::2]
    elif case == "m":
        m = 0
    with pytest.raises((TypeError, ValueError)):
        dense_gmres(P, b, m, 1)


@pytest.mark.parametrize("n_sm", [114, 132])
@pytest.mark.parametrize("sides", [1, 2])
@pytest.mark.parametrize("N", range(128, N_MAX + 1, 128))
def test_launch_plan(sides, N, n_sm):
    """K2's launch on an H100 SXM (132 SMs) and PCIe (114 SMs) at the
    caller's m: every row of P owned by exactly one row block, a block's
    resident and streamed rows adding up to its rows, the shared memory
    within a block's 232,448 bytes, and every block co-resident."""
    pl = plan(sides, N, GMRES_M, n_sm)
    owners = np.zeros(N, np.int64)
    for g in range(pl.G):
        rows = pl.rows(g)
        assert len(rows) >= 1
        owners[rows.start:rows.stop] += 1
        assert pl.resident(g) + pl.streamed(g) == len(rows)
        assert pl.resident(g) >= 1 and pl.streamed(g) >= 0
    assert (owners == 1).all()
    assert pl.smem <= SMEM_MAX
    assert pl.grid <= n_sm


def test_launch_plan_main_path():
    """At the main path's (2, 1408, 80): 64 row blocks of 22 rows a side on
    128 of 132 SMs, 18 rows resident and 4 streamed; on 114 SMs, 55 blocks
    of 26 rows, 17 resident and 9 streamed (more than one a warp)."""
    assert -(-FUSED_MAX_DIM // 128) * 128 == N_MAX
    pl = plan(2, N_MAX, GMRES_M, 132)
    assert (pl.G, pl.R, pl.res, pl.grid) == (64, 22, 18, 130)
    assert pl.smem == 231152
    pl = plan(2, N_MAX, GMRES_M, 114)
    assert (pl.G, pl.R, pl.res, pl.grid) == (55, 26, 17, 112)
    assert pl.streamed(0) == 9


def test_batched_block_diag_inv_equals_jax():
    """Bit for bit on the 437-DOF union pattern at N = 512, both sides."""
    L = active_rijke_family()
    S = L._stack()
    rows = np.asarray(S.row_ids(), np.int64)
    cols = np.asarray(S.indices, np.int64)
    L.params["ω"] = 340 * 2 * np.pi
    data = L.coefficients({}) @ S.values
    perm = np.lexsort((rows, cols))
    for r, c, d in ((rows, cols, data), (cols[perm], rows[perm],
                                         np.conj(data[perm]))):
        port = BatchedBlockDiagInv(r, c, 512, 128)
        ref = BatchedBlockDiagInvJax(r, c, 512, 128)
        assert port.unique == ref.unique
        np.testing.assert_array_equal(port.inv(d[None]), ref.inv(d[None]))
