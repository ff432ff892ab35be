"""The port's operator apply (ops/reorder, ops/device.BsrOperator,
ops/bsr_spmm: kernel K1 and its packed layout) against the JAX package on
the 437-DOF active Rijke operator, on the CPU, where the K1 wrapper runs
its plain PyTorch version."""
import numpy as np
import pytest
import torch

import wavesandeigenvalues_jl_tpu.native as native_jax
from wavesandeigenvalues_jl_tpu.ops.device import BsrOperator as BsrJax
from wavesandeigenvalues_jl_tpu.ops.pallas_spmv import (PallasBsrSpmm,
                                                        bsr_spmm_xla)
from wavesandeigenvalues_jl_tpu.ops.reorder import bandwidth as bandwidth_jax
from wavesandeigenvalues_jl_tpu.ops.reorder import \
    cuthill_mckee as cuthill_mckee_jax
from wavesandeigenvalues_jl_tpu.ops.reorder import \
    permute_csr as permute_csr_jax
from wavesandeigenvalues_jl_tpu.ops.sparse import CSR as CSRJax
from wavesandeigenvalues_jl_tpu_torch import native as native_port
from wavesandeigenvalues_jl_tpu_torch.models.rijke import active_rijke_family
from wavesandeigenvalues_jl_tpu_torch.ops.bsr_spmm import (
    ApplyPlan, BsrSpmm, bsr_spmm, bsr_spmm_packed_ref, bsr_spmm_ref,
    operator_apply, pack, random_panel, unpack)
from wavesandeigenvalues_jl_tpu_torch.ops.device import BsrOperator
from wavesandeigenvalues_jl_tpu_torch.ops.reorder import (
    bandwidth, cuthill_mckee, cuthill_mckee_numpy, permute_csr)
from wavesandeigenvalues_jl_tpu_torch.utils import timing

from port_threads import one_thread  # noqa: F401


def _counts(kernel):
    """(launches, plain calls) of a kernel wrapper so far."""
    return (timing.total(f"{kernel}.launches"),
            timing.total(f"{kernel}.twin_calls"))


OMEGA = 2 * np.pi * 300.0


@pytest.fixture(scope="module")
def operator():
    """(port CSR, the same CSR in the JAX package's container) of the
    437-DOF family at ω = 2π·300."""
    L = active_rijke_family()
    L.params[L.eigval] = OMEGA
    A = L.assemble({})
    return A, CSRJax(A.indptr, A.indices, A.data, A.shape)


def _rowwise(Y, Yref, A, X):
    """max over entries of |Y − Y_ref| / (|A|·|X|): the penalty rows
    (Y = 1e15 admittance) would swamp a global norm."""
    scale = np.abs(A.to_dense()) @ np.abs(X.astype(np.complex128))
    return float((np.abs(Y - Yref) / np.maximum(scale, 1e-300)).max())


def test_cuthill_mckee_equals_jax_numpy_path(operator, monkeypatch):
    """Same permutation as the JAX numpy/deque path, both orders, and the
    same bandwidths: both packages' native C++ BFS switched off (the
    port's numpy twin in its place; test_torch_native.py holds the two
    native routes against each other)."""
    A, Aj = operator
    monkeypatch.setattr(native_jax, "rcm", lambda indptr, indices: None)
    monkeypatch.setattr(native_port, "rcm",
                        lambda indptr, nbrs: cuthill_mckee_numpy(indptr,
                                                                 nbrs))
    for reverse in (True, False):
        perm = cuthill_mckee(A, reverse=reverse)
        np.testing.assert_array_equal(perm,
                                      cuthill_mckee_jax(Aj, reverse=reverse))
    Ar, Arj = permute_csr(A, perm), permute_csr_jax(Aj, perm)
    np.testing.assert_array_equal(Ar.indptr, Arj.indptr)
    np.testing.assert_array_equal(Ar.indices, Arj.indices)
    np.testing.assert_array_equal(Ar.data, Arj.data)
    assert bandwidth(A) == bandwidth_jax(Aj)
    assert bandwidth(Ar) == bandwidth_jax(Arj) < bandwidth(A)


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_bsr_from_csr_equals_jax(operator, bs):
    A, Aj = operator
    perm = cuthill_mckee(A)
    b, bj = (BsrOperator.from_csr(permute_csr(A, perm), bs=bs),
             BsrJax.from_csr(permute_csr_jax(Aj, perm), bs=bs))
    np.testing.assert_array_equal(b.blocks, bj.blocks)
    np.testing.assert_array_equal(b.block_cols, bj.block_cols)
    np.testing.assert_array_equal(b.block_mask, bj.block_mask)
    assert (b.bs, b.n, b.fill_ratio) == (bj.bs, bj.n, bj.fill_ratio)
    x = random_panel(A.shape[0], 1, seed=bs)[:, 0].astype(np.complex128)
    np.testing.assert_array_equal(b.matvec_reference(x),
                                  bj.matvec_reference(x))


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_ref_matches_jax_xla_and_pallas(operator, bs):
    """bsr_spmm_ref against bsr_spmm_xla (r = 128), and at bs = 32 also
    against the Pallas kernel in interpret mode (r = 8), row-wise to 1e-6
    (complex64 sums in another order)."""
    A, Aj = operator
    perm = cuthill_mckee(A)
    Ar = permute_csr(A, perm)
    b = BsrOperator.from_csr(Ar, bs=bs)
    bj = BsrJax.from_csr(permute_csr_jax(Aj, perm), bs=bs)
    blocks = torch.from_numpy(b.blocks.astype(np.complex64))
    cols = torch.from_numpy(b.block_cols)
    n = A.shape[0]
    for r, jax_apply in [(128, bsr_spmm_xla(bj))] + (
            [(8, PallasBsrSpmm(bj, nrhs=8, interpret=True))] if bs == 32
            else []):
        X = random_panel(n, r, seed=r)
        Xp = np.zeros((b.n, r), np.complex64)
        Xp[:n] = X
        Y = bsr_spmm_ref(blocks, cols, torch.from_numpy(Xp).view(-1, bs, r))
        Y = Y.reshape(-1, r)[:n].numpy()
        assert _rowwise(Y, np.asarray(jax_apply(X)), Ar, X) <= 1e-6


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_packed_ref_matches_dense_ref_and_jax(operator, bs):
    """The plain version of the packed layout against bsr_spmm_ref on the
    dense blocks and bsr_spmm_xla (r = 128), and against the Pallas kernel
    in interpret mode (r = 8), row-wise to 1e-6 (complex64 sums in another
    order)."""
    A, Aj = operator
    perm = cuthill_mckee(A)
    Ar = permute_csr(A, perm)
    b = BsrOperator.from_csr(Ar, bs=bs)
    bj = BsrJax.from_csr(permute_csr_jax(Aj, perm), bs=bs)
    n = A.shape[0]
    for r, jax_apply in [(128, bsr_spmm_xla(bj)),
                         (8, PallasBsrSpmm(bj, nrhs=8, interpret=True))]:
        op = BsrSpmm(b, "cpu", nrhs=r)
        X = random_panel(n, r, seed=r)
        Xp = op.panel(X)
        Y = bsr_spmm_packed_ref(op.row_ptr, op.lcol, op.vals, op.block_cols,
                                Xp)
        Yd = bsr_spmm_ref(torch.from_numpy(b.blocks.astype(np.complex64)),
                          op.block_cols, Xp)
        Y, Yd = (y.reshape(-1, r)[:n].numpy() for y in (Y, Yd))
        assert _rowwise(Y, Yd, Ar, X) <= 1e-6
        assert _rowwise(Y, np.asarray(jax_apply(X)), Ar, X) <= 1e-6


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_pack_round_trips(operator, bs):
    """Unpacking the packed layout gives BsrOperator.blocks exactly; every
    row's local columns ascend and stay in the block row's real slots;
    a nonzero in a padding slot is refused."""
    A, _ = operator
    b = BsrOperator.from_csr(permute_csr(A, cuthill_mckee(A)), bs=bs)
    packed = pack(b)
    maxb = b.block_cols.shape[1]
    np.testing.assert_array_equal(unpack(*packed, maxb, bs), b.blocks)
    assert len(packed.vals) == np.count_nonzero(b.blocks)
    assert packed.row_ptr[-1] == len(packed.lcol)
    rows = np.repeat(np.arange(b.n), np.diff(packed.row_ptr))
    same = rows[1:] == rows[:-1]
    assert np.all(np.diff(packed.lcol)[same] > 0)
    op = BsrSpmm(b, "cpu")
    np.testing.assert_array_equal(
        unpack(op.row_ptr, op.lcol, op.vals, maxb, bs),
        b.blocks.astype(np.complex64))
    full = b.block_mask.all(axis=1)
    if not full.all():
        br = int(np.flatnonzero(~full)[0])
        k = int(b.block_mask[br].sum())
        bad = BsrOperator(b.blocks.copy(), b.block_cols, b.block_mask, bs,
                          b.n)
        bad.blocks[br, k, 0, 0] = 1.0
        with pytest.raises(ValueError, match="padding"):
            pack(bad)


def test_apply_plan_load_writes_the_blocks_values(operator):
    """ApplyPlan.load writes, into the packed layout, the values the dense
    blocks of the permuted operator hold (complex64)."""
    A, _ = operator
    L = active_rijke_family()
    plan = ApplyPlan(L._stack(), 64, "cpu", 32)
    L.params[L.eigval] = OMEGA
    plan.load(L.assemble({}).data)
    b = BsrOperator.from_csr(permute_csr(A, plan.perm), bs=64)
    op = plan.op
    np.testing.assert_array_equal(
        unpack(op.row_ptr, op.lcol, op.vals, op.maxb, op.bs),
        b.blocks.astype(np.complex64))


def test_wrapper_on_cpu_counts_twin_calls(operator):
    A, _ = operator
    op = BsrSpmm(BsrOperator.from_csr(A, bs=64), "cpu", nrhs=16)
    launches, calls = _counts("bsr_spmm")
    X = random_panel(A.shape[0], 16)
    Y = op(X)
    assert _counts("bsr_spmm") == (launches, calls + 1)
    assert Y.shape == X.shape and Y.dtype == np.complex64
    with pytest.raises(TypeError):
        bsr_spmm(op.row_ptr, op.lcol, op.vals.to(torch.complex128),
                 op.block_cols, op.panel(X))
    with pytest.raises(TypeError):
        bsr_spmm(op.row_ptr, op.lcol.long(), op.vals, op.block_cols,
                 op.panel(X))
    with pytest.raises(ValueError):
        bsr_spmm(op.row_ptr, op.lcol, op.vals, op.block_cols,
                 op.panel(X)[:, :32])


@pytest.mark.parametrize("bs", [32, 128])
def test_operator_apply_matches_host_csr(operator, bs):
    """The entry point on the CPU: Y = L(ω)·X in the original ordering,
    row-wise within 1e-6 of the complex128 host CSR product."""
    A, _ = operator
    L = active_rijke_family()
    X = random_panel(A.shape[0], 128, seed=7)
    Y = operator_apply(L, OMEGA, X, bs=bs, device="cpu")
    assert Y.shape == X.shape and Y.dtype == np.complex64
    assert _rowwise(Y, A @ X.astype(np.complex128), A, X) <= 1e-6


def test_operator_apply_reuses_plan(operator):
    """The ordering and block structure are built once per family, bs and
    panel width: a second call at another z reuses them, writes the new
    values and still agrees with the host CSR product row-wise to 1e-6; a
    new bs builds a new plan."""
    A, _ = operator
    L = active_rijke_family()
    X = random_panel(A.shape[0], 32, seed=3)
    operator_apply(L, 340 * 2 * np.pi, X, bs=64, device="cpu")
    plan = L._bsr_plan[2]
    Y = operator_apply(L, OMEGA, X, bs=64, device="cpu")
    assert L._bsr_plan[2] is plan
    assert _rowwise(Y, A @ X.astype(np.complex128), A, X) <= 1e-6
    operator_apply(L, OMEGA, X, bs=32, device="cpu")
    assert L._bsr_plan[2] is not plan
