"""The port's host utilities against the JAX package on the CPU: the
native C++ library (native/, built from csrc/host_kernels.cpp) wired into
Cuthill–McKee, the assembly's duplicate summing and the slab solver's
residuals; and the phase report and device trace of utils/timing.

ROADMAP.md Queue 3 F8: the port's Cuthill–McKee took the numpy BFS where
the JAX package takes its native one, and the two order equal-degree
neighbours differently.  ``test_rcm_equals_jax_native`` holds the routes
that run in each package against each other."""
import glob
import json
import os

import numpy as np
import pytest
import torch

import wavesandeigenvalues_jl_tpu.native as native_jax
from wavesandeigenvalues_jl_tpu.ops.reorder import \
    cuthill_mckee as cuthill_mckee_jax
from wavesandeigenvalues_jl_tpu.ops.sparse import CSR as CSRJax
from wavesandeigenvalues_jl_tpu.ops.sparse import \
    coo_sum_duplicates as coo_sum_duplicates_jax
from wavesandeigenvalues_jl_tpu_torch import native
from wavesandeigenvalues_jl_tpu_torch.models.rijke import active_rijke_family
from wavesandeigenvalues_jl_tpu_torch.ops import reorder
from wavesandeigenvalues_jl_tpu_torch.ops.reorder import (
    adjacency_from_csr, bandwidth, cuthill_mckee, cuthill_mckee_numpy,
    permute_csr)
from wavesandeigenvalues_jl_tpu_torch.ops.sparse import (
    CSR, NATIVE_DEDUP_MIN, coo_sum_duplicates, coo_sum_duplicates_numpy)
from wavesandeigenvalues_jl_tpu_torch.utils import timing

from port_threads import one_thread  # noqa: F401

#: the F8 patterns: the active Rijke family's P1 operator at 437, 1,369
#: and 3,843 DOF
RIJKE_SIZES = [(2, 10, 10), (3, 17, 17), (4, 30, 30)]


def _random_csr(n=400, density=0.01, seed=0):
    rng = np.random.default_rng(seed)
    m = int(n * n * density)
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    v = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    d = np.arange(n)
    return CSR.from_coo(np.concatenate([r, d]), np.concatenate([c, d]),
                        np.concatenate([v, np.ones(n) + 0j]), (n, n))


def _jax_csr(A):
    return CSRJax(A.indptr, A.indices, A.data, A.shape)


@pytest.fixture(scope="module")
def rijke_operators():
    out = {}
    for args in RIJKE_SIZES:
        L = active_rijke_family(*args)
        L.params[L.eigval] = 2 * np.pi * 300
        out[args] = L.assemble({})
    return out


@pytest.mark.parametrize("args", RIJKE_SIZES)
def test_rcm_equals_jax_native(rijke_operators, args):
    """F8: the port's cuthill_mckee (native reverse Cuthill–McKee) is the
    JAX package's permutation, where both take their native library; the
    numpy BFS the port took before gives another one."""
    assert native_jax.available()
    A = rijke_operators[args]
    perm = cuthill_mckee(A)
    np.testing.assert_array_equal(perm, cuthill_mckee_jax(_jax_csr(A)))
    assert sorted(perm) == list(range(A.shape[0]))
    old = cuthill_mckee_numpy(*adjacency_from_csr(A))
    assert not np.array_equal(perm, old)
    assert bandwidth(permute_csr(A, perm)) < bandwidth(A)


def test_numpy_twin_equals_jax_numpy_path(monkeypatch):
    """The port's numpy BFS is the JAX package's fallback, both orders,
    on a random pattern (the JAX native library switched off)."""
    A = _random_csr(seed=9)
    monkeypatch.setattr(native_jax, "rcm", lambda indptr, indices: None)
    for reverse in (True, False):
        np.testing.assert_array_equal(
            cuthill_mckee_numpy(*adjacency_from_csr(A), reverse=reverse),
            cuthill_mckee_jax(_jax_csr(A), reverse=reverse))
    np.testing.assert_array_equal(cuthill_mckee(A, reverse=False),
                                  cuthill_mckee_jax(_jax_csr(A),
                                                    reverse=False))
    monkeypatch.setattr(reorder.native, "rcm",
                        lambda indptr, nbrs: cuthill_mckee_numpy(indptr,
                                                                 nbrs))
    np.testing.assert_array_equal(cuthill_mckee(A),
                                  cuthill_mckee_jax(_jax_csr(A)))


def test_rcm_reduces_bandwidth():
    """tests/test_native.py:43: a scrambled banded pattern recovers a
    small bandwidth, and the random pattern's permutation is JAX's."""
    A = _random_csr()
    np.testing.assert_array_equal(cuthill_mckee(A),
                                  cuthill_mckee_jax(_jax_csr(A)))
    n = A.shape[0]
    rng = np.random.default_rng(2)
    r = np.arange(n - 3).repeat(3)
    c = r + rng.integers(1, 4, len(r))
    v = np.ones(len(r)) + 0j
    B = CSR.from_coo(np.concatenate([r, c, np.arange(n)]),
                     np.concatenate([c, r, np.arange(n)]),
                     np.concatenate([v, v, np.ones(n) + 0j]), (n, n))
    Bs = permute_csr(B, rng.permutation(n))
    assert bandwidth(permute_csr(Bs, cuthill_mckee(Bs))) <= \
        3 * bandwidth(B) + 3


@pytest.mark.parametrize("n_cols", [0, 300])
def test_coo_dedup_matches_numpy_and_jax(n_cols):
    """coo_dedup (generic and packed-key sort; 10⁵ entries take the
    parallel sort) against its numpy twin and the JAX native kernel."""
    rng = np.random.default_rng(1)
    m, n = 150000, 300
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    v = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    v[:50] = 0
    rn, cn, vn = native.coo_dedup(r, c, v, n_cols=n_cols)
    rt, ct, vt = coo_sum_duplicates_numpy(r, c, v, (n, n))
    np.testing.assert_array_equal(rn, rt)
    np.testing.assert_array_equal(cn, ct)
    np.testing.assert_allclose(vn, vt, rtol=0, atol=1e-12)
    for a, b in zip((rn, cn, vn), native_jax.coo_dedup(r, c, v,
                                                       n_cols=n_cols)):
        np.testing.assert_array_equal(a, b)


def test_assembly_dedup_routes_agree():
    """coo_sum_duplicates above the native gate equals the JAX package's
    and the dense sum; below it the numpy twin runs."""
    rng = np.random.default_rng(5)
    m, n = NATIVE_DEDUP_MIN + 17, 200
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    v = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    out, out_j = coo_sum_duplicates(r, c, v, (n, n)), \
        coo_sum_duplicates_jax(r, c, v, (n, n))
    for a, b in zip(out, out_j):
        np.testing.assert_array_equal(a, b)
    D = np.zeros((n, n), np.complex128)
    np.add.at(D, (r, c), v)
    np.testing.assert_allclose(CSR.from_coo(r, c, v, (n, n)).to_dense(), D,
                               rtol=0, atol=1e-12)
    small = coo_sum_duplicates(r[:100], c[:100], v[:100], (n, n))
    for a, b in zip(small, coo_sum_duplicates_numpy(r[:100], c[:100],
                                                    v[:100], (n, n))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_threads", [1, 2])
def test_csr_spmm_matches_numpy_and_jax(n_threads):
    """csr_spmm on a panel and on a vector against the numpy product and
    the JAX native kernel (threads pinned: each row is summed by one
    thread in the same order, so any count gives the same bits)."""
    A = _random_csr(n=250, seed=3)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((250, 7)) + 1j * rng.standard_normal((250, 7))
    Y = native.csr_spmm(A.indptr, A.indices, A.data, X, n_threads)
    np.testing.assert_allclose(Y, A.to_dense() @ X, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(
        Y, native_jax.csr_spmm(A.indptr, A.indices, A.data, X, n_threads))
    y = native.csr_spmm(A.indptr, A.indices, A.data, X[:, 0], n_threads)
    assert y.shape == (250,)
    np.testing.assert_array_equal(y, Y[:, 0])


def test_slab_residual_uses_native_product():
    """The slab solver's exact residual (its product in csr_spmm) equals
    the scipy product on the 437-DOF family."""
    from wavesandeigenvalues_jl_tpu_torch.ops.slab_solve import SlabSolver
    L = active_rijke_family()
    sv = SlabSolver(L, device="cpu")
    zs = np.array([2 * np.pi * 300, 2 * np.pi * (500 + 3j)])
    rng = np.random.default_rng(8)
    b = rng.standard_normal((2, L.size, 3)) + 0j
    P = sv._prep_chunk(sv.coefficients(zs), b)
    X = rng.standard_normal((L.size, 3)) + 1j * rng.standard_normal(
        (L.size, 3))
    for j, z in enumerate(zs):
        L.params[L.eigval] = z
        ref = (b[j] - L.assemble({}) @ X) * P["srow"][j][:, None]
        R = sv._residual(P, j, X)
        np.testing.assert_allclose(R[:L.size], ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
        assert not R[L.size].any()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses raises with its message."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()
    assert glob.glob(str(tmp_path / "build" / "*")) == []


def test_phase_report():
    """tests/test_timing_refine.py:11: nested phases and format_report."""
    timing.reset()
    with timing.phase("outer"):
        with timing.phase("inner"):
            pass
        with timing.phase("inner"):
            pass
    rep = timing.report()
    assert rep["outer"]["calls"] == 1 and rep["outer.inner"]["calls"] == 2
    assert rep["outer"]["total_s"] >= rep["outer.inner"]["total_s"]
    text = timing.format_report()
    assert "outer.inner" in text and "mean [ms]" in text
    timing.reset()
    assert timing.report() == {}
    assert timing.format_report() == "(no phases recorded)"


def test_discretize_records_phase():
    from wavesandeigenvalues_jl_tpu_torch.mesh.generate import box_mesh
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    timing.reset()
    mesh = box_mesh(nx=2, ny=2, nz=2)
    discretize(mesh, {"Interior": ("interior", ())},
               340.0 * np.ones(mesh.n_points))
    rep = timing.report()
    assert rep["helmholtz.discretize"]["calls"] == 1
    assert rep["helmholtz.discretize"]["total_s"] > 0
    timing.reset()


def test_device_trace_writes_chrome_trace(tmp_path):
    """start_device_trace/stop_device_trace on the CPU: a Chrome trace
    JSON in logdir holding the phase's span and the operations run."""
    logdir = str(tmp_path / "trace")
    assert timing.start_device_trace(logdir) == logdir
    with pytest.raises(RuntimeError):
        timing.start_device_trace(logdir)
    with timing.phase("traced"):
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    path = timing.stop_device_trace()
    assert float(x[0, 0]) == 64.0
    assert os.path.dirname(path) == logdir and os.path.exists(path)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "traced" in names and "aten::mm" in names
    with pytest.raises(RuntimeError):
        timing.stop_device_trace()
    timing.reset()
