"""The port's distributed layer across ranks: one 4-rank gloo world
(``parallel.multihost.run_world``: four processes, a FileStore, 60 s
collective timeouts) runs the body below once for the module; each test
asserts one of its results.

Row parts lie two to a rank (P = 8 over 4 ranks, or 4 over the 2 row ranks
of a 2 × 2 (shift × row) mesh), so every halo crosses ranks by
``batch_isend_irecv`` as well as parts within a rank.  The JAX results
(the SpMV/SpMM twins of tests/test_parallel.py over its 8 devices, the
serial references of tests/test_dist_solve.py) are computed here and
passed to the ranks in an npz; the ranks never import jax."""
import os

import numpy as np
import pytest

from wavesandeigenvalues_jl_tpu.nlevp import gallery as gallery_jax
from wavesandeigenvalues_jl_tpu.ops.sparse import CSR as CSRJax
from wavesandeigenvalues_jl_tpu.parallel import dist_spmv as dist_spmv_jax
from wavesandeigenvalues_jl_tpu.parallel import partition as partition_jax
from wavesandeigenvalues_jl_tpu_torch.parallel.multihost import run_world

from port_threads import one_thread  # noqa: F401

#: the body each rank runs (written next to the npz, imported by the ranks)
BODY = '''
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from wavesandeigenvalues_jl_tpu_torch.nlevp import gallery
from wavesandeigenvalues_jl_tpu_torch.ops.sparse import CSR
from wavesandeigenvalues_jl_tpu_torch.parallel import (dist_beyn, dist_solve,
                                                       dist_spmv, multihost,
                                                       partition)
from wavesandeigenvalues_jl_tpu_torch.parallel.dryrun import _dryrun_body


def main(path):
    d = dict(np.load(path))
    out = {"rank": dist.get_rank()}
    row = init_device_mesh("cpu", (4,), mesh_dim_names=("row",))
    for key in ("banded", "unstructured"):
        part = partition.partition_rows(CSR.from_dense(d[key + "_A"]), 8)
        f, shard, unshard = dist_spmv.make_dist_spmv(part, row)
        xs = shard(d[key + "_x"])
        out[key + "_q"] = xs.shape[0]
        out[key + "_hops"] = -(-part.halo // part.m)
        out[key + "_y"] = unshard(f(xs))
        out[key + "_err"] = float(np.abs(out[key + "_y"]
                                         - d[key + "_yjax"]).max())
    part = partition.partition_rows(CSR.from_dense(d["spmm_A"]), 8)
    f, shard, unshard = dist_spmv.make_dist_spmm(part, row)
    out["spmm_Y"] = unshard(f(shard(d["spmm_X"])))
    out["spmm_err"] = float(np.abs(out["spmm_Y"] - d["spmm_Yjax"]).max())
    k = dist.get_rank()
    x, y = (torch.from_numpy(d[v].reshape(8, 13)[2 * k:2 * k + 2])
            for v in ("dot_x", "dot_y"))
    out["dot"] = complex(dist_spmv.dist_dot(x, y, row))

    grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("shift", "row"))
    L, _ = gallery.rijke_tube(96)
    out["node_X"], out["node_res"] = dist_solve.dist_beyn_node_solve(
        L, d["zs"], d["V"], grid, n_row_parts=4, bs=8, tol=1e-12)
    out["Om"], _, out["beyn_info"] = dist_beyn.beyn_dist(
        L, list(d["Gamma"]), grid, n_row_parts=4, l=5, N=16, rtol=1e-12,
        bs=8, tol=1e-12, return_info=True)
    out["pod"] = multihost.pod_spec_check(4, n_host=2)
    out["dryrun"] = _dryrun_body()
    return out
'''


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
    """tests/test_parallel.py:45."""
    rng = np.random.default_rng(3)
    n = 190
    A = np.zeros((n, n), complex)
    for i in range(n):
        for j in rng.choice(n, 4):
            A[i, j] = rng.standard_normal() + 1j * rng.standard_normal()
        A[i, i] += 1.0
    return A, rng


def _jax_apply(A, X, spmm=False):
    import jax
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()), ("row",))
    part = partition_jax.partition_rows(CSRJax.from_dense(A), 8)
    make = dist_spmv_jax.make_dist_spmm if spmm else \
        dist_spmv_jax.make_dist_spmv
    f, shard, unshard = make(part, mesh)
    return unshard(f(shard(X)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    d = {}
    d["banded_A"] = banded_matrix(257)
    rng = np.random.default_rng(1)
    d["banded_x"] = rng.standard_normal(257) + 1j * rng.standard_normal(257)
    d["unstructured_A"], rng = unstructured_matrix()
    d["unstructured_x"] = (rng.standard_normal(190)
                           + 1j * rng.standard_normal(190))
    for key in ("banded", "unstructured"):
        d[key + "_yjax"] = _jax_apply(d[key + "_A"], d[key + "_x"])
    d["spmm_A"] = banded_matrix(193, seed=5, band=11)
    rng = np.random.default_rng(2)
    d["spmm_X"] = (rng.standard_normal((193, 6))
                   + 1j * rng.standard_normal((193, 6)))
    d["spmm_Yjax"] = _jax_apply(d["spmm_A"], d["spmm_X"], spmm=True)
    rng = np.random.default_rng(0)
    d["dot_x"], d["dot_y"] = (rng.standard_normal(104)
                              + 1j * rng.standard_normal(104)
                              for _ in range(2))
    L, _ = gallery_jax.rijke_tube(96)
    d["V"] = np.zeros((L.size, 3), np.complex128)
    d["V"][:3, :3] = np.eye(3)
    d["zs"] = np.array([0.9 + 0.3j, 1.7 - 0.2j])
    d["Gamma"] = np.array([0.5 - 0.5j, 2.5 - 0.5j, 2.5 + 1.0j, 0.5 + 1.0j])
    path = str(tmp / "inputs.npz")
    np.savez(path, **d)
    with open(tmp / "torch_ranks_body.py", "w") as f:
        f.write(BODY)
    outs = run_world("torch_ranks_body:main", 4, (path,), timeout=240,
                     sys_path=[str(tmp)])
    return d, L, outs


def test_ranks_spmv(ranks):
    """SpMV at P = 8 over 4 ranks (q = 2): the JAX package's y to 1e-12
    and A @ x, on every rank."""
    d, _, outs = ranks
    for o in outs:
        assert o["banded_q"] == 2
        assert o["banded_err"] <= 1e-12
        assert np.allclose(o["banded_y"], d["banded_A"] @ d["banded_x"],
                           atol=1e-12)


def test_ranks_spmv_multihop(ranks):
    """The unstructured pattern's halo spans several parts and more than
    one rank (⌈nh/q⌉ > 1 hops of batch_isend_irecv)."""
    d, _, outs = ranks
    for o in outs:
        assert -(-o["unstructured_hops"] // 2) > 1
        assert o["unstructured_err"] <= 1e-12
        assert np.allclose(o["unstructured_y"],
                           d["unstructured_A"] @ d["unstructured_x"],
                           atol=1e-11)


def test_ranks_spmm(ranks):
    d, _, outs = ranks
    for o in outs:
        assert o["spmm_err"] <= 1e-12
        assert np.allclose(o["spmm_Y"], d["spmm_A"] @ d["spmm_X"],
                           atol=1e-11)


def test_ranks_dist_dot(ranks):
    d, _, outs = ranks
    ref = np.vdot(d["dot_x"], d["dot_y"])
    for o in outs:
        assert abs(o["dot"] - ref) < 1e-12 * abs(ref)


def test_ranks_node_solve(ranks):
    """The rijke1d node solves of tests/test_dist_solve.py:46 on a
    2 shift × 2 row mesh: each shift against a serial host solve to 1e-8,
    the same X on every rank."""
    from wavesandeigenvalues_jl_tpu.ops.linsolve import factorize
    d, L, outs = ranks
    for s, z in enumerate(d["zs"]):
        Xd = factorize(L(complex(z))).solve(d["V"])
        X = outs[0]["node_X"][s]
        assert np.linalg.norm(X - Xd) / np.linalg.norm(Xd) < 1e-8
    for o in outs[1:]:
        np.testing.assert_array_equal(o["node_X"], outs[0]["node_X"])
        np.testing.assert_array_equal(o["node_res"], outs[0]["node_res"])


def test_ranks_beyn_dist(ranks):
    """beyn_dist on the 2 × 2 mesh: the serial host Beyn's modes to 1e-7
    (tests/test_dist_solve.py:65), the same on every rank."""
    from wavesandeigenvalues_jl_tpu.nlevp.solvers import beyn
    d, L, outs = ranks
    Om_h, _ = beyn(L, list(d["Gamma"]), l=5, N=16, rtol=1e-12)
    Om = outs[0]["Om"]
    assert len(Om) == len(Om_h) > 0
    assert np.max(np.abs(np.sort_complex(Om) - np.sort_complex(Om_h))) < 1e-7
    assert outs[0]["beyn_info"]["solves"] == 32
    for o in outs[1:]:
        np.testing.assert_array_equal(o["Om"], Om)


def test_ranks_pod_spec_check(ranks):
    """pod_spec_check(4, n_host=2) on the world itself, and the dry run's
    checks (twin of __graft_entry__.dryrun_multichip) on every rank."""
    _, _, outs = ranks
    for o in outs:
        assert o["pod"] == {"host": 2, "shift": 2, "row": 1}
        dr = o["dryrun"]
        assert dr["multi"] is True and dr["node_solve_err"] < 1e-5
        assert dr["pod"] == o["pod"] and np.isfinite(dr["diag"])
    assert [o["rank"] for o in outs] == [0, 1, 2, 3]


def test_run_world_reports_a_failed_rank(tmp_path):
    """A rank that raises fails run_world with its output, and no process
    is left behind."""
    with open(os.path.join(tmp_path, "torch_ranks_fail.py"), "w") as f:
        f.write("import torch.distributed as dist\n"
                "def main():\n"
                "    if dist.get_rank() == 1:\n"
                "        raise RuntimeError('rank one fails')\n")
    with pytest.raises(RuntimeError, match="rank one fails"):
        run_world("torch_ranks_fail:main", 2, sys_path=[str(tmp_path)],
                  timeout=120)
