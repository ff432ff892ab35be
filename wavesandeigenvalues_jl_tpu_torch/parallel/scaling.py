"""Scaling measurements of the distributed SpMV and GMRES.

Counterpart of the JAX package's ``parallel/scaling.py``: weak-scaling
records of the row-sharded halo-exchange SpMV and of the composed
row-sharded GMRES, the per-iteration communication accounting of that
GMRES, and a strong-scaling measurement on a fixed operator.  Each record
counts the row parts it ran (``n_devices``, the JAX package's name) and
the ranks those parts lay on (``n_ranks``, :mod:`.mesh`): on one rank the
parts run one after another on its device, so the records time the
layer, not a multi-device speed-up.  The JAX package's interconnect model
(``ici_model_efficiency``, the ICI constants and the ``"modeled"`` list
of ``dist_gmres_comm_report``) describes a TPU torus and is not kept.
"""
from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.sparse import CSR, StackedOperator
from .dist_solve import make_dist_gmres
from .dist_spmv import make_dist_spmv
from .mesh import axis_size, mesh_device
from .partition import partition_rows, partition_stack


def _banded_operator(n: int, band: int = 31, seed: int = 0) -> CSR:
    """FEM-like banded complex operator (bandwidth ~ a CMK-reordered
    tetrahedral P1 stiffness)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-(band // 2), band // 2 + 1)
    rows_l, cols_l, vals_l = [], [], []
    for k in offs:
        m = n - abs(k)
        r = np.arange(max(0, -k), max(0, -k) + m)
        vals = rng.standard_normal(m) + 1j * rng.standard_normal(m)
        if k == 0:
            vals += band  # diagonally dominant-ish
        rows_l.append(r)
        cols_l.append(r + k)
        vals_l.append(vals)
    return CSR.from_coo(np.concatenate(rows_l), np.concatenate(cols_l),
                        np.concatenate(vals_l), (n, n))


def _row_mesh(mesh):
    """``mesh``, or a 1-D "row" mesh over the current world."""
    if mesh is not None:
        return mesh
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("the scaling reports need a process group "
                           "(parallel.multihost.init_multihost) or a mesh")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=("row",))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _efficiency(out: List[dict], key: str) -> None:
    """Per-part throughput relative to the SMALLEST part count measured
    (``efficiency_vs_1`` only where that count is 1)."""
    if not out:
        return
    base, base_P = out[0][key], out[0]["n_devices"]
    for rec in out:
        rec["baseline_n_devices"] = base_P
        rec["efficiency_vs_smallest"] = float(rec[key] / base)
        if base_P == 1:
            rec["efficiency_vs_1"] = rec["efficiency_vs_smallest"]


def spmv_scaling_report(device_counts: Sequence[int] = (1, 2, 4, 8),
                        rows_per_device: int = 4096, band: int = 31,
                        reps: int = 50, verify: bool = True, mesh=None,
                        axis: str = "row") -> List[dict]:
    """Weak-scaling records of the halo-exchange SpMV: each part count P
    gets its own (P·rows_per_device)-row operator laid over the ranks of
    ``axis`` (default mesh: the world, one "row" axis); counts that are
    not a multiple of the axis size are skipped.  Throughput is the
    best-of-3 amortized apply time; ``efficiency_vs_1`` is per-part
    throughput over the 1-part figure."""
    mesh = _row_mesh(mesh)
    dev = mesh_device(mesh)
    n_ranks = axis_size(mesh, axis)
    out: List[dict] = []
    for P in device_counts:
        if P % n_ranks:
            continue
        n = P * rows_per_device
        A = _banded_operator(n, band=band)
        part = partition_rows(A, P, reorder=False)
        spmv, shard, unshard = make_dist_spmv(part, mesh, axis)
        rng = np.random.default_rng(1)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        xs = shard(x)
        y = spmv(xs)
        if verify:
            ref = A @ x
            err = np.linalg.norm(unshard(y) - ref) / np.linalg.norm(ref)
            assert err < 1e-10, f"dist SpMV wrong at P={P}: {err}"
        dt = np.inf
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                y = spmv(xs)
            _sync(dev)
            dt = min(dt, (time.perf_counter() - t0) / reps)
        out.append({
            "n_devices": int(P),
            "n_ranks": int(n_ranks),
            "rows": int(n),
            "nnz": int(A.nnz),
            "wall_s_per_apply": float(dt),
            "nnz_per_s": float(A.nnz / dt),
            "nnz_per_s_per_device": float(A.nnz / dt / P),
        })
    _efficiency(out, "nnz_per_s_per_device")
    return out


def _timed_solve(A: CSR, P: int, mesh, l: int, restart: int,
                 max_restarts: int, bs: int, best_of: int = 1,
                 axis: str = "row") -> float:
    """Best seconds of one row-sharded GMRES solve on A at P parts with
    deterministic work (tol 0: every column runs ``max_restarts`` cycles
    unless a cycle stagnates), after one warm solve."""
    part = partition_stack(StackedOperator.from_csrs([A]), P)
    solve = make_dist_gmres(part, mesh, row_axis=axis, bs=bs, tol=0.0,
                            restart=restart, max_restarts=max_restarts)
    coeffs = np.ones((1, 1), np.complex128)
    rng = np.random.default_rng(2)
    n = A.shape[0]
    B = rng.standard_normal((1, l, n)) + 1j * rng.standard_normal((1, l, n))
    solve(coeffs, B)
    best = np.inf
    for _ in range(best_of):
        t0 = time.perf_counter()
        solve(coeffs, B)
        best = min(best, time.perf_counter() - t0)
    return best


def dist_gmres_scaling_report(device_counts: Sequence[int] = (1, 2, 4, 8),
                              rows_per_device: int = 4096, band: int = 31,
                              l: int = 2, restart: int = 20,
                              max_restarts: int = 2,
                              bs: int = 32, mesh=None,
                              axis: str = "row") -> List[dict]:
    """Weak-scaling records of the COMPOSED row-sharded GMRES solve, with
    deterministic work per part count (tol 0 → ``max_restarts`` cycles of
    ``restart`` Arnoldi steps per column).  Throughput is
    preconditioned-matvec nnz/s (matvecs = l·restarts·(restart+2))."""
    mesh = _row_mesh(mesh)
    n_ranks = axis_size(mesh, axis)
    out: List[dict] = []
    for P in device_counts:
        if P % n_ranks:
            continue
        n = P * rows_per_device
        A = _banded_operator(n, band=band)
        dt = _timed_solve(A, P, mesh, l, restart, max_restarts, bs,
                          axis=axis)
        matvecs = l * max_restarts * (restart + 2)
        out.append({
            "n_devices": int(P),
            "n_ranks": int(n_ranks),
            "rows": int(n),
            "nnz": int(A.nnz),
            "wall_s_per_solve": float(dt),
            "matvec_nnz_per_s": float(A.nnz * matvecs / dt),
            "matvec_nnz_per_s_per_device": float(A.nnz * matvecs / dt / P),
        })
    _efficiency(out, "matvec_nnz_per_s_per_device")
    return out


def gmres_comm_accounting(n: int, P: int, halo: int, l: int, restart: int,
                          max_restarts: int, itemsize: int = 16) -> dict:
    """Per-iteration communication of the row-sharded GMRES
    (:func:`.dist_solve.make_dist_gmres`), per Arnoldi iteration and RHS
    column, as counted by the JAX package:

    * halo exchange: 2·⌈halo/m⌉ neighbour transfers of ``halo`` rows each
      (:func:`.dist_spmv.halo_exchange`) = the matvec's only communication,
      volume independent of P;
    * CGS2: 2 sums of the (restart+1)-long projection vector + 2 scalar
      norm sums over the row group;

    complex128 (16 B) payloads.  Counts are exact properties of the
    algorithm, not measurements; between parts of one rank the halo moves
    inside the rank's memory."""
    m = n // P
    hops = 0 if (P == 1 or halo == 0) else 2 * -(-halo // m)
    iters = max_restarts * (restart + 2)
    return {
        "rows_per_device": m,
        "halo_rows": int(halo),
        "ppermute_hops_per_matvec": hops,
        "halo_bytes_per_matvec_per_col": 2 * halo * itemsize,
        "psums_per_arnoldi_iter": 4,
        "psum_bytes_per_arnoldi_iter": (2 * (restart + 1) + 2) * itemsize,
        "arnoldi_iters_per_solve": iters,
        "cols": l,
        "comm_bytes_per_solve": l * iters * (
            2 * halo * itemsize + (2 * (restart + 1) + 2) * itemsize),
    }


def dist_gmres_comm_report(rows_per_device: int = 4096, band: int = 31,
                           l: int = 2, restart: int = 20,
                           max_restarts: int = 2, bs: int = 32,
                           mesh=None) -> dict:
    """Communication accounting of the composed distributed GMRES beside
    its per-iteration compute time, measured on one part (no collectives)
    of the same per-part workload.  The JAX package adds a modelled
    efficiency over a TPU interconnect; the port keeps no such model."""
    mesh = _row_mesh(mesh)
    n = rows_per_device
    A = _banded_operator(n, band=band)
    iters = max_restarts * (restart + 2)
    t_iter = _timed_solve(A, 1, _single_rank_mesh(mesh), l, restart,
                          max_restarts, bs, best_of=3) / iters
    return {
        "per_device_rows": int(n),
        "t_compute_per_iter_s": float(t_iter),
        "accounting": gmres_comm_accounting(n, 1, band // 2, l, restart,
                                            max_restarts),
        "note": ("compute time measured at P=1 on this rank's device; "
                 "communication counted, not modelled"),
    }


def _single_rank_mesh(mesh):
    """``mesh`` when its row axis has one rank (the one-part measurements
    run there); ValueError otherwise."""
    if axis_size(mesh, "row") != 1:
        raise ValueError("this report measures one part: give it a mesh "
                         "whose row axis has one rank")
    return mesh


def dist_gmres_strong_report(A: CSR, device_counts: Sequence[int]
                             = (1, 2, 4, 8, 16, 32),
                             l: int = 2, restart: int = 20,
                             max_restarts: int = 2, bs: int = 32,
                             mesh=None) -> dict:
    """STRONG scaling of the row-sharded GMRES on a FIXED operator split
    P ways: for every P the per-part workload is the leading ⌈n/P⌉-row
    principal submatrix of A (the block one part would own), solved on
    one part of this rank's device; t_iter(n/P) is measured, and

        eff_strong(P) = (t_iter(n)/P) / t_iter(n/P)

    keeps every per-iteration overhead that ideal scaling ignores.  The
    JAX package adds modelled interconnect time to the denominator; here
    each record carries the exact communication counts of
    :func:`gmres_comm_accounting` instead (bytes, not seconds)."""
    import scipy.sparse as sp

    from ..ops.reorder import bandwidth
    mesh = _single_rank_mesh(_row_mesh(mesh))
    n = A.shape[0]
    halo = int(bandwidth(A))
    As = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
    iters = max_restarts * (restart + 2)
    t_iter = {}
    for P in device_counts:
        m = -(-n // P)
        Am = As[:m, :m].tocsr()
        t_iter[P] = _timed_solve(CSR(Am.indptr, Am.indices, Am.data, (m, m)),
                                 1, mesh, l, restart, max_restarts, bs,
                                 best_of=3) / iters
    t1 = t_iter[min(device_counts)] * min(device_counts)
    records = []
    for P in device_counts:
        acc = gmres_comm_accounting(n, P, halo, l, restart, max_restarts)
        records.append({
            "n_devices": int(P),
            "n_ranks": 1,
            "rows_per_device": int(-(-n // P)),
            "t_iter_measured_s": float(t_iter[P]),
            "comm_bytes_per_iter": float(acc["comm_bytes_per_solve"]
                                         / acc["arnoldi_iters_per_solve"]),
            "strong_efficiency": float(min(t1 / P / t_iter[P], 1.0)),
        })
    return {
        "n_rows": int(n), "nnz": int(A.nnz), "halo_rows": halo,
        "restart": restart, "l": l,
        "backend": mesh_device(mesh).type,
        "records": records,
        "note": ("t_iter measured on this rank's device per per-part "
                 "size; communication counted, not modelled"),
    }


__all__ = ["spmv_scaling_report", "dist_gmres_scaling_report",
           "gmres_comm_accounting", "dist_gmres_comm_report",
           "dist_gmres_strong_report"]
