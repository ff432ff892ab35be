"""Device-batched and distributed Beyn contour integration.

Counterpart of the JAX package's ``parallel/dist_beyn.py``.  The |Γ|·N
quadrature solves L(z_j)⁻¹V are independent; they run on ``device``
either as dense solves (:func:`batched_moments`, small operators) or
through the block-tridiagonal direct solver or the multigrid-
preconditioned panel GMRES (:func:`matfree_moments`:
:class:`..ops.slab_solve.SlabSolver`,
:class:`..ops.panel_solve.ShiftedPanelSolver`) and are reduced into the
moment sums.  On a device mesh (:mod:`.mesh`) the dense solves are split
over its ``shift`` axis and the sums reduced with one ``all_reduce``
(``batched_moments(mesh=)``), and :func:`dist_moments` / :func:`beyn_dist`
run every solve row-sharded and shift-batched through
:func:`.dist_solve.make_dist_gmres`.  The dense eigen-tail (SVD + small
eig) stays on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..nlevp.family import OperatorFamily
from ..nlevp.solvers import (beyn, beyn_tail, gauss_nodes, initialize_V,
                             load_moments, moments_digest, save_moments)
from ..ops.panel_solve import ShiftedPanelSolver
from ..ops.slab_solve import SlabSolver
from ..ops.slab_solve import family_coefficients as _coeff_batch
from .mesh import (all_reduce_sum, axis_rank, axis_size, check_mesh,
                   mesh_device)

#: above this dimension ``dense=None`` switches to the matrix-free path
DENSE_BEYN_MAX_DIM = 4096

#: device bytes of one group of dense node matrices in batched_moments
DENSE_GROUP_BYTES = 1 << 30

#: GMRES-only solver keywords — their presence pins ``method="auto"`` to
#: the iterative panel path
_GMRES_KW = {"bs", "tol", "restart", "max_restarts", "coarse"}


def _make_matfree_solver(L: OperatorFamily, method: str, solver_kw: dict,
                         device):
    """The matrix-free panel solver on ``device``: "slab"
    (block-tridiagonal direct, :mod:`..ops.slab_solve`), "gmres"
    (multigrid-preconditioned iterative, :mod:`..ops.panel_solve`), or
    "auto": slab when the BFS slab partition is favourable and no
    GMRES-specific keyword was passed, else gmres."""
    if method == "auto":
        if _GMRES_KW & set(solver_kw):
            method = "gmres"
        else:
            probe = SlabSolver(L, **solver_kw, device=device)
            # favourable: enough slabs to amortize, blocks small enough
            # for the batched dense factorization
            if probe.part.m >= 8 and probe.part.smax <= 2048:
                return probe
            method = "gmres"
    if method == "slab":
        return SlabSolver(L, **solver_kw, device=device)
    if method == "gmres":
        return ShiftedPanelSolver(L, **solver_kw, device=device)
    raise ValueError(f"unknown matfree method {method!r} "
                     "(expected 'slab', 'gmres' or 'auto')")


def matfree_moments(L: OperatorFamily, Gamma, V=None, l=5, K=1, N=16,
                    output=False, group: Optional[int] = None,
                    checkpoint: Optional[str] = None, method: str = "auto",
                    *, device="cuda", **solver_kw):
    """Moment matrices through the matrix-free panel solver on ``device``
    (no [d, d] matrix anywhere).  ``method`` selects it: "slab" = the
    block-tridiagonal direct solver, "gmres" = the multigrid-
    preconditioned panel GMRES, "auto" = slab where the partition is
    favourable (:func:`_make_matfree_solver`).  Solver keywords
    (``chunk``, ``refine_tol``, …; for gmres also ``bs``, ``tol``,
    ``restart``, ``max_restarts``, ``coarse``) pass to its constructor.

    Nodes are processed in groups of ``group`` shifts (default: the solver
    chunk) and reduced into the moment sums at once, bounding host memory
    to one group of solutions.  ``checkpoint``: optional npz path — the
    partial sums persist after every group and a preempted run resumes at
    the last completed group (same digest as
    :func:`..nlevp.solvers.compute_moment_matrices`).  Returns (A, info)
    with the largest relres, the solver's ``timings`` and ``unconverged``
    (first node, end node, max relres) of every slab chunk, or every
    panel shift, that ended above the solver's ``refine_tol``."""
    d = L.size
    if V is None:
        V = initialize_V(d, l)
    V = np.asarray(V)
    d, l = V.shape
    zs, ws = gauss_nodes(Gamma, N)
    B = len(zs)
    solver = _make_matfree_solver(L, method, solver_kw, device)
    g = group or solver.default_group(l)
    powers = ws[:, None] * zs[:, None] ** np.arange(2 * K)[None, :]
    A = np.zeros((d, l, 2 * K), np.complex128)
    start, digest = 0, ""
    if checkpoint:
        digest = moments_digest(L, zs, ws, V, K)
        A, start = load_moments(checkpoint, digest, A, output)
    max_relres, unconverged = 0.0, []
    for s0 in range(start, B, g):
        s1 = min(s0 + g, B)
        X, info = solver.solve(zs[s0:s1], V, output=output)   # [g, d, l]
        max_relres = max(max_relres, info["max_relres"])
        unconverged += [(s0 + a, s0 + b, r)
                        for a, b, r in info["unconverged"]]
        A += np.einsum("bp,bil->ilp", powers[s0:s1], X)
        if checkpoint:
            save_moments(checkpoint, digest, A, s1)
        if output:
            print(f"matfree moments: nodes {s1}/{B} done")
    return A, {"max_relres": max_relres, "unconverged": unconverged,
               "solver_timings": dict(solver.timings)}


def batched_moments(L: OperatorFamily, Gamma, V=None, l=5, K=1, N=16,
                    mesh=None, axis: str = "shift", *, device="cuda"):
    """Moment matrices A_p = Σ_j w_j z_j^p L(z_j)⁻¹V by dense solves on
    ``device`` in complex128: every node's matrix is assembled on the
    device from the family stack (coefficient contraction + scatter) and
    the nodes are solved in groups, one batched solve a group.

    ``mesh``: a DeviceMesh whose ``axis`` splits the nodes: the node list
    is padded to a multiple of the axis size with weight-0 copies of the
    first node, each rank solves its contiguous share, and the weighted
    sums are added over the axis with one ``all_reduce`` (on the mesh's
    device), as the JAX package's ``shard_map`` + ``psum``.  Every rank
    returns the same sums.

    A group holds as many nodes as fit DENSE_GROUP_BYTES of matrices (all
    96 nodes of a contour up to d ≈ 830, 4 at DENSE_BEYN_MAX_DIM) on a
    card, and one node on the CPU: there torch's batched LU with two or
    more intra-op threads corrupts its pivots (MKL ZLASWP errors) and hangs
    from n ≈ 192 on.  complex128, not the JAX package's complex64 of a
    TPU: no refinement follows the dense solve, and the JAX package's
    ``device_complex_dtype()`` is complex128 wherever the device has it."""
    if mesh is not None:
        check_mesh(mesh)
    d = L.size
    if V is None:
        V = initialize_V(d, l)
    V = np.asarray(V)
    d, l = V.shape
    zs, ws = gauss_nodes(Gamma, N)
    coeffs = _coeff_batch(L, zs)
    if mesh is not None:
        n_dev = axis_size(mesh, axis)
        Bp = -(-len(zs) // n_dev) * n_dev
        share = slice(axis_rank(mesh, axis) * (Bp // n_dev),
                      (axis_rank(mesh, axis) + 1) * (Bp // n_dev))
        coeffs = np.concatenate([coeffs, np.repeat(coeffs[:1],
                                                   Bp - len(zs), 0)])[share]
        zs = np.concatenate([zs, np.zeros(Bp - len(zs))])[share]
        ws = np.concatenate([ws, np.zeros(Bp - len(ws))])[share]
    dtype = torch.complex128
    S = L._stack()
    values = torch.from_numpy(S.values).to(device, dtype)    # [K, nnz]
    rows = torch.from_numpy(np.asarray(S.row_ids(), np.int64)).to(device)
    cols = torch.from_numpy(np.asarray(S.indices, np.int64)).to(device)
    coeffs = torch.from_numpy(coeffs).to(device, dtype)
    powers = ws[:, None] * zs[:, None] ** np.arange(2 * K)[None, :]
    powers = torch.from_numpy(powers).to(device, dtype)     # [B, 2K]
    Vd = torch.from_numpy(V).to(device, dtype)
    g = 1
    if torch.device(device).type == "cuda":
        g = int(max(1, min(len(zs), DENSE_GROUP_BYTES // (16 * d * d))))
    Am = torch.zeros(d, l, 2 * K, dtype=dtype, device=device)
    info = torch.zeros((), dtype=torch.int32, device=device)
    for j0 in range(0, len(zs), g):
        j1 = min(j0 + g, len(zs))
        G = torch.zeros(j1 - j0, d, d, dtype=dtype, device=device)
        G[:, rows, cols] = coeffs[j0:j1] @ values
        X, bad = torch.linalg.solve_ex(G, Vd.expand(j1 - j0, d, l))
        info += bad.abs().sum()
        Am += torch.einsum("bil,bp->ilp", X, powers[j0:j1])
    if int(info) != 0:
        raise np.linalg.LinAlgError("batched_moments: a singular node "
                                    "matrix")
    if mesh is not None:
        Am = all_reduce_sum(Am.to(mesh_device(mesh)), mesh, axis)
    return Am.cpu().numpy()


def beyn_batched(L: OperatorFamily, Gamma, l=5, K=1, N=16, tol=0.0,
                 rtol=0.0, pos_test_flag=True, mesh=None, axis: str = "shift",
                 dense: Optional[bool] = None, output=False,
                 method: str = "auto", res_tol: Optional[float] = None,
                 return_residuals: bool = False, return_info: bool = False,
                 *, device="cuda", **solver_kw):
    """The JAX package's name for :func:`..nlevp.solvers.beyn` with the
    quadrature on ``device``: ``dense`` True → the "dense" backend, False
    → the matrix-free ``method`` ("slab", "gmres"; "auto" = the
    "matfree" backend), None → "dense" up to DENSE_BEYN_MAX_DIM DOF.
    Residuals are always computed (``res_tol`` None keeps every
    candidate).

    ``mesh``: a DeviceMesh; the dense quadrature is split over its
    ``axis`` (:func:`batched_moments`).  The JAX package ignores ``mesh``
    on the matrix-free path; here that combination raises ValueError
    (:func:`beyn_dist` is the row-sharded matrix-free contour)."""
    if mesh is not None:
        check_mesh(mesh)
    if dense is None:
        dense = L.size <= DENSE_BEYN_MAX_DIM
    if mesh is not None and not dense:
        raise ValueError("beyn_batched: mesh= splits the dense quadrature; "
                         "beyn_dist runs the row-sharded matrix-free "
                         "contour")
    if mesh is None:
        backend = "dense" if dense else {"auto": "matfree"}.get(method,
                                                                method)
        out = beyn(L, Gamma, l=l, K=K, N=N, tol=tol, rtol=rtol,
                   pos_test_flag=pos_test_flag, output=output,
                   res_tol=res_tol, backend=backend, return_residuals=True,
                   return_info=return_info, device=device, **solver_kw)
        return out if return_residuals else out[:2] + out[3:]
    if solver_kw:
        import warnings
        warnings.warn(
            "beyn_batched: dense path selected — matrix-free solver "
            f"keywords {sorted(solver_kw)} are ignored; pass dense=False to "
            "force the matrix-free path", stacklevel=2)
    K = max(K, (l + L.size - 1) // L.size)
    A = batched_moments(L, Gamma, initialize_V(L.size, l), K=K, N=N,
                        mesh=mesh, axis=axis, device=device)
    return beyn_tail(L, A, Gamma, tol, rtol, pos_test_flag, res_tol, output,
                     return_residuals, return_info, {})


def dist_moments(L: OperatorFamily, Gamma, mesh, n_row_parts: int,
                 V=None, l=5, K=1, N=16, row_axis: str = "row",
                 shift_axis: Optional[str] = "shift",
                 return_info: bool = False, **solver_kw):
    """Moment matrices with FULLY distributed node solves: the operator
    row-sharded over ``row_axis`` (halo-exchange SpMV inside GMRES, summed
    inner products) and the quadrature shifts riding ``shift_axis`` — the
    2-D re-design of the reference's serial quadrature loop
    (beyn.jl:62-74) over a device mesh.  One mesh-wide solve per slice of
    (shift-axis size) shifts, as in the JAX package; the last slice is
    padded with the last node.

    Solver keywords pass to :func:`.dist_solve.make_dist_gmres`.  With
    ``return_info`` also returns {"max_res": the largest preconditioned
    relres of the solves (padding excluded), "solves": mesh-wide solves,
    "seconds": their wall, "m" and "halo": the partition's rows a part
    and halo rows, "timings": the solve's phases on this rank
    (:func:`.dist_solve.make_dist_gmres`)}."""
    import time

    from .dist_solve import make_dist_gmres
    from .partition import partition_stack
    check_mesh(mesh)
    d = L.size
    if V is None:
        V = initialize_V(d, l)
    V = np.asarray(V)
    d, l = V.shape
    zs, ws = gauss_nodes(Gamma, N)
    B = len(zs)
    n_shift = axis_size(mesh, shift_axis) if shift_axis else 1
    part = partition_stack(L._stack(), n_row_parts)
    solve = make_dist_gmres(part, mesh, row_axis=row_axis,
                            shift_axis=shift_axis, **solver_kw)
    coeffs = _coeff_batch(L, zs)
    Bp = -(-B // n_shift) * n_shift
    cpad = np.concatenate([coeffs,
                           np.repeat(coeffs[-1:], Bp - B, 0)])
    Vt = np.broadcast_to(V.T[None], (Bp, l, d))
    X = np.empty((B, l, d), np.complex128)
    max_res, t0 = 0.0, time.perf_counter()
    for s0 in range(0, Bp, n_shift):  # one mesh-wide solve per slice
        Xs, res = solve(cpad[s0:s0 + n_shift], Vt[s0:s0 + n_shift])
        keep = min(n_shift, B - s0)
        X[s0:s0 + keep] = Xs[:keep]
        max_res = max(max_res, float(res[:keep].max()))
    powers = ws[:, None] * zs[:, None] ** np.arange(2 * K)[None, :]
    A = np.einsum("bp,bli->ilp", powers, X).astype(np.complex128)
    if return_info:
        return A, {"max_res": max_res, "solves": Bp // n_shift,
                   "seconds": time.perf_counter() - t0, "m": part.m,
                   "halo": part.halo, "timings": dict(solve.timings)}
    return A


def beyn_dist(L: OperatorFamily, Gamma, mesh, n_row_parts: int,
              l=5, K=1, N=16, tol=0.0, rtol=0.0, pos_test_flag=True,
              res_tol: Optional[float] = None, output=False,
              return_info: bool = False, **kw):
    """Beyn's algorithm with every quadrature solve running distributed
    on the (shift × row) device mesh (see :func:`dist_moments`).
    ``res_tol``: per-eigenpair residual cutoff (verify_eigenpairs).
    Returns (Om, P), and with ``return_info`` a dict of
    :func:`dist_moments`' info, the eigenpair ``residuals`` and the
    Hankel singular values ``sigma``."""
    d = L.size
    K = max(K, (l + d - 1) // d)
    A, info = dist_moments(L, Gamma, mesh, n_row_parts, l=l, K=K, N=N,
                           return_info=True, **kw)
    Om, P, res, info = beyn_tail(L, A, Gamma, tol, rtol, pos_test_flag,
                                 res_tol, output, True, True, info)
    if return_info:
        return Om, P, {**info, "residuals": res}
    return Om, P


__all__ = ["batched_moments", "matfree_moments", "dist_moments",
           "beyn_batched", "beyn_dist", "DENSE_BEYN_MAX_DIM"]
