"""Device-batched Beyn contour integration.

Counterpart of the single-device part of the JAX package's
``parallel/dist_beyn.py``.  The |Γ|·N quadrature solves L(z_j)⁻¹V are
independent; they run on ``device`` either as dense solves
(:func:`batched_moments`, small operators) or through the block-tridiagonal
direct solver or the multigrid-preconditioned panel GMRES
(:func:`matfree_moments`: :class:`..ops.slab_solve.SlabSolver`,
:class:`..ops.panel_solve.ShiftedPanelSolver`) and are reduced into the
moment sums.  The dense eigen-tail (SVD + small eig) stays on the host.
The ``mesh`` sharding is ROADMAP.md Queue 1 item 8.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..nlevp.family import OperatorFamily
from ..nlevp.solvers import (beyn, gauss_nodes, initialize_V, load_moments,
                             moments_digest, save_moments)
from ..ops.panel_solve import ShiftedPanelSolver
from ..ops.slab_solve import SlabSolver
from ..ops.slab_solve import family_coefficients as _coeff_batch

#: above this dimension ``dense=None`` switches to the matrix-free path
DENSE_BEYN_MAX_DIM = 4096

#: device bytes of one group of dense node matrices in batched_moments
DENSE_GROUP_BYTES = 1 << 30

#: GMRES-only solver keywords — their presence pins ``method="auto"`` to
#: the iterative panel path
_GMRES_KW = {"bs", "tol", "restart", "max_restarts", "coarse"}


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: the sharded contour is not ported yet (ROADMAP.md "
            "Queue 1 item 8, the distributed layer)")


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
                    mesh=None, *, device="cuda"):
    """Moment matrices A_p = Σ_j w_j z_j^p L(z_j)⁻¹V by dense solves on
    ``device`` in complex128: every node's matrix is assembled on the
    device from the family stack (coefficient contraction + scatter) and
    the nodes are solved in groups, one batched solve a group.

    A group holds as many nodes as fit DENSE_GROUP_BYTES of matrices (all
    96 nodes of a contour up to d ≈ 830, 4 at DENSE_BEYN_MAX_DIM) on a
    card, and one node on the CPU: there torch's batched LU with two or
    more intra-op threads corrupts its pivots (MKL ZLASWP errors) and hangs
    from n ≈ 192 on.  complex128, not the JAX package's complex64 of a
    TPU: no refinement follows the dense solve, and the JAX package's
    ``device_complex_dtype()`` is complex128 wherever the device has it."""
    _no_mesh(mesh)
    d = L.size
    if V is None:
        V = initialize_V(d, l)
    V = np.asarray(V)
    d, l = V.shape
    zs, ws = gauss_nodes(Gamma, N)
    dtype = torch.complex128
    S = L._stack()
    values = torch.from_numpy(S.values).to(device, dtype)    # [K, nnz]
    rows = torch.from_numpy(np.asarray(S.row_ids(), np.int64)).to(device)
    cols = torch.from_numpy(np.asarray(S.indices, np.int64)).to(device)
    coeffs = torch.from_numpy(_coeff_batch(L, zs)).to(device, dtype)
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
    return Am.cpu().numpy()


def beyn_batched(L: OperatorFamily, Gamma, l=5, K=1, N=16, tol=0.0,
                 rtol=0.0, pos_test_flag=True, mesh=None,
                 dense: Optional[bool] = None, output=False,
                 method: str = "auto", res_tol: Optional[float] = None,
                 return_residuals: bool = False, return_info: bool = False,
                 *, device="cuda", **solver_kw):
    """The JAX package's name for :func:`..nlevp.solvers.beyn` with the
    quadrature on ``device``: ``dense`` True → the "dense" backend, False
    → the matrix-free ``method`` ("slab", "gmres"; "auto" = the
    "matfree" backend), None → "dense" up to DENSE_BEYN_MAX_DIM DOF.  Residuals
    are always computed (``res_tol`` None keeps every candidate)."""
    _no_mesh(mesh)
    if dense is None:
        dense = L.size <= DENSE_BEYN_MAX_DIM
    if dense:
        backend = "dense"
    else:
        backend = {"auto": "matfree"}.get(method, method)
    out = beyn(L, Gamma, l=l, K=K, N=N, tol=tol, rtol=rtol,
               pos_test_flag=pos_test_flag, output=output, res_tol=res_tol,
               backend=backend, return_residuals=True,
               return_info=return_info, device=device, **solver_kw)
    return out if return_residuals else out[:2] + out[3:]


__all__ = ["batched_moments", "matfree_moments", "beyn_batched",
           "DENSE_BEYN_MAX_DIM"]
