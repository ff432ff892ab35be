"""Composed distributed shifted solves on the (shift × row) device mesh.

Counterpart of the JAX package's ``parallel/dist_solve.py``: the
distributed primitives — halo-exchange SpMV (:mod:`.dist_spmv`), summed
dot products, the reduce-parameterised GMRES (:func:`..ops.gmres.gmres_impl`
with ``reduce_fn``) — composed into a row-sharded iterative solve of
``L(z) X = B``:

* the operator lives as a row-partitioned ELL stack
  (:class:`.partition.RowPartitionedEll`), each rank holding its parts of
  the ``row`` axis (:mod:`.mesh`); each Arnoldi matvec is (halo exchange)
  → (local ELL product);
* every inner product and norm inside GMRES is summed over the row group
  (``reduce_fn``), so the small least-squares problem is the same on every
  rank and the Krylov basis stays row-sharded;
* independent shifts ride the ``shift`` axis with no communication until
  the results are gathered;
* the LEFT preconditioner is block-Jacobi over the owned diagonal blocks
  of each shift (part-local by construction), or one two-grid cycle
  (:class:`..ops.panel_solve.CoarseGrid`) or V-cycle
  (:class:`..ops.panel_solve.MultiGrid`) whose restriction is summed over
  the row group into a coarse vector every rank holds whole.

The probe panel's l columns and a rank's shifts run together as the
systems of one :func:`..ops.gmres.gmres_impl` call (``vmap`` over shifts
and columns in the JAX package).  Complex128 by default, as the JAX
package's ``device_complex_dtype()`` off a TPU; its (re, im) float planes
and ``CHECK_VMA`` (shard_map's type checker) have no counterpart.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.gmres import BatchedBlockDiagInv, gmres_impl
from ..ops.panel_solve import (CoarseGrid, MultiGrid, _block_apply, _Level,
                               _spmv, _transfer, acinv_batch)
from .dist_spmv import _LocalOperator, halo_exchange
from .mesh import all_gather_stack, all_reduce_sum, axis_rank, axis_size
from .partition import RowPartitionedEll


def _owned_block_diag_inv(part: RowPartitionedEll, coeffs: np.ndarray,
                          bs: int) -> np.ndarray:
    """[S, P, nb, bs, bs] inverted diagonal blocks of the owned rows for
    each shift (host, exact).  Owned-local column = window column − H, so
    the blocks never touch halo entries — the preconditioner apply is
    part-local."""
    S = coeffs.shape[0]
    Pn, m, w = part.cols.shape
    nb = -(-m // bs)
    data = np.tensordot(coeffs, part.values, axes=(1, 0))  # [S, P, m, w]
    lc = part.cols.astype(np.int64) - part.halo            # owned-local col
    i = np.broadcast_to(np.arange(m)[None, :, None], part.cols.shape)
    valid = (lc >= 0) & (lc < m) & ((lc // bs) == (i // bs))
    pi, ri, wi = np.nonzero(valid)
    D = np.zeros((S, Pn, nb, bs, bs), np.complex128)
    blk = ri[None].repeat(S, 0) // bs
    np.add.at(D, (np.arange(S)[:, None], pi[None].repeat(S, 0), blk,
                  ri[None].repeat(S, 0) % bs, lc[pi, ri, wi][None] % bs),
              data[:, pi, ri, wi])
    idx = np.arange(bs)
    diag = D[..., idx, idx]
    D[..., idx, idx] = np.where(np.abs(diag) == 0, 1.0, diag)
    return np.linalg.inv(D)


def _local_prolongation(pc, pv, part: RowPartitionedEll, parts: range):
    """Fine → first coarse level interpolation rows (ELL [n, wp]) in
    partition order, padded per part, of this rank's parts: ([q, m, wp]
    columns, [q, m, wp] real weights)."""
    Pn, m = part.n_parts, part.m
    wp = pc.shape[1]
    pcl = np.zeros((Pn * m, wp), np.int64)
    pvl = np.zeros((Pn * m, wp), np.float64)
    pcl[:part.n] = pc[part.perm]
    pvl[:part.n] = np.real(pv[part.perm])
    sl = slice(parts.start * m, parts.stop * m)
    return pcl[sl].reshape(len(parts), m, wp), pvl[sl].reshape(len(parts),
                                                               m, wp)


def make_dist_gmres(part: RowPartitionedEll, mesh: DeviceMesh,
                    row_axis: str = "row",
                    shift_axis: Optional[str] = None, bs: int = 32,
                    tol: float = 1e-10, restart: int = 80,
                    max_restarts: int = 40, dtype=None, coarse=None):
    """Build the (shift × row)-sharded GMRES panel solve.

    Returns ``solve(coeffs, B) -> (X, res)`` taking HOST arrays
    ``coeffs [S, K]`` (per-shift family coefficients) and ``B [S, l, n]``
    (original row order) and returning, on every rank, ``X [S, l, n]``
    host complex128 plus the preconditioned relative residuals ``[S, l]``.
    S must be a multiple of the shift-axis size (1 when ``shift_axis`` is
    None): shift rank s solves shifts [s·S', (s+1)·S'), S' = S / size.

    ``coarse``: None (block-Jacobi of block size ``bs``), a ``CoarseGrid``
    (two-grid) or a ``MultiGrid`` (V-cycle).  The fine level stays
    row-sharded; the restricted residual is summed over the row group
    into a coarse vector every rank holds, the coarse hierarchy runs the
    same on every rank, and the prolongation back is part-local.  One
    row-group sum of size n₁ per preconditioner application.  Restart
    length matters more than block size on the indefinite Helmholtz
    operators (GMRES(40) stagnates where GMRES(80) converges, JAX
    package)."""
    if coarse is not None and not isinstance(coarse, (CoarseGrid,
                                                      MultiGrid)):
        raise TypeError(
            f"coarse must be a CoarseGrid or MultiGrid, got "
            f"{type(coarse).__name__} (build one from the octosplit "
            "hierarchy via ops.panel_solve)")
    if coarse is not None and coarse.n_fine != part.n:
        raise ValueError("prolongation n_fine != operator dim")
    op = _LocalOperator(part, mesh, row_axis, dtype or np.complex128)
    cdt, dev, parts = op.dtype, op.device, op.parts
    vals, cols = op.vals, op.cols                  # [K, q, m, w], [q, m, w]
    q = len(parts)
    K, Pn, m, w = part.values.shape
    halo = part.halo
    n_shift = axis_size(mesh, shift_axis) if shift_axis else 1
    s_rank = axis_rank(mesh, shift_axis) if shift_axis else 0
    sl = slice(parts.start, parts.stop)
    pidx = torch.arange(q, device=dev)[:, None, None]
    reduce_fn = None
    if axis_size(mesh, row_axis) > 1:
        def reduce_fn(t):
            return all_reduce_sum(t, mesh, row_axis)

    is_mg = isinstance(coarse, MultiGrid)
    if coarse is not None:
        pc0, pv0 = ((coarse.xfers[0][0], coarse.xfers[0][1]) if is_mg
                    else (coarse.pell_cols, coarse.pell_vals))
        pcl, pvl = _local_prolongation(pc0, pv0, part, parts)
        pcl = torch.from_numpy(pcl).to(dev)
        pvl = torch.from_numpy(pvl).to(dev, cdt)
        n1 = (coarse.levels[0][5] if is_mg and coarse.levels
              else coarse.n_coarse)

    def put(a, dt=cdt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    if is_mg:
        levels = [_Level(values, ec, eg, dev)
                  for (values, _r, _c, ec, eg, _nk) in coarse.levels]
        xfers = [(put(pc, torch.int64), put(np.real(pv)), put(tc, torch.int64),
                  put(np.real(tv))) for (pc, pv, tc, tv) in coarse.xfers[1:]]
        lvl_dbb = [BatchedBlockDiagInv(rows, cols_, nk, coarse.bs)
                   for (_v, rows, cols_, _ec, _eg, nk) in coarse.levels]
        lvl_vals128 = [np.asarray(v, np.complex128)
                       for (v, *_rest) in coarse.levels]

    def solve(coeffs, B):
        coeffs = np.asarray(coeffs, np.complex128)
        B = np.asarray(B, np.complex128)
        S, l = B.shape[0], B.shape[1]
        if S % n_shift:
            raise ValueError(f"{S} shifts cannot be laid evenly over the "
                             f"{n_shift} ranks of mesh axis {shift_axis!r}")
        Sl = S // n_shift
        k = Sl * l
        c = coeffs[s_rank * Sl:(s_rank + 1) * Sl]
        t0 = time.perf_counter()
        Dinv = put(_owned_block_diag_inv(part, c, bs)[:, sl])
        if coarse is not None:
            acinv = put(acinv_batch(coarse, c))           # [Sl, nc, nc]
        if is_mg:
            ldinv = [put(dbb.inv(c @ v128))
                     for dbb, v128 in zip(lvl_dbb, lvl_vals128)]
        Bp = np.zeros((Sl, l, Pn * m), np.complex128)
        Bp[..., :part.n] = B[s_rank * Sl:(s_rank + 1) * Sl][..., part.perm]
        b = put(Bp.reshape(Sl, l, Pn, m)[:, :, sl]).reshape(k, q * m)
        ct = put(c)
        data = torch.einsum("sk,kqmw->qmws", ct, vals)     # [q, m, w, Sl]

        def matvec(x):
            ext = halo_exchange(x.view(k, q, m).permute(1, 2, 0), halo,
                                mesh, row_axis)           # [q, W+1, k]
            g = ext[pidx, cols].view(q, m, w, Sl, l)
            y = (data[..., None] * g).sum(2)              # [q, m, Sl, l]
            return y.permute(2, 3, 0, 1).reshape(k, q * m)

        def dinv(v):
            nb = Dinv.shape[2]
            vp = v.new_zeros(Sl, l, q, nb * bs)
            vp[..., :m] = v.view(Sl, l, q, m)
            out = torch.einsum("sqbij,slqbj->slqbi", Dinv,
                               vp.view(Sl, l, q, nb, bs))
            return out.reshape(Sl, l, q, nb * bs)[..., :m].reshape(k, q * m)

        if coarse is None:
            minv = dinv
        else:
            if is_mg:
                dells = [lv.ell(ct).to(cdt) for lv in levels]
                lcols = [lv.cols for lv in levels]

            def vcycle(j, v):
                """The replicated hierarchy below the fine level: level j
                of ``coarse.levels``, the exact inverse past the last."""
                if not is_mg or j == len(levels):
                    vc = v.view(Sl, l, v.shape[-1])
                    return torch.matmul(vc, acinv.transpose(1, 2)).view(
                        v.shape)
                pc, pv, tc, tv = xfers[j]
                y = _block_apply(ldinv[j], v, Sl)
                r = v - _spmv(dells[j], lcols[j], y, Sl)
                y = y + _transfer(pc, pv, vcycle(j + 1,
                                                 _transfer(tc, tv, r)))
                r = v - _spmv(dells[j], lcols[j], y, Sl)
                return y + _block_apply(ldinv[j], r, Sl)

            def minv(v):
                y = dinv(v)
                r = (v - matvec(y)).view(k, q, m, 1)
                # restriction: the ranks' owned-row parts, summed
                rc = v.new_zeros(k, n1).index_add_(
                    1, pcl.reshape(-1), (pvl * r).reshape(k, -1))
                if reduce_fn is not None:
                    rc = reduce_fn(rc)
                vc = vcycle(0, rc)
                y = y + (pvl * vc[:, pcl]).sum(-1).reshape(k, q * m)
                return y + dinv(v - matvec(y))

        t1 = time.perf_counter()
        x, res, its = gmres_impl(lambda x: minv(matvec(x)), minv(b),
                                 tol=tol, restart=restart,
                                 max_restarts=max_restarts,
                                 reduce_fn=reduce_fn)
        t2 = time.perf_counter()
        X = all_gather_stack(x.view(Sl, l, q, m), mesh, row_axis)
        X = X.permute(1, 2, 0, 3, 4).reshape(Sl, l, Pn * m)
        res = res.view(Sl, l)
        if shift_axis:
            X = all_gather_stack(X, mesh, shift_axis).reshape(S, l, Pn * m)
            res = all_gather_stack(res, mesh, shift_axis).reshape(S, l)
        Xh = X[..., :part.n].cpu().numpy()
        out = np.empty((S, l, part.n), np.complex128)
        out[..., part.perm] = Xh
        tm = solve.timings
        tm["prep_s"] += t1 - t0
        tm["gmres_s"] += t2 - t1
        tm["gather_s"] += time.perf_counter() - t2
        tm["solves"] += 1
        tm["restarts"] += int(its.sum())
        return out, res.cpu().numpy()

    #: seconds of this rank's host inverses and uploads (``prep_s``), its
    #: GMRES (``gmres_s``, one host sync a cycle) and the gathers
    #: (``gather_s``); calls (``solves``) and GMRES cycles of its systems
    solve.timings = {"prep_s": 0.0, "gmres_s": 0.0, "gather_s": 0.0,
                     "solves": 0, "restarts": 0}
    return solve


def dist_beyn_node_solve(L, zs, V, mesh: DeviceMesh, n_row_parts: int,
                         row_axis: str = "row",
                         shift_axis: Optional[str] = "shift", **kw):
    """One composed distributed Beyn node solve: L(z_s) X_s = V with the
    operator row-sharded and the quadrature shifts on the second mesh axis
    (the distributed re-design of beyn.jl:41-74).  Returns (X [S, n, l],
    res [S, l])."""
    from ..ops.slab_solve import family_coefficients
    from .partition import partition_stack
    part = partition_stack(L._stack(), n_row_parts)
    solve = make_dist_gmres(part, mesh, row_axis=row_axis,
                            shift_axis=shift_axis, **kw)
    zs = np.asarray(zs)
    coeffs = family_coefficients(L, zs)
    V = np.asarray(V, np.complex128)
    B = np.broadcast_to(V.T[None], (len(zs),) + V.T.shape)
    X, res = solve(coeffs, B)
    return np.ascontiguousarray(np.swapaxes(X, 1, 2)), res


__all__ = ["make_dist_gmres", "dist_beyn_node_solve"]
