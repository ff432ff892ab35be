"""Matrix-free batched shifted panel solves X_j = L(z_j)⁻¹ V on ``device``.

Counterpart of the JAX package's ``ops/panel_solve.py``: the iterative
backend of the Beyn contour quadrature (beyn.jl:62-74, one sparse LU a node
in the reference) for operators whose slab partition is unfavourable and
for every call that passes a GMRES keyword.

* the operator family evaluates on the device as ``data = c @ values`` over
  the union-pattern stack, gathered to padded ELL once a shift;
* the LEFT preconditioner of each shift is block-Jacobi, or one two-grid
  cycle (:class:`CoarseGrid`), or one V-cycle over an octosplit hierarchy
  (:class:`MultiGrid`).  Its block and coarse inverses are complex128
  LAPACK inversions on the host (``BatchedBlockDiagInv``,
  :func:`acinv_batch`), as in the JAX package; the cycle itself runs on
  the device: ELL gathers, block einsums and one batched matmul with the
  coarse inverse;
* the k = S·l systems of a chunk of S shifts run together through
  :func:`.gmres.gmres_impl`, rows of [k, n] complex128 tensors;
* complex128 host residuals in the row-equilibrated norm judge each column
  and drive per-column refinement sweeps.

The JAX package has three jitted device passes (plain, two-grid,
multilevel); here one pass serves all three, the preconditioner chosen by
the type of ``coarse``.  Its split (re, im) float planes are a TPU transfer
workaround and are dropped.
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from .gmres import BatchedBlockDiagInv, gmres_impl
from .slab_solve import family_coefficients
from .sparse import csr_to_ell

#: device-memory budget (bytes) of one chunk: its Krylov bases, the
#: temporaries of the Gram-Schmidt passes and of the ELL gathers, and its
#: per-shift operators and inverses (an 80 GB card)
PANEL_BUDGET = 32e9

#: bytes of one complex128 value
_CSIZE = 16


class CoarseGrid:
    """Geometric coarse level for the two-grid preconditioner: the SAME
    operator family assembled on a coarser octosplit ancestor, plus the P1
    interpolation COO from :func:`..mesh.refine.p1_prolongation` (possibly
    composed across several levels)."""

    def __init__(self, coarse_family, prolongation):
        import scipy.sparse as sp
        rows, cols, vals, (n_f, n_c) = prolongation
        Sc = coarse_family._stack()
        if Sc.shape[0] != n_c:
            raise ValueError(f"coarse family dim {Sc.shape[0]} != "
                             f"prolongation n_coarse {n_c}")
        self.n_fine, self.n_coarse = int(n_f), int(n_c)
        self.values = Sc.values                        # [K, nnz_c] host
        self.crows = np.asarray(Sc.row_ids(), np.int64)
        self.ccols = np.asarray(Sc.indices, np.int64)
        # transfer operators in padded-ELL gather form (P and Pᵀ): padded
        # slots carry zero values, so their column index 0 is inert
        Pm = sp.coo_matrix((vals, (rows, cols)), shape=(n_f, n_c)).tocsr()
        pc, pg, _ = csr_to_ell(Pm.indptr, Pm.indices, n_c)
        self.pell_cols = pc.astype(np.int32)
        self.pell_vals = np.concatenate([Pm.data, [0.0]])[pg]
        Pt = Pm.T.tocsr()
        tc, tg, _ = csr_to_ell(Pt.indptr, Pt.indices, n_f)
        self.ptell_cols = tc.astype(np.int32)
        self.ptell_vals = np.concatenate([Pt.data, [0.0]])[tg]


class MultiGrid:
    """Geometric multilevel hierarchy for the panel GMRES preconditioner.

    ``families``: the SAME operator family discretized on successively
    coarser octosplit ancestors, fine-ward first (EXCLUDING the solve
    level); ``prolongations``: P1 interpolation COOs
    (mesh/refine.p1_prolongation), ``prolongations[k]`` mapping
    ``families[k]`` up to the level above (the solve level for k=0).  The
    deepest family is inverted exactly per shift (host complex128); every
    intermediate level gets a block-Jacobi smoother of block size ``bs``."""

    def __init__(self, families, prolongations, bs: int = 64):
        if len(families) != len(prolongations):
            raise ValueError("need one prolongation per coarse family")
        self.bs = bs
        self.n_fine = int(prolongations[0][3][0])
        self.levels = []       # intermediate: (values, rows, cols, ell)
        self.xfers = []        # (pell_cols, pell_vals, ptell_cols, ptell_vals)
        n_above = self.n_fine
        for k, (fam, pro) in enumerate(zip(families, prolongations)):
            S = fam._stack()
            nk = int(S.shape[0])
            if pro[3] != (n_above, nk):
                raise ValueError(f"prolongation {k} maps {pro[3]}, "
                                 f"expected ({n_above}, {nk})")
            cg = CoarseGrid(fam, pro)      # reuse its ELL transfer build
            self.xfers.append((cg.pell_cols, cg.pell_vals.astype(np.float64),
                               cg.ptell_cols,
                               cg.ptell_vals.astype(np.float64)))
            if k < len(families) - 1:      # intermediate: smoother + op
                ec, eg, _ = csr_to_ell(S.indptr, S.indices, nk)
                self.levels.append((S.values,
                                    np.asarray(S.row_ids(), np.int64),
                                    np.asarray(S.indices, np.int64),
                                    ec.astype(np.int32),
                                    eg.astype(np.int32), nk))
            else:                          # deepest: exact inverse
                self.n_coarse = nk
                self.values = S.values
                self.crows = np.asarray(S.row_ids(), np.int64)
                self.ccols = np.asarray(S.indices, np.int64)
            n_above = nk


def acinv_batch(cg, coeffs: np.ndarray) -> np.ndarray:
    """[S, nc, nc] complex128 host inverses of the coarse operator at each
    shift's coefficient vector (one batched LAPACK inversion)."""
    nc = cg.n_coarse
    A = np.zeros((coeffs.shape[0], nc, nc), np.complex128)
    data = np.asarray(coeffs, np.complex128) @ cg.values    # [S, nnz_c]
    A[:, cg.crows, cg.ccols] = data
    return np.linalg.inv(A)


# ---------------------------------------------------------------------------
# device pass: one chunk of c shifts × l columns, rows of [c·l, n] tensors


class _Level:
    """One level's operator on the device: ``values`` [K, nnz] complex128
    and its padded-ELL structure (``cols`` [n, w], ``gather`` [n, w] into
    the values with a zero slot last)."""

    def __init__(self, values, ecols, egather, device):
        self.values = torch.from_numpy(np.asarray(values, np.complex128)).to(
            device)
        self.cols = torch.from_numpy(np.asarray(ecols, np.int64)).to(device)
        self.gather = torch.from_numpy(np.asarray(egather, np.int64)).to(
            device)
        self.n = int(self.cols.shape[0])

    def ell(self, coeffs: torch.Tensor) -> torch.Tensor:
        """[c, n, w] shifted ELL values of the chunk's shifts."""
        data = coeffs @ self.values                        # [c, nnz]
        return torch.cat([data, data.new_zeros(data.shape[0], 1)],
                         1)[:, self.gather]


def _spmv(dell, cols, x, c):
    """y = A_s x for the rows of x [c·l, n] (row i through shift i // l)."""
    xs = x.view(c, -1, x.shape[-1])
    return (dell[:, None] * xs[..., cols]).sum(-1).view(x.shape[0], -1)


def _block_apply(Dinv, x, c):
    """y = D_s⁻¹ x over a shift's block inverses Dinv [c, nb, bs, bs]."""
    nb, bs = Dinv.shape[1], Dinv.shape[2]
    n = x.shape[-1]
    xp = x.new_zeros(c, x.shape[0] // c, nb * bs)
    xp[..., :n] = x.view(c, -1, n)
    out = torch.einsum("cbij,clbj->clbi", Dinv,
                       xp.view(c, -1, nb, bs))
    return out.reshape(x.shape[0], nb * bs)[:, :n]


def _transfer(cols, vals, x):
    """y = T x for an ELL transfer operator (P or Pᵀ), x [k, n_in]."""
    return (vals * x[:, cols]).sum(-1)


def _panel_pass(c, dells, cols, dinvs, xfers, acinv, B, X0, tol, restart,
                max_restarts):
    """One chunk of shifted panel solves on the device (the JAX package's
    ``_panel_gmres``, ``_panel_gmres_tg`` and ``_panel_gmres_mg``).

    ``dells``/``cols``: per level the [c, n_k, w_k] shifted ELL values and
    [n_k, w_k] columns (level 0 is the solve level); ``dinvs``: per level
    the [c, nb, bs, bs] block inverses; ``xfers``: per level transition
    the (pell_cols, pell_vals, ptell_cols, ptell_vals) tensors; ``acinv``:
    [c, nc, nc] deepest-level inverses (None without a coarse level).  The
    LEFT preconditioner is block-Jacobi without ``xfers``, else one V-cycle
    (one two-grid cycle with a single transition).  ``B``/``X0``: [c·l, n]
    right-hand sides and warm starts.  Returns (X, preconditioned relres,
    restarts), each per system."""
    n_lvl = len(xfers)

    def vcycle(k, v):
        """Approximately solve A_k y = v (k = 0 is the solve level)."""
        if k == n_lvl:
            vc = v.view(c, -1, v.shape[-1])
            return torch.matmul(vc, acinv.transpose(1, 2)).view(v.shape)
        pc, pv, tc, tv = xfers[k]
        y = _block_apply(dinvs[k], v, c)
        r = v - _spmv(dells[k], cols[k], y, c)
        y = y + _transfer(pc, pv, vcycle(k + 1, _transfer(tc, tv, r)))
        r = v - _spmv(dells[k], cols[k], y, c)
        return y + _block_apply(dinvs[k], r, c)

    if n_lvl == 0:
        def minv(v):
            return _block_apply(dinvs[0], v, c)
    else:
        def minv(v):
            return vcycle(0, v)

    def matvec(x):
        return minv(_spmv(dells[0], cols[0], x, c))

    return gmres_impl(matvec, minv(B), x0=X0, tol=tol, restart=restart,
                      max_restarts=max_restarts, stagnation=0.9)


class ShiftedPanelSolver:
    """Matrix-free solver for L(z) X = B panels at many shifts, on
    ``device``.

    Built once per operator family (structure, value stack, ELL maps and
    the block-Jacobi scatter maps are shift-independent); :meth:`solve`
    takes any batch of shifts and right-hand-side panels.  The UMFPACK-per-
    node role of the reference's contour quadrature (beyn.jl:62-74), as
    chunked batched GMRES + complex128 host-residual refinement.

    The GMRES runs in complex128, as the JAX package's off a TPU, to
    ``min(tol, 0.1·refine_tol)``.  Where the port differs on purpose:
    :data:`PANEL_BUDGET` is a constant sized for an 80 GB card (JAX reads
    ``WAE_PANEL_BUDGET``, 1.5e9); a chunk holds as many shifts as remain,
    up to the budget, not a power of two (the padding bounded JAX's
    compiled shapes; here it would only add work); and :meth:`solve`'s
    info lists the shifts left above ``refine_tol`` in ``unconverged``,
    with a warning."""

    def __init__(self, family, bs: int = 64, tol: float = 1e-8,
                 restart: int = 60, max_restarts: int = 50,
                 chunk: Optional[int] = None,
                 refine_sweeps: int = 4, refine_tol: float = 1e-11,
                 coarse: Optional[CoarseGrid] = None, *, device="cuda"):
        import scipy.sparse as sp
        self.family = family
        self.coarse = coarse
        self.device = torch.device(device)
        S = family._stack()
        self.n = int(S.shape[0])
        self.bs = bs
        self.nb = -(-self.n // bs)
        self.restart = restart
        self.max_restarts = max_restarts
        self.refine_sweeps, self.refine_tol = refine_sweeps, refine_tol
        # complex128 GMRES can reach the refinement target directly
        self.tol = min(tol, 0.1 * refine_tol)
        rows = np.asarray(S.row_ids(), np.int64)
        cols = np.asarray(S.indices, np.int64)
        ecols, egather, _ = csr_to_ell(S.indptr, S.indices, self.n)
        self._levels = [_Level(S.values, ecols, egather, self.device)]
        if coarse is not None and coarse.n_fine != self.n:
            raise ValueError(f"prolongation n_fine {coarse.n_fine} != "
                             f"operator dim {self.n}")
        dev = self.device

        def xfer(pc, pv, tc, tv):
            return (torch.from_numpy(np.asarray(pc, np.int64)).to(dev),
                    torch.from_numpy(np.asarray(pv, np.complex128)).to(dev),
                    torch.from_numpy(np.asarray(tc, np.int64)).to(dev),
                    torch.from_numpy(np.asarray(tv, np.complex128)).to(dev))

        if isinstance(coarse, MultiGrid):
            self._levels += [_Level(values, ec, eg, dev)
                             for (values, _r, _c, ec, eg, _nk)
                             in coarse.levels]
            self._xfers = [xfer(*x) for x in coarse.xfers]
        elif coarse is not None:
            self._xfers = [xfer(coarse.pell_cols, coarse.pell_vals,
                                coarse.ptell_cols, coarse.ptell_vals)]
        else:
            self._xfers = []
        self._chunk = chunk
        # host-exact structure for refinement residuals
        self._sp = sp
        self._indptr = np.asarray(S.indptr)
        self._indices = np.asarray(S.indices)
        self._values128 = np.asarray(S.values, np.complex128)
        # batched block-Jacobi structure (fine level + MultiGrid levels):
        # built once, inverted per chunk with one batched LAPACK call
        self._dbb = BatchedBlockDiagInv(rows, cols, self.n, bs)
        if isinstance(coarse, MultiGrid):
            self._mg_dbb = [
                BatchedBlockDiagInv(lrows, lcols, nk, coarse.bs)
                for (_v, lrows, lcols, _ec, _eg, nk) in coarse.levels]
        # seconds, and counts: device passes (``chunks``), refinement
        # sweeps, GMRES restarts and systems solved, the largest chunk
        self.timings = {"prep_s": 0.0, "device_s": 0.0, "residual_s": 0.0,
                        "chunks": 0, "sweeps": 0, "restarts": 0,
                        "solves": 0, "chunk": 0}

    # -- host helpers ------------------------------------------------------

    def coefficients(self, zs) -> np.ndarray:
        """[B, K] exact per-shift family coefficients."""
        return family_coefficients(self.family, zs)

    def _host_csr(self, coeff):
        data = coeff @ self._values128
        return self._sp.csr_matrix((data, self._indices, self._indptr),
                                   shape=(self.n, self.n))

    def _auto_chunk(self, l: int) -> int:
        """Shifts a chunk holds within PANEL_BUDGET.  A system holds its
        basis [m+1, n] and as much again in the Gram-Schmidt temporaries,
        the [n, w] gather of a solve-level SpMV twice, and a few vectors;
        a shift holds each level's ELL values and block inverses and the
        dense coarse inverse."""
        w0 = self._levels[0].cols.shape[1]
        per_instance = (2 * (self.restart + 1) + 2 * w0 + 16) * self.n
        per_shift = sum(lv.n * lv.cols.shape[1] for lv in self._levels)
        per_shift += self.nb * self.bs * self.bs
        if isinstance(self.coarse, MultiGrid):
            bsc = self.coarse.bs
            per_shift += sum(-(-lv.n // bsc) * bsc * bsc
                             for lv in self._levels[1:])
        if self.coarse is not None:
            per_shift += 2 * self.coarse.n_coarse ** 2
        c = int(PANEL_BUDGET // ((l * per_instance + per_shift) * _CSIZE))
        return max(1, c)

    def default_group(self, l: int) -> int:
        """Natural shift-group size for a contour's node groups (one chunk)."""
        return self._chunk or self._auto_chunk(l)

    def _dinv_chunk(self, coeffs):
        """[c, nb, bs, bs] complex128 host block-Jacobi inverses, one
        batched LAPACK call over the whole chunk."""
        return self._dbb.inv(coeffs @ self._values128)

    def _mg_dinv_chunk(self, coeffs):
        """Per intermediate level: [c, nb_k, bs, bs] smoother inverses
        (batched over the chunk per level)."""
        return [dbb.inv(coeffs @ lvl[0])
                for dbb, lvl in zip(self._mg_dbb, self.coarse.levels)]

    # -- device passes -----------------------------------------------------

    def _solve_chunks(self, coeffs, B, X0=None):
        """Raw device pass: [S,K] coeffs, [S,l,n] RHS -> [S,l,n] X c128.

        ``X0``: optional [S,l,n] warm-start iterates (e.g. the solution at
        a neighbouring contour node)."""
        Sn = coeffs.shape[0]
        l = B.shape[1]
        cmax = self._chunk or self._auto_chunk(l)
        X = np.empty((Sn, l, self.n), np.complex128)
        res = np.empty((Sn, l), np.float64)
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.complex128)
                                    ).to(dev)

        for s0 in range(0, Sn, cmax):
            s1 = min(s0 + cmax, Sn)
            c = coeffs[s0:s1]
            t0 = time.perf_counter()
            dinv_host = [self._dinv_chunk(c)]
            acinv = None
            if self.coarse is not None:
                acinv = acinv_batch(self.coarse, c)
            if isinstance(self.coarse, MultiGrid):
                dinv_host += self._mg_dinv_chunk(c)
            t1 = time.perf_counter()
            ct = put(c)
            dinvs = [put(D) for D in dinv_host]
            del dinv_host
            dells = [lv.ell(ct) for lv in self._levels]
            cols = [lv.cols for lv in self._levels]
            b = put(B[s0:s1].reshape(-1, self.n))
            x0 = (put(X0[s0:s1].reshape(-1, self.n)) if X0 is not None
                  else None)
            x, r, its = _panel_pass(
                s1 - s0, dells, cols, dinvs, self._xfers,
                None if acinv is None else put(acinv), b, x0, self.tol,
                self.restart, self.max_restarts)
            X[s0:s1] = x.cpu().numpy().reshape(s1 - s0, l, self.n)
            res[s0:s1] = r.cpu().numpy().reshape(s1 - s0, l)
            its = its.cpu().numpy()
            del x, b, x0, dells, dinvs
            t2 = time.perf_counter()
            self.timings["prep_s"] += t1 - t0
            self.timings["device_s"] += t2 - t1
            tm = self.timings
            tm["chunks"] += 1
            tm["restarts"] += int(its.sum())
            tm["solves"] += (s1 - s0) * l
            tm["chunk"] = max(tm["chunk"], s1 - s0)
        return X, res

    def solve(self, zs, V, output: bool = False, X0=None):
        """X[j] = L(z_j)⁻¹ V to complex128 accuracy.

        ``zs``: [S] shifts; ``V``: [n, l] shared probe panel or [S, n, l]
        per-shift RHS.  ``X0``: optional [S, n, l] warm-start iterates.
        Returns (X [S, n, l], info): the final exact relative residuals
        per shift and column, their max, the accumulated ``timings`` (with
        the counts of device passes, sweeps, restarts and solves),
        ``restarts_per_solve``, and ``unconverged``: (shift, shift + 1,
        max relres) of every shift left above ``refine_tol`` (a warning
        names them)."""
        zs = np.asarray(zs)
        Sn = len(zs)
        V = np.asarray(V, np.complex128)
        if V.ndim == 2:
            Bfull = np.broadcast_to(V.T[None], (Sn,) + V.T.shape).copy()
        else:
            Bfull = np.ascontiguousarray(np.swapaxes(V, 1, 2))   # [S, l, n]
        if X0 is not None:
            X0 = np.ascontiguousarray(
                np.swapaxes(np.asarray(X0, np.complex128), 1, 2))
        l = Bfull.shape[1]
        coeffs = self.coefficients(zs)
        mats = [self._host_csr(coeffs[j]) for j in range(Sn)]
        # residuals are judged in the ROW-EQUILIBRATED norm ‖S(b−Ax)‖ with
        # S = diag(1/maxⱼ|Aᵢⱼ|): penalty-BC rows (Y~1e15) otherwise
        # dominate the plain norm by ~16 orders of magnitude, and the
        # device GMRES minimizes exactly this scaled (left-preconditioned)
        # residual
        srow = np.empty((Sn, self.n))
        for j in range(Sn):
            rm = np.abs(mats[j]).max(axis=1).toarray().ravel()
            srow[j] = 1.0 / np.where(rm == 0, 1.0, rm)
        bnorm = np.linalg.norm(Bfull * srow[:, None, :], axis=2)  # [S, l]
        bnorm = np.where(bnorm == 0, 1.0, bnorm)

        best, _ = self._solve_chunks(coeffs, Bfull, X0=X0)
        t_res = time.perf_counter()
        best_res = np.empty((Sn, l))
        R = np.empty_like(Bfull)
        for j in range(Sn):  # exact c128 residuals
            R[j] = Bfull[j] - (mats[j] @ best[j].T).T
            best_res[j] = np.linalg.norm(R[j] * srow[j], axis=1) / bnorm[j]
        self.timings["residual_s"] += time.perf_counter() - t_res
        prev_max = np.inf
        for sweep in range(self.refine_sweeps):
            live = np.where(np.any(best_res > self.refine_tol, axis=1))[0]
            cur_max = float(best_res.max())
            if output:
                print(f"panel refine sweep {sweep}: max relres "
                      f"{cur_max:.3e}, {len(live)} shifts live")
            # stop on convergence or stagnation (the device solver has
            # reached its attainable accuracy — keep the best iterate)
            if len(live) == 0 or cur_max > 0.25 * prev_max:
                break
            prev_max = cur_max
            self.timings["sweeps"] += 1
            dX, _ = self._solve_chunks(coeffs[live], R[live])
            cand = best[live] + dX
            t_res = time.perf_counter()
            # accept per column only if the exact residual improved
            for i, j in enumerate(live):
                Rc = Bfull[j] - (mats[j] @ cand[i].T).T
                rc = np.linalg.norm(Rc * srow[j], axis=1) / bnorm[j]
                upd = rc < best_res[j]
                best[j][upd] = cand[i][upd]
                best_res[j][upd] = rc[upd]
                R[j][upd] = Rc[upd]
            self.timings["residual_s"] += time.perf_counter() - t_res
        unconverged = [(j, j + 1, float(best_res[j].max()))
                       for j in range(Sn)
                       if best_res[j].max() > self.refine_tol]
        if unconverged:
            warnings.warn(
                f"ShiftedPanelSolver: {len(unconverged)} of {Sn} shifts "
                f"ended above refine_tol {self.refine_tol:g} (max relres "
                f"{max(r for *_, r in unconverged):.3e}, refine_sweeps "
                f"{self.refine_sweeps})", RuntimeWarning, stacklevel=2)
        info = {"relres": best_res, "max_relres": float(best_res.max()),
                "timings": dict(self.timings),
                "restarts_per_solve": (self.timings["restarts"]
                                       / max(self.timings["solves"], 1)),
                "unconverged": unconverged}
        return np.ascontiguousarray(np.swapaxes(best, 1, 2)), info


def solve_shifted_panel(family, zs, V, **kw):
    """One-shot convenience wrapper around :class:`ShiftedPanelSolver`."""
    output = kw.pop("output", False)
    return ShiftedPanelSolver(family, **kw).solve(zs, V, output=output)


__all__ = ["ShiftedPanelSolver", "solve_shifted_panel", "CoarseGrid",
           "MultiGrid", "acinv_batch", "PANEL_BUDGET"]
