"""Factorizations on the device for the general local engine (and, as
:class:`DeviceLU`, for the fused engines' polish, :mod:`..nlevp.polish`).

Counterpart of the JAX package's ``ops/device_solve.py``: the reference's
UMFPACK factorization and its triangular re-solves (Householder.jl:100-101,
perturbation.jl:385) on the card, selected by
:func:`..ops.linsolve.factorize` behind the ``backend`` switch
(``utils.config.set_solve_backend``):

* :class:`DeviceLU`: the dense matrix is scattered from the CSR on
  ``device``, row-equilibrated (B = D⁻¹A; the Y = 1e15 penalty rows span 16
  orders of magnitude) and factored once with ``torch.linalg.lu_factor_ex``;
  every direct, transpose or conjugate-transpose re-solve is one
  ``lu_solve`` there, followed by the host complex128 refinement (with
  ``refine=False``, as the polish asks, one ``lu_solve`` and none).  The
  direct and adjoint shift-invert Arnoldi of the local engine run on the
  card from the same factors (:meth:`DeviceLU.dual_arnoldi`).
* :class:`DeviceGMRES`: for dimensions above ``DEVICE_DENSE_MAX_DIM``:
  restarted GMRES (:func:`.gmres.gmres_impl`) over an ELL SpMV with a LEFT
  block-Jacobi preconditioner, all right-hand sides at once, plus the same
  refinement.

Both compute in complex128, as the JAX package does on every device but a
TPU (whose complex64 and float planes the port does not copy).  Only the
right-hand sides and solutions cross between host and device
(``utils.timing``'s counters ``device_solve.to_device_bytes`` and
``device_solve.to_host_bytes`` count them, with the factorization's CSR
values).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..utils.config import CDTYPE
from ..utils import timing
from ..utils.timing import phase
from .device import EllOperator
from .gmres import _block_apply, _block_diag_inv, gmres_impl
from .linsolve import Factorization
from .sparse import CSR

#: above this dimension the "device" backend replaces the dense factor by
#: GMRES (the JAX package's value; ``parallel.dist_beyn.DENSE_BEYN_MAX_DIM``
#: is the contour's own limit, as in JAX)
DEVICE_DENSE_MAX_DIM = 4096


def _to_device(x: np.ndarray, device) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    timing.count("device_solve.to_device_bytes", x.nbytes)
    return torch.from_numpy(x).to(device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    x = t.resolve_conj().cpu().numpy()
    timing.count("device_solve.to_host_bytes", x.nbytes)
    return x


def _dense_on_device(A: Union[CSR, np.ndarray], device) -> torch.Tensor:
    """[n, n] complex128 on ``device``: a CSR's structure and values are
    copied and scattered there (no dense host copy)."""
    if not isinstance(A, CSR):
        return _to_device(np.asarray(A, CDTYPE), device)
    n = A.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    flat = _to_device(rows * A.shape[1] + A.indices, device)
    dense = torch.zeros(n * A.shape[1], dtype=torch.complex128,
                        device=device)
    dense.index_put_((flat,), _to_device(np.asarray(A.data, CDTYPE), device))
    return dense.view(n, A.shape[1])


# ---------------------------------------------------------------------------
# host-residual refinement (shared by both factorizations)


def _refined_solve(solve_dev, matvec128, B, tol: float = 1e-13,
                   maxiter: int = 10):
    """(X, max relres) with A X = B for an [n, k] panel: device solves and
    host complex128 residuals, one device call per sweep.  A column stops
    at ``tol`` relative residual, on stagnation, or at maxiter, and then
    gets no correction — near-singular systems (the local solver at
    convergence) stagnate at the attainable accuracy and the column's best
    iterate is returned, as in the JAX package."""
    B = np.asarray(B, dtype=CDTYPE)
    bnorm = np.linalg.norm(B, axis=0)
    nz = bnorm > 0
    if not nz.any():
        return np.zeros_like(B), 0.0
    scale = np.where(nz, bnorm, 1.0)
    with phase("device_solve.refine"):
        with phase("solve"):
            X = solve_dev(B)
        best_X = X.copy()
        best_res = np.full(B.shape[1], np.inf)
        prev = np.full(B.shape[1], np.inf)
        active = nz.copy()
        for _ in range(maxiter + 1):
            with phase("host_residual"):
                R = B - matvec128(X)
            relres = np.linalg.norm(R, axis=0) / scale
            upd = relres < best_res
            best_X[:, upd] = X[:, upd]
            best_res[upd] = relres[upd]
            active &= ((relres >= tol) & np.isfinite(relres)
                       & (relres <= 0.5 * prev))
            if not active.any():
                break
            prev = relres
            R[:, ~active] = 0.0
            with phase("solve"):
                X = X + solve_dev(R)
    best_X[:, ~nz] = 0.0
    return best_X, float(best_res[nz].max())


def _host_matvec(A_host, trans: str):
    """Exact complex128 matvec/matmat closure for N/T/H against the host
    operator (CSR or dense)."""
    if isinstance(A_host, CSR):
        if trans == "N":
            return lambda v: A_host @ v
        AH = A_host.conj_transpose()
        if trans == "H":
            return lambda v: AH @ v
        return lambda v: np.conj(AH @ np.conj(v))
    A = np.asarray(A_host, dtype=CDTYPE)
    if trans == "N":
        return lambda v: A @ v
    if trans == "H":
        return lambda v: A.conj().T @ v
    return lambda v: A.T @ v


def _arnoldi(op, v0: torch.Tensor, m: int):
    """m CGS2 Arnoldi steps of ``op`` from v0 on the device: V [m+1, n],
    H [m+1, m] (the JAX package's ``_dual_arnoldi_planes`` body)."""
    V = v0.new_zeros(m + 1, v0.shape[0])
    H = v0.new_zeros(m + 1, m)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    for j in range(m):
        w = op(V[j])
        Vj = V[:j + 1]
        h = Vj.conj() @ w
        w = w - Vj.T @ h
        h2 = Vj.conj() @ w
        w = w - Vj.T @ h2
        hj = torch.linalg.vector_norm(w)
        inv = torch.where(hj > 1e-30, 1.0 / hj, torch.zeros_like(hj))
        V[j + 1] = w * inv
        H[:j + 1, j] = h + h2
        H[j + 1, j] = hj
    return V, H


class _RefinedFactorization(Factorization):
    """A factorization whose device solves are refined on the host.
    Subclasses set ``_A_host`` and ``n`` and supply ``_solve_dev(B, trans)``
    for an [n, k] panel B.

    ``last_relres``: the relative residual the last refined solve reached
    (the largest of a panel's columns).  The JAX classes compute it and
    return the best iterate without it; nothing here acts on it.

    ``refine``: where False, ``solve`` is one device solve and no host
    refinement, the work of one SuperLU solve, for callers whose own
    iteration corrects the solves (the shift-invert Arnoldi of
    :mod:`..nlevp.polish`)."""

    _last_relres = float("nan")
    refine = True

    @property
    def last_relres(self) -> float:
        return self._last_relres

    def solve(self, b, trans: str = "N"):
        b = np.asarray(b, dtype=CDTYPE)
        if not self.refine:
            return self._solve_dev(b.reshape(self.n, -1),
                                   trans).reshape(b.shape)
        X, self._last_relres = _refined_solve(
            lambda R: self._solve_dev(R, trans),
            _host_matvec(self._A_host, trans), b.reshape(self.n, -1))
        return X.reshape(b.shape)


class DeviceLU(_RefinedFactorization):
    """Dense row-equilibrated LU, factored and solved on ``device`` in
    complex128.  One factorization, any number of direct / transpose /
    conjugate-transpose re-solves; the shift-invert Arnoldi and its
    adjoint share it."""

    def __init__(self, A: Union[CSR, np.ndarray], device="cuda",
                 refine: bool = True):
        self._A_host = A
        self.device = torch.device(device)
        self.refine = refine
        dense = _dense_on_device(A, self.device)
        self.n = dense.shape[0]
        # row equilibration: factor B = D⁻¹A
        scale = dense.abs().amax(dim=1)
        self._row_scale = torch.where(scale == 0,
                                      torch.ones_like(scale), scale)
        LU, piv, info = torch.linalg.lu_factor_ex(
            dense / self._row_scale[:, None])
        del dense
        # a zero pivot (info > 0) or a non-finite factor: singular
        du = LU.diagonal().abs()
        self._ok = bool((info == 0) & (torch.isfinite(du)
                                       & (du > 0)).all())
        self._fac = (LU, piv)

    @property
    def ok(self) -> bool:
        return self._ok

    def _solve_dev(self, B, trans: str):
        """One device solve of an [n, k] panel.  With B = D⁻¹A:
        N: A x = b  ⇔  B x = D⁻¹ b
        H: Aᴴ x = b ⇔  Bᴴ y = b, x = D⁻¹ y   (D real)
        T: Aᵀ x = b ⇔  Bᵀ y = b, y = conj(B⁻ᴴ conj b), x = D⁻¹ y
        (``lu_solve`` has ``adjoint`` but no transpose)."""
        LU, piv = self._fac
        bt = _to_device(B, self.device)
        s = self._row_scale[:, None]
        if trans == "N":
            x = torch.linalg.lu_solve(LU, piv, bt / s)
        elif trans == "H":
            x = torch.linalg.lu_solve(LU, piv, bt, adjoint=True) / s
        else:
            x = torch.linalg.lu_solve(LU, piv, bt.conj().resolve_conj(),
                                      adjoint=True).conj() / s
        return _to_host(x)

    def dual_arnoldi(self, M, v0, v0_adj, m: int, m_cache=None):
        """m-step direct and adjoint shift-invert Arnoldi of the pencil
        A v = λ M v on the device (OP = A⁻¹M and OP' = A⁻ᴴMᴴ from the one
        factorization, the reference's back-to-back ARPACK calls,
        Householder.jl:100-101).  Returns host complex128 (V [n, m+1],
        H [m+1, m], W, G).

        M is scattered to a dense matrix on the device.  ``m_cache``, a
        dict that the caller keeps for one solve whose M does not change,
        holds that matrix between calls (keyed by device); the caller frees
        it with the dict."""
        LU, piv = self._fac
        Md = None if m_cache is None else m_cache.get(self.device)
        if Md is None:
            Md = _dense_on_device(M, self.device)
            if m_cache is not None:
                m_cache[self.device] = Md
        rs = self._row_scale

        def op_direct(v):
            return torch.linalg.lu_solve(LU, piv, ((Md @ v) / rs)[:, None])[:, 0]

        def op_adjoint(v):
            return torch.linalg.lu_solve(LU, piv, (Md.mH @ v)[:, None],
                                         adjoint=True)[:, 0] / rs

        V, H = _arnoldi(op_direct, _to_device(np.asarray(v0, CDTYPE),
                                              self.device), m)
        W, G = _arnoldi(op_adjoint, _to_device(np.asarray(v0_adj, CDTYPE),
                                               self.device), m)
        return (_to_host(V).T, _to_host(H), _to_host(W).T, _to_host(G))


class DeviceGMRES(_RefinedFactorization):
    """Matrix-free shifted solve on ``device``: restarted GMRES over an ELL
    SpMV with LEFT block-Jacobi preconditioning, every right-hand side at
    once, plus the host complex128 refinement (``last_relres`` reports how
    far it got)."""

    def __init__(self, A: CSR, bs: int = 64, tol: float = 1e-9,
                 restart: int = 60, max_restarts: int = 50, device="cuda"):
        self._A_host = A
        self.n = A.shape[0]
        self.bs, self.tol = bs, tol
        self.restart, self.max_restarts = restart, max_restarts
        self.device = torch.device(device)
        self._sides = {"N": self._build_side(A)}

    def _build_side(self, A: CSR):
        rows, cols, vals = A.to_coo()
        Dinv = _block_diag_inv(np.asarray(rows, np.int64),
                               np.asarray(cols, np.int64),
                               np.asarray(vals, np.complex128),
                               A.shape[0], self.bs)
        ell = EllOperator.from_csr(A, device=self.device)
        timing.count("device_solve.to_device_bytes",
                     16 * ell.cols.numel() + ell.mask.numel())
        data = ell.pack(_to_device(np.asarray(A.data, CDTYPE), self.device))
        return ell.cols, data, _block_apply(_to_device(Dinv, self.device),
                                            self.n)

    def _side(self, trans: str):
        if trans not in self._sides:
            AH = self._A_host.conj_transpose()
            if trans == "T":
                AH = CSR(AH.indptr, AH.indices, np.conj(AH.data), AH.shape)
            self._sides[trans] = self._build_side(AH)
        return self._sides[trans]

    @property
    def ok(self) -> bool:
        return True

    def _solve_dev(self, B, trans: str):
        """GMRES on the k columns of an [n, k] panel at once (the batched
        GMRES takes them as [k, n] rows)."""
        cols, data, dinv = self._side(trans)
        Bt = _to_device(np.ascontiguousarray(B.T), self.device)

        def op(x):
            return dinv((data * x[:, cols]).sum(-1))

        X, _res, _its = gmres_impl(op, dinv(Bt), tol=self.tol,
                                   restart=self.restart,
                                   max_restarts=self.max_restarts)
        return _to_host(X).T


def device_factorize(A: Union[CSR, np.ndarray], backend: str = "device",
                     device="cuda"):
    """Factorization on a device backend: dense LU up to
    ``DEVICE_DENSE_MAX_DIM`` (phase ``device_solve.factor``), GMRES above
    (or forced by backend "device_lu" / "device_gmres"), on ``device``."""
    n = A.shape[0]
    if backend == "device_lu" or (backend == "device"
                                  and n <= DEVICE_DENSE_MAX_DIM):
        with phase("device_solve.factor"):
            return DeviceLU(A, device)
    if not isinstance(A, CSR):
        A = CSR.from_dense(np.asarray(A, CDTYPE))
    return DeviceGMRES(A, device=device)


__all__ = ["DeviceLU", "DeviceGMRES", "device_factorize",
           "DEVICE_DENSE_MAX_DIM"]
