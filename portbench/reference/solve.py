"""Reference eigen-solvers and the numbers that judge an answer.

* :func:`newton` — two-sided Rayleigh-functional Newton iteration on
  L(ω)v = 0 with a sparse LU of L(ω) per step (SuperLU), in complex128 or,
  as the control, in complex64 (rows equilibrated in complex128 before
  the cast, so the 1e15 penalty rows do not swamp the rest).
* :func:`residual` — ‖D⁻¹L(ω)v‖/‖v‖ with D the row max-abs of L(ω).
* :func:`family_gap` — the largest entry of |A − B| over the largest of
  |B|, row by row.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .helmholtz import RefFamily


def _row_scale(A):
    A = A.tocsr()
    rm = np.zeros(A.shape[0])
    nz = np.diff(A.indptr) > 0
    rm[nz] = np.maximum.reduceat(np.abs(A.data), A.indptr[:-1][nz])
    rm[rm == 0] = 1.0
    return 1.0 / rm


def residual(A, v) -> float:
    """Row-equilibrated relative residual of (A, v)."""
    v = np.asarray(v, np.complex128)
    nv = np.linalg.norm(v)
    if not np.isfinite(nv) or nv == 0:
        return float("inf")
    r = _row_scale(A) * (A @ v)
    return float(np.linalg.norm(r) / nv)


def family_gap(A, B) -> float:
    """max_i max_j |A_ij − B_ij| / max_j |B_ij| (rows of B not empty)."""
    A, B = A.tocsr(), B.tocsr()
    D = (A - B).tocsr()
    D.data = np.abs(D.data)
    if D.nnz == 0:
        return 0.0
    s = _row_scale(B)
    dmax = np.zeros(B.shape[0])
    nz = np.diff(D.indptr) > 0
    dmax[nz] = np.maximum.reduceat(D.data, D.indptr[:-1][nz])
    return float(np.max(dmax * s))


def _lu(A, dtype):
    s = _row_scale(A)
    As = sp.diags(s) @ A
    F = spla.splu(As.astype(dtype).tocsc())
    return F, s


def newton(L: RefFamily, omega, params=None, tol=1e-11, maxiter=30,
           dtype=np.complex128):
    """(ω, v, converged) from the start ``omega``: per step one LU of
    L(ω) in ``dtype``, one inverse iteration on each side, and the
    Newton update of the two-sided Rayleigh functional wᴴL(ω)v = 0, all
    in ``dtype`` (the step's sum in Python's complex).  Stops at
    |dω| ≤ tol·|ω|, or where the steps stop shrinking: converged there in
    complex64, and in complex128 if the best step was within 1e3·tol."""
    z = complex(omega)
    n = L.n
    real = np.float32 if dtype == np.complex64 else np.float64
    v = np.ones(n, dtype)
    w = np.ones(n, dtype)
    MH = L.weight(params).astype(dtype)
    M, MH = MH, MH.conj().T.tocsr()
    best = np.inf
    stall = 0
    for _ in range(maxiter):
        A = L.matrix(z, params)
        F, s = _lu(A, dtype)
        s = s.astype(real)
        # A x = M v  <=>  (S A) x = S M v
        x = F.solve(s * (M @ v))
        # Aᴴ y = Mᴴ w  <=>  (S A)ᴴ (S⁻¹ y) = Mᴴ w
        y = F.solve(MH @ w, trans="H") * s
        v = x / np.linalg.norm(x)
        w = y / np.linalg.norm(y)
        num = np.vdot(w, A.astype(dtype) @ v)
        den = np.vdot(w, L.matrix(z, params, deriv=1).astype(dtype) @ v)
        dz = complex(-num / den)
        if not np.isfinite(dz):
            return z, v, False
        z = z + dz
        if abs(dz) <= tol * abs(z):
            return z, v, True
        if abs(dz) < best:
            best, stall = abs(dz), 0
        else:
            stall += 1
            if stall >= 3:
                # the steps stopped shrinking: at the rounding floor of
                # the quotient if the best step was within 1e3·tol
                return z, v, (dtype != np.complex128
                              or best <= 1e3 * tol * abs(z))
    return z, v, dtype == np.complex128 and best <= 1e3 * tol * abs(z)


__all__ = ["residual", "family_gap", "newton"]
