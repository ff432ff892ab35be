"""Shift-invert Arnoldi for the generalized pencil  A v = λ M v.

Counterpart of the JAX package's ``nlevp/eigs.py``.  Replaces the
reference's ARPACK dependency (``Arpack.eigs(A, M, sigma=0)`` inside every
local NLEVP solver, e.g. Householder.jl:100-101) with a restarted Arnoldi
iteration on OP = (A - σM)^{-1} M with full Gram-Schmidt, on the host over
any factorization.  Left eigenvectors come from the same factorization via
conj-transpose solves.  Where the factorization is a
:class:`..ops.device_solve.DeviceLU`, :func:`eigs_pencil_pair` runs both
Arnoldi recurrences on its device instead.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..ops.linsolve import Factorization, factorize
from ..ops.sparse import CSR
from ..utils.config import CDTYPE
from ..utils.timing import phase


def arnoldi(op: Callable[[np.ndarray], np.ndarray], v0: np.ndarray, m: int,
            reorth: bool = True):
    """m-step Arnoldi of ``op``: returns V [n, m+1], H [m+1, m], and the
    step j at which (near-)breakdown occurred (or m)."""
    n = v0.shape[0]
    V = np.zeros((n, m + 1), dtype=CDTYPE)
    H = np.zeros((m + 1, m), dtype=CDTYPE)
    beta = np.linalg.norm(v0)
    V[:, 0] = v0 / beta
    for j in range(m):
        w = op(V[:, j])
        h = V[:, :j + 1].conj().T @ w
        w = w - V[:, :j + 1] @ h
        if reorth:
            h2 = V[:, :j + 1].conj().T @ w
            w = w - V[:, :j + 1] @ h2
            h = h + h2
        H[:j + 1, j] = h
        hj = np.linalg.norm(w)
        H[j + 1, j] = hj
        if hj < 1e-14 * max(1.0, np.abs(H[:j + 1, j]).max()):
            return V[:, :j + 2], H[:j + 2, :j + 1], j + 1
        V[:, j + 1] = w / hj
    return V, H, m


def _ritz_from_arnoldi(V, H, sigma: complex):
    """Ritz pairs of OP mapped back to pencil eigenvalues λ = σ + 1/μ."""
    m = H.shape[1]
    Hm = H[:m, :m]
    mu, Y = np.linalg.eig(Hm)
    finite = np.abs(mu) > 0
    lam = np.full(m, np.inf, dtype=CDTYPE)
    lam[finite] = sigma + 1.0 / mu[finite]
    X = V[:, :m] @ Y
    # Arnoldi residual estimate for OP: |h_{m+1,m}| * |last component of y|
    if H.shape[0] > m:
        res = np.abs(H[m, m - 1]) * np.abs(Y[-1, :])
    else:
        res = np.zeros(m)
    return lam, X, res, mu


def eigs_shift_invert(A, M, nev: int = 1, sigma: complex = 0.0,
                      v0: Optional[np.ndarray] = None, m: Optional[int] = None,
                      tol: float = 1e-12, maxrestart: int = 4,
                      factor: Optional[Factorization] = None,
                      adjoint: bool = False,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """``nev`` eigenpairs of A v = λ M v nearest ``sigma``.

    With ``adjoint=True`` solves the conjugate-transposed pencil
    A' v = λ M' v using the SAME factorization of (A - σM) via trans='H'
    solves (ARPACK call pair, Householder.jl:100-101).  Without ``factor``
    it factorizes through :func:`..ops.linsolve.factorize` on ``device``.
    """
    if isinstance(A, CSR):
        n = A.shape[0]
    else:
        n = np.asarray(A).shape[0]
    if v0 is None:
        v0 = np.ones(n, dtype=CDTYPE)
    v0 = np.asarray(v0, dtype=CDTYPE)
    if m is None:
        m = min(n, max(24, 2 * nev + 12))
    m = min(m, n)

    if factor is None:
        if sigma != 0.0:
            Ad = (A.to_dense() if isinstance(A, CSR) else np.asarray(A))
            Md = (M.to_dense() if isinstance(M, CSR) else np.asarray(M))
            factor = factorize(Ad - sigma * Md, check=True, device=device)
        else:
            factor = factorize(A, check=True, device=device)

    if adjoint:
        if isinstance(M, CSR):
            MH = M.conj_transpose()
            mv = lambda x: MH @ x
        else:
            Md = np.asarray(M)
            mv = lambda x: Md.conj().T @ x
        op = lambda x: factor.solve(mv(x), trans="H")
    else:
        if isinstance(M, CSR):
            mv = lambda x: M @ x
        else:
            Md = np.asarray(M)
            mv = lambda x: Md @ x
        op = lambda x: factor.solve(mv(x))

    best = None
    for _ in range(maxrestart):
        V, H, steps = arnoldi(op, v0, m)
        lam, X, res, mu = _ritz_from_arnoldi(V, H, sigma)
        order = np.argsort(-np.abs(mu))  # largest |mu| = closest to sigma
        lam, X, res = lam[order], X[:, order], res[order]
        k = min(nev, len(lam))
        best = (lam[:k], X[:, :k])
        relres = res[:k] / np.maximum(np.abs(mu[order][:k]), 1e-300)
        if steps < m or np.all(relres < tol):
            break
        v0 = X[:, :k] @ np.ones(k)
    lam, X = best
    nrm = np.linalg.norm(X, axis=0)
    X = X / np.where(nrm == 0, 1.0, nrm)
    return lam, X


def _pair_device_fast_path(factor, A, M, v0, v0_adj, m: int, m_cache=None):
    """Dual Arnoldi on the factorization's device, then a complex128
    polish: the best Ritz pair of each side, two refined inverse-iteration
    steps and a two-sided Rayleigh quotient, so the eigentriple matches
    the host-loop path.  None on a breakdown (the host loop takes over)."""
    n = A.shape[0]
    with phase("eigs.dual_arnoldi"):
        V, H, W, G = factor.dual_arnoldi(M, v0, v0_adj, m, m_cache)
    lam, X, _res, mu = _ritz_from_arnoldi(V, H, 0.0)
    lamA, XA, _resA, muA = _ritz_from_arnoldi(W, G, 0.0)
    v = X[:, int(np.argmax(np.abs(mu)))]
    vadj = XA[:, int(np.argmax(np.abs(muA)))]
    nv, na = np.linalg.norm(v), np.linalg.norm(vadj)
    if nv == 0 or na == 0 or not (np.isfinite(nv) and np.isfinite(na)):
        return None
    v, vadj = v / nv, vadj / na
    if isinstance(A, CSR):
        mv = lambda x: A @ x
    else:
        Ad = np.asarray(A)
        mv = lambda x: Ad @ x
    if isinstance(M, CSR):
        Mmv = lambda x: M @ x
        MH = M.conj_transpose()
        MHmv = lambda x: MH @ x
    else:
        Md = np.asarray(M)
        Mmv = lambda x: Md @ x
        MHmv = lambda x: Md.conj().T @ x
    for _ in range(2):
        v = factor.solve(Mmv(v))
        v = v / np.linalg.norm(v)
        vadj = factor.solve(MHmv(vadj), trans="H")
        vadj = vadj / np.linalg.norm(vadj)
    den = np.vdot(vadj, Mmv(v))
    if den == 0 or not np.isfinite(den):
        return None
    lam1 = complex(np.vdot(vadj, mv(v)) / den)
    return (np.array([lam1], dtype=CDTYPE), v.reshape(n, 1),
            np.array([np.conj(lam1)], dtype=CDTYPE), vadj.reshape(n, 1))


def eigs_pencil_pair(A, M, nev: int = 1, v0=None, v0_adj=None,
                     m: Optional[int] = None, device="cuda", m_cache=None):
    """Right and left eigenpairs of the pencil near 0, sharing one
    factorization (:func:`..ops.linsolve.factorize` on ``device``).  Returns (lam, V, lam_adj, V_adj) sorted by |λ| (the
    eigs+sortperm block of Householder.jl:100-109).

    When the factorization is a :class:`..ops.device_solve.DeviceLU` and
    nev = 1, the direct and adjoint Arnoldi runs go to its device;
    ``m_cache`` is handed to :meth:`..ops.device_solve.DeviceLU.dual_arnoldi`
    (a dict the caller keeps while M stays the same)."""
    from ..ops.device_solve import DeviceLU
    factor = factorize(A, check=True, device=device)
    if nev == 1 and isinstance(factor, DeviceLU):
        n = A.shape[0]
        mm = min(n, max(24, 2 * nev + 12)) if m is None else min(m, n)
        vv = (np.ones(n, CDTYPE) if v0 is None or len(v0) == 0
              else np.asarray(v0, CDTYPE))
        va = (np.conj(vv) if v0_adj is None or len(v0_adj) == 0
              else np.asarray(v0_adj, CDTYPE))
        out = _pair_device_fast_path(factor, A, M, vv, va, mm, m_cache)
        if out is not None:
            return out
    lam, V = eigs_shift_invert(A, M, nev=nev, v0=v0, m=m, factor=factor)
    lam_adj, Vadj = eigs_shift_invert(A, M, nev=nev, v0=v0_adj, m=m,
                                      factor=factor, adjoint=True)
    idx = np.argsort(np.abs(lam))
    lam, V = lam[idx], V[:, idx]
    idx = np.argsort(np.abs(lam_adj))
    lam_adj, Vadj = lam_adj[idx], Vadj[:, idx]
    return lam, V, lam_adj, Vadj


__all__ = ["arnoldi", "eigs_shift_invert", "eigs_pencil_pair"]
