"""Padé algebra on Taylor coefficient sequences — the part of the JAX
package's ``nlevp/pade.py`` that :class:`.family.Solution` and the Padé
update of the local engine use (host numpy).  The rest (multipoint Padé,
polynomial classes, convergence radii) belongs to the parameter-study
slice, ROADMAP.md Queue 1.

Reference semantics: pade/pade!/polyval (src/NLEVP/LinOpFam.jl:622-730)."""
from __future__ import annotations

import numpy as np

from ..utils.config import CDTYPE


def pade(w, L: int, M: int):
    """Taylor -> [L/M] Padé: returns numerator coeffs ``a`` (len L+1) and
    denominator coeffs ``b`` (len M+1, b[0]=1); solves the M×M Toeplitz
    system (LinOpFam.jl:622-642)."""
    w = np.asarray(w, dtype=CDTYPE)
    A = np.zeros((M, M), dtype=CDTYPE)
    for i in range(1, M + 1):
        for j in range(1, M + 1):
            if L + i - j >= 0:
                A[i - 1, j - 1] = w[L + i - j]
    if M > 0:
        rhs = -w[L + 1:L + M + 1]
        b = np.linalg.solve(A, rhs) if M > 0 else np.zeros(0, dtype=CDTYPE)
    else:
        b = np.zeros(0, dtype=CDTYPE)
    b = np.concatenate([[1.0 + 0j], b])
    a = np.zeros(L + 1, dtype=CDTYPE)
    for l in range(L + 1):
        for m in range(l + 1):
            if m <= M:
                a[l] += w[l - m] * b[m]
    return a, b


def pade_vector(V, L: int, M: int):
    """Per-component Padé of a vector-valued Taylor series ``V[k, :]``
    (pade! vector branch, LinOpFam.jl:655-677)."""
    d = V.shape[1]
    A = np.zeros((L + 1, d), dtype=CDTYPE)
    B = np.zeros((M + 1, d), dtype=CDTYPE)
    for i in range(d):
        a, b = pade(V[:, i], L, M)
        A[:, i] = a
        B[:, i] = b
    return A, B


def polyval(p, z):
    """Horner evaluation of Σ p[i] z^i (LinOpFam.jl:715-730)."""
    p = np.asarray(p)
    f = p[-1]
    for i in range(len(p) - 2, -1, -1):
        f = f * z + p[i]
    return f


def polyval_vec(P, z):
    """Horner on stacked per-component coefficients P[k, :]."""
    f = P[-1].copy()
    for i in range(P.shape[0] - 2, -1, -1):
        f = f * z + P[i]
    return f


def poly_roots(p):
    """Roots of Σ p[i] z^i via the companion matrix
    (Householder.jl:195-203)."""
    p = np.asarray(p, dtype=CDTYPE)
    N = len(p) - 1
    while N > 0 and p[N] == 0:
        N -= 1
    if N == 0:
        return np.zeros(0, dtype=CDTYPE)
    C = np.zeros((N, N), dtype=CDTYPE)
    for i in range(1, N):
        C[i, i - 1] = 1.0
    C[:, N - 1] = -p[:N] / p[N]
    return np.linalg.eigvals(C)


__all__ = ["pade", "pade_vector", "polyval", "polyval_vec", "poly_roots"]
