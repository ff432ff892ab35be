"""Gallery of benchmark NLEVPs for testing (gallery.jl), host numpy.

Copied from the JAX package's ``nlevp/gallery.py``.  Fixtures mirror the
reference's src/NLEVP/gallery.jl: Chebyshev differentiation (`cheb`),
Orr-Sommerfeld, biharmonic membrane, and a 1-D Rijke-tube FEM model
exposing the full K/M/C/Q n-τ structure at toy size, plus the 3×3
quadratic problem of the Betcke et al. NLEVP collection used throughout
tutorial 00 (known eigenvalue 1/3; 5 of its 6 eigenvalues lie in the
square [-2-2i, 2+2i])."""
from __future__ import annotations

import numpy as np

from ..ops.sparse import CSR
from ..utils.config import CDTYPE
from .algebra import exp_delay, pow1, pow2, pow_a
from .family import OperatorFamily, Term


def cheb(N: int):
    """Chebyshev differentiation matrix and grid (Trefethen; gallery.jl:12-33)."""
    if N == 0:
        return 0.0, 1.0
    x = np.cos(np.pi / N * np.arange(N + 1))
    c = np.concatenate([[2.0], np.ones(N - 1), [2.0]]) * (-1.0) ** np.arange(N + 1)
    X = np.tile(x[:, None], (1, N + 1))
    dX = X - X.T
    I = np.eye(N + 1)
    D = np.outer(c, 1.0 / c) / (dX + I)
    D -= np.diag(D.sum(axis=1))
    return D, x


def orr_sommerfeld(N: int = 64, Re: float = 5772.0, omega: float = 0.26943):
    """Orr-Sommerfeld spatial-stability NLEVP, quartic in the wavenumber λ
    (gallery.jl:70-96)."""
    N = N + 1
    D, y = cheb(N)
    D2 = (D @ D)[1:N, 1:N]
    S = np.diag(np.concatenate([[0.0], 1.0 / (1.0 - y[1:N] ** 2), [0.0]]))
    D4 = (np.diag(1.0 - y ** 2) @ np.linalg.matrix_power(D, 4)
          - 8 * np.diag(y) @ np.linalg.matrix_power(D, 3) - 12 * D @ D) @ S
    D4 = D4[1:N, 1:N]
    I = np.eye(N - 1, dtype=CDTYPE)
    D2 = D2.astype(CDTYPE)
    D4 = D4.astype(CDTYPE)
    U = np.diag(-y[1:N] ** 2 + 1.0).astype(CDTYPE)

    L = OperatorFamily(["λ", "ω", "Re", "a"],
                       [1.0, omega, Re, complex("inf")])
    L.push(Term(I, (pow_a(4),), (("λ",),), "λ^4", "I"))
    L.push(Term(1j * U, (pow_a(3), pow1), (("λ",), ("Re",)), "iλ^3Re", "i*U"))
    L.push(Term(-2 * D2, (pow2,), (("λ",),), "λ^2", "-2D2"))
    L.push(Term(-1j * I, (pow2, pow1, pow1), (("λ",), ("ω",), ("Re",)),
                "λ^2*ω*Re", "-i*I"))
    L.push(Term(-1j * (U @ D2 + 2.0 * I), (pow1, pow1), (("λ",), ("Re",)),
                "λ*Re", "(U*D2+2*I)"))
    L.push(Term(1j * D2, (pow1, pow1), (("ω",), ("Re",)), "ω*Re", "i*D2"))
    L.push(Term(D4, (), (), "", "D4"))
    L.push(Term(-I, (pow1,), (("a",),), "-a", "__aux__"))
    return L, y


def biharmonic(N: int = 12, scaleX: float = 2.0, scaleY: float = 1 + np.sqrt(5)):
    """Biharmonic membrane eigenproblem with inhomogeneity εcos(2πx)cos(πy)
    (gallery.jl:126-157)."""
    N = N + 1
    D, xx = cheb(N)
    x = xx / scaleX
    y = xx / scaleY
    Dx = D * scaleX
    Dy = D * scaleY
    D2x = (Dx @ Dx)[1:N, 1:N]
    D2y = (Dy @ Dy)[1:N, 1:N]
    I = np.eye(N - 1, dtype=CDTYPE)
    Lap = np.kron(I, D2x) + np.kron(D2y, I)
    X = np.kron(np.ones(N - 1), x[1:N])
    Y = np.kron(y[1:N], np.ones(N - 1))
    P = np.diag(np.cos(np.pi * 2 * X) * np.cos(np.pi * Y)).astype(CDTYPE)
    D4 = Lap @ Lap
    I2 = np.eye((N - 1) ** 2, dtype=CDTYPE)
    L = OperatorFamily(["λ", "ε", "a"], [0.0, 0.0, complex("inf")])
    L.push(Term(D4, (), (), "", "D4"))
    L.push(Term(P, (pow1,), (("ε",),), "ε", "P"))
    L.push(Term(-I2, (pow1,), (("λ",),), "-λ", "I"))
    L.push(Term(-I2, (pow1,), (("a",),), "-a", "__aux__"))
    return L, x, y


def rijke_tube(resolution: int = 127, l: float = 1.0, c_max: float = 2.0,
               mid: int = 0):
    """1-D Rijke tube FEM with the full M/K/C/Q n-τ structure of the 3-D
    Helmholtz model at toy size (gallery.jl:171-260).

    ∇c²(x)∇p + ω²p − n·exp(−iωτ)·∇p(x_ref) = 0 on ]0,l[, ∇p(0)=p(l)=0.
    """
    n_val = 1.0
    tau = 2.0
    c_min = 1.0
    outlet = resolution - 1  # 0-based last node
    outlet_c = c_max
    grid = np.linspace(0.0, l, resolution)
    e2p = [(i, i + 1) for i in range(resolution - 1)]
    if mid == 0:
        mid = resolution // 2 + 1  # 1-based element index of the flame
    ref = mid - 1  # 1-based reference element
    e2v = np.diff(grid)
    V = e2v[mid - 1]
    e2c = np.array([c_min if (i + 1) < mid else c_max
                    for i in range(resolution)])

    rows, cols, mvals, kvals = [], [], [], []
    m_unit = np.array([[2.0, 1.0], [1.0, 2.0]]) / 6.0
    k_unit = -np.array([[1.0, -1.0], [-1.0, 1.0]])
    for idx, (p0, p1) in enumerate(e2p):
        for a, i in enumerate((p0, p1)):
            for b, j in enumerate((p0, p1)):
                rows.append(i)
                cols.append(j)
                mvals.append(m_unit[a, b] * e2v[idx])
                kvals.append(k_unit[a, b] / e2v[idx] * e2c[idx] ** 2)
    shape = (resolution, resolution)
    M = CSR.from_coo(rows, cols, np.array(mvals, dtype=CDTYPE), shape)
    K = CSR.from_coo(rows, cols, np.array(kvals, dtype=CDTYPE), shape)
    B = CSR.from_coo([outlet], [outlet], [-1j * outlet_c], shape)

    # flame matrix: rank-one source ⊗ reference-gradient (gallery.jl:228-251)
    grad_p_ref = np.array([-1.0, 1.0]) / e2v[ref - 1]
    qr_, qc, qv = [], [], []
    el = mid - 1  # 0-based flame element
    for a, i in enumerate(e2p[el]):
        for b, j in enumerate(e2p[ref - 1]):
            qr_.append(i)
            qc.append(j)
            qv.append(grad_p_ref[b] * e2v[el] / 2.0)
    Q = CSR.from_coo(qr_, qc, -np.array(qv, dtype=CDTYPE) / V, shape)

    L = OperatorFamily(["ω", "n", "τ", "Y", "λ"],
                       [0.0, n_val, tau, 1e15, complex("inf")])
    L.push(Term(M, (pow2,), (("ω",),), "ω^2", "M"))
    L.push(Term(K, (), (), "", "K"))
    L.push(Term(B, (pow1, pow1), (("ω",), ("Y",)), "ω*Y", "C"))
    L.push(Term(Q, (pow1, exp_delay), (("n",), ("ω", "τ")),
                "n*exp(-i ω τ)", "Q"))
    L.push(Term(M.scaled(-1.0), (pow1,), (("λ",),), "-λ", "__aux__"))
    return L, grid


def qep3():
    """The 3×3 quadratic problem T(λ)=λ²A2+λA1+A0 from the Betcke et al.
    NLEVP collection (docs/src/tutorial_00_NLEVP.md:29-99); eigenvalue 1/3
    is reachable from guess 0; 5 of 6 eigenvalues lie inside the square
    with corners ±2±2i."""
    A2 = np.array([[0, 6, 0], [0, 6, 0], [0, 0, 1]], dtype=CDTYPE)
    A1 = np.array([[1, -6, 0], [2, -7, 0], [0, 0, 0]], dtype=CDTYPE)
    A0 = np.eye(3, dtype=CDTYPE)
    T = OperatorFamily(["λ"])
    T.push(Term(A2, (pow2,), (("λ",),), "λ^2", "A2"))
    T.push(Term(A1, (pow1,), (("λ",),), "λ", "A1"))
    T.push(Term(A0, (), (), "", "A0"))
    return T


__all__ = ["cheb", "orr_sommerfeld", "biharmonic", "rijke_tube", "qep3"]
