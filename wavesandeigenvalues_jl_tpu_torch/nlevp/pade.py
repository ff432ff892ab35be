"""Padé / polynomial algebra on Taylor coefficient sequences (host numpy).

Counterpart of the JAX package's ``nlevp/pade.py``, copied: the one-point
Padé of :class:`.family.Solution` and the local engine's Padé update, the
convergence-radius and pole estimates, light polynomial classes, and the
multipoint (rational Hermite) Padé of the parameter studies.

Reference semantics: pade/pade!/polyval/estimate_pol/conv_radius
(src/NLEVP/LinOpFam.jl:622-766) and the standalone polynomial module
(src/NLEVP/polys_pade.jl)."""
from __future__ import annotations

import math

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


def estimate_pol(w):
    """Estimate pole location/strength from consecutive Taylor coefficients
    (LinOpFam.jl:736-752)."""
    w = np.asarray(w, dtype=CDTYPE)
    N = len(w)
    de = np.zeros(N - 2, dtype=CDTYPE)
    k = np.zeros(N - 2, dtype=CDTYPE)
    for j in range(1, N - 1):
        i = j  # 1-based shift: reference i=j-1 with 1-based j from 2
        denom = (i + 1) * w[j + 1] * w[j - 1] - i * w[j] ** 2
        de[j - 1] = w[j] * w[j - 1] / denom
        k[j - 1] = (i ** 2 - 1) * w[j + 1] * w[j - 1] - (i * w[j]) ** 2
    return de, k


def conv_radius(a):
    """Ratio-test convergence-radius sequence |a_n / a_{n+1}|
    (LinOpFam.jl:754-761)."""
    a = np.asarray(a)
    return np.abs(a[:-1] / a[1:]).astype(float)


def taylor_shift(p, z0):
    """Coefficients of q(z) = p(z + z0) (polynomial re-centering,
    polys_pade.jl shift)."""
    p = np.asarray(p, dtype=CDTYPE)
    n = len(p)
    q = np.zeros(n, dtype=CDTYPE)
    for i in range(n):
        for j in range(i, n):
            q[i] += p[j] * math.comb(j, i) * z0 ** (j - i)
    return q


class Polynomial:
    """Light polynomial arithmetic (Pade.Polynomial, polys_pade.jl:7)."""

    def __init__(self, coeffs):
        self.coeffs = np.trim_zeros(np.asarray(coeffs, dtype=CDTYPE), "b")
        if self.coeffs.size == 0:
            self.coeffs = np.zeros(1, dtype=CDTYPE)

    def __call__(self, z):
        return polyval(self.coeffs, z)

    def __add__(self, other):
        a, b = self.coeffs, other.coeffs
        n = max(len(a), len(b))
        out = np.zeros(n, dtype=CDTYPE)
        out[:len(a)] += a
        out[:len(b)] += b
        return Polynomial(out)

    def __mul__(self, other):
        if isinstance(other, Polynomial):
            return Polynomial(np.convolve(self.coeffs, other.coeffs))
        return Polynomial(self.coeffs * other)

    def __sub__(self, other):
        return self + (other * (-1.0))

    def derivative(self):
        c = self.coeffs
        if len(c) == 1:
            return Polynomial([0.0])
        return Polynomial(c[1:] * np.arange(1, len(c)))

    def roots(self):
        return poly_roots(self.coeffs)

    def shift(self, z0):
        return Polynomial(taylor_shift(self.coeffs, z0))

    def degree(self):
        return len(self.coeffs) - 1


class RationalPolynomial:
    """Numerator/denominator pair (rational approximants,
    polys_pade.jl)."""

    def __init__(self, num: Polynomial, den: Polynomial):
        self.num = num if isinstance(num, Polynomial) else Polynomial(num)
        self.den = den if isinstance(den, Polynomial) else Polynomial(den)

    def __call__(self, z):
        return self.num(z) / self.den(z)

    def poles(self):
        return self.den.roots()

    def zeros(self):
        return self.num.roots()


# ---------------------------------------------------------------------------
# multipoint (rational Hermite) Padé
#
# The reference sketches this in examples/Pade/pade.jl: a confluent Newton
# divided-difference table (compute_newton_polynomial, pade.jl:400-476) and
# an EMPTY ``multi_point_pade`` stub (pade.jl:501-509).  Here both are
# complete: the confluent Hermite interpolant and a general [L/M] rational
# interpolant matching Taylor data at several expansion points.


def _merge_confluent(points):
    """Merge entries sharing an expansion point into one confluent entry.

    The divided-difference recurrence divides by z_b − z_a between separate
    entries; a repeated node in two entries would hit 0/0 and silently
    propagate NaN.  Entries with identical z must carry consistent Taylor
    data on their overlap (they describe the same function) — the longer
    coefficient list wins; inconsistent overlaps raise ValueError."""
    merged: list = []       # [z, coeffs] in first-appearance order
    index: dict = {}
    for z, cf in points:
        z = complex(z)
        cf = np.asarray(cf, dtype=CDTYPE)
        if z in index:
            old = merged[index[z]][1]
            k = min(len(old), len(cf))
            scale = max(np.abs(old[:k]).max(initial=0.0),
                        np.abs(cf[:k]).max(initial=0.0), 1.0)
            if not np.allclose(old[:k], cf[:k], atol=1e-12 * scale):
                raise ValueError(
                    f"duplicate expansion point {z} with inconsistent "
                    "Taylor data; confluent interpolation requires one "
                    "consistent jet per node")
            if len(cf) > len(old):
                merged[index[z]][1] = cf
        else:
            index[z] = len(merged)
            merged.append([z, cf])
    return [(z, cf) for z, cf in merged]


def newton_polynomial(points):
    """Monomial coefficients of the confluent Newton (Hermite) interpolant.

    ``points`` is a sequence of ``(z_i, taylor_coeffs_i)`` pairs; each entry
    contributes ``len(taylor_coeffs_i)`` confluent interpolation conditions
    f^(s)(z_i)/s! = taylor_coeffs_i[s].  Degree = total conditions − 1.
    (compute_newton_polynomial, examples/Pade/pade.jl:400-476 — divided
    differences with Taylor coefficients at repeated nodes.)"""
    points = _merge_confluent(points)
    nodes: list = []       # node value per confluent slot
    table: dict = {}       # slot-range tuple -> divided difference
    slots: list = []       # point index per slot
    zs = [complex(z) for z, _ in points]
    for i, (_z, cf) in enumerate(points):
        cf = np.asarray(cf, dtype=CDTYPE)
        start = len(slots)
        k = len(cf)
        slots.extend([i] * k)
        # every sub-range of the repeated node carries the Taylor datum
        # f[z,..,z] (s+1 copies) = f^(s)(z)/s! = cf[s]
        for j in range(k):
            for s in range(k - j):
                table[(start + j, start + j + s + 1)] = cf[s]
        nodes.extend([zs[i]] * k)
    n = len(slots)
    for width in range(2, n + 1):
        for j in range(n - width + 1):
            key = (j, j + width)
            if key in table:
                continue
            za, zb = nodes[j], nodes[j + width - 1]
            table[key] = (table[(j + 1, j + width)]
                          - table[(j, j + width - 1)]) / (zb - za)
    # expand Newton form into monomial coefficients
    coeffs = np.zeros(n, dtype=CDTYPE)
    basis = np.zeros(n, dtype=CDTYPE)
    basis[0] = 1.0
    deg = 0
    for k in range(n):
        coeffs[:deg + 1] += table[(0, k + 1)] * basis[:deg + 1]
        if k < n - 1:
            # basis *= (z - nodes[k])
            nb = np.zeros(n, dtype=CDTYPE)
            nb[1:deg + 2] = basis[:deg + 1]
            nb[:deg + 1] -= nodes[k] * basis[:deg + 1]
            basis, deg = nb, deg + 1
    return coeffs


class MultipointPade:
    """Rational Hermite interpolant P(ζ)/Q(ζ) in the centered/scaled
    variable ζ = (z − z0)/scale.  Callable in the original variable; poles
    and zeros are mapped back to it."""

    def __init__(self, a, b, z0: complex, scale: float):
        self.a = np.asarray(a, dtype=CDTYPE)
        self.b = np.asarray(b, dtype=CDTYPE)
        self.z0 = complex(z0)
        self.scale = float(scale)

    def __call__(self, z):
        zeta = (np.asarray(z) - self.z0) / self.scale
        return polyval(self.a, zeta) / polyval(self.b, zeta)

    def poles(self):
        return self.z0 + self.scale * poly_roots(self.b)

    def zeros(self):
        return self.z0 + self.scale * poly_roots(self.a)


def multipoint_pade(L: int, M: int, points, z0=None, scale=None):
    """[L/M] rational Hermite interpolation ("multipoint Padé") matching
    given Taylor data at several expansion points in the confluent sense —
    the completed version of the reference's stub (multi_point_pade,
    examples/Pade/pade.jl:501-509, whose ``Z0`` kwarg is the same centering
    knob).

    ``points``: sequence of ``(z_i, taylor_coeffs_i)``; the total number of
    Taylor coefficients must equal L+M+1.  Conditions are linearized:
    d^r/dz^r [P − f·Q](z_i) = 0 for r < len(taylor_coeffs_i).  The system
    is assembled in the centered/scaled variable ζ = (z − z0)/scale (by
    default z0 = centroid of the expansion points, scale = their spread) —
    essential for conditioning when the physical parameter lives at small
    scales (e.g. flame delays τ ~ 1e-3 s).  Returns a callable
    :class:`MultipointPade`."""
    # duplicate nodes would stamp duplicate rows (rank-deficient lstsq →
    # silently under-determined fit); merge them into one confluent jet
    points = _merge_confluent(points)
    n_cond = sum(len(cf) for _z, cf in points)
    if n_cond != L + M + 1:
        raise ValueError(f"need L+M+1 = {L + M + 1} Taylor coefficients "
                         f"across all points (after merging duplicate "
                         f"expansion points), got {n_cond}")
    zsp = [complex(z) for z, _ in points]
    if z0 is None:
        z0 = sum(zsp) / len(zsp)
    if scale is None:
        scale = max((abs(z - z0) for z in zsp), default=1.0) or 1.0

    def dmono(k, r, z):
        """d^r/dζ^r ζ^k."""
        if r > k:
            return 0.0 + 0.0j
        return (math.factorial(k) // math.factorial(k - r)) * z ** (k - r)

    A = np.zeros((n_cond, L + M + 1), dtype=CDTYPE)
    y = np.zeros(n_cond, dtype=CDTYPE)
    row = 0
    for z, cf in points:
        zeta = (complex(z) - z0) / scale
        cf = np.asarray(cf, dtype=CDTYPE)
        # ζ-derivatives: dᵏf/dζᵏ = scaleᵏ·dᵏf/dzᵏ, and Taylor coeffs carry
        # the 1/k! already
        fder = [math.factorial(s) * cf[s] * scale ** s
                for s in range(len(cf))]
        for r in range(len(cf)):
            for l in range(L + 1):
                A[row, l] = dmono(l, r, zeta)
            for m in range(1, M + 1):
                acc = 0.0 + 0.0j
                for s in range(r + 1):
                    acc += math.comb(r, s) * fder[s] * dmono(m, r - s, zeta)
                A[row, L + m] = -acc
            # b_0 = 1 contribution moves to the RHS
            y[row] = sum(math.comb(r, s) * fder[s] * dmono(0, r - s, zeta)
                         for s in range(r + 1))
            row += 1
    x = np.linalg.lstsq(A, y, rcond=None)[0]
    a = x[:L + 1]
    b = np.concatenate([[1.0 + 0.0j], x[L + 1:]])
    return MultipointPade(a, b, z0, scale)


__all__ = ["pade", "pade_vector", "polyval", "polyval_vec", "poly_roots",
           "estimate_pol", "conv_radius", "taylor_shift", "Polynomial",
           "newton_polynomial", "multipoint_pade", "MultipointPade",
           "RationalPolynomial"]
