"""Scalar coefficient-function algebra with analytic derivatives.

Copied from the JAX package's ``nlevp/algebra.py``, complete.

An :class:`ScalarFunc` represents a scalar function ``f(z_1, ..., z_p)`` of
one or more (complex) parameters together with *all* its mixed partial
derivatives in closed form: ``f.eval(values, orders)`` returns
``∂^{orders}/∂z^{orders} f`` evaluated at ``values``.  Values are host
scalars (numpy) or torch tensors; derivative orders are Python ints.

This reproduces the semantics of the reference's coefficient algebra
(src/NLEVP/algebra.jl): ``pow0/pow1/pow2/pow_a``, ``exp(aω)``, the
time-delay ``exp(-iωτ)`` with arbitrary mixed ``∂^m_ω ∂^n_τ``, the
Gaussian-delay ("fancy flame") response ``exp(aω²-iωτ)``, state-space
admittances ``C(iωI-A)^{-1}B``, the discrete Bloch filters
``Σ y_k exp(2πikz/N)``, and the closure combinators ``z·g(z)``,
``g(z)h(z)``, ``1-g(z)``, ``1/g(z)``.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch


def _exp(z):
    if isinstance(z, torch.Tensor):
        return torch.exp(z)
    return np.exp(z)


class ScalarFunc:
    """Base class: a scalar function of ``nargs`` parameters with analytic
    mixed derivatives."""

    nargs: int = 1

    def eval(self, values: Sequence[complex], orders: Sequence[int]):
        raise NotImplementedError

    def __call__(self, *args):
        """Reference-style calling convention ``f(v_1..v_p, k_1..k_p)``
        (algebra.jl passes values then derivative orders)."""
        p = self.nargs
        values = args[:p]
        orders = args[p:] if len(args) > p else (0,) * p
        if len(orders) < p:
            orders = tuple(orders) + (0,) * (p - len(orders))
        return self.eval(tuple(values), tuple(int(o) for o in orders))

    def symbol(self, names: Sequence[str]) -> str:
        return f"f({','.join(names)})"

    # equality by construction identity — used for term-signature dedup
    def signature(self):
        return (type(self).__name__,)

    def __eq__(self, other):
        return isinstance(other, ScalarFunc) and self.signature() == other.signature()

    def __hash__(self):
        return hash(self.signature())


# ---------------------------------------------------------------------------
# monomials


def _pow_deriv(z, k: int, a) -> complex:
    """k-th derivative of z^a (algebra.jl:46-76)."""
    if k < 0:
        return complex("nan")
    if isinstance(a, int) and 0 < a < k:
        return 0.0 * z
    f = 1.0
    i = a
    for _ in range(k):
        f = f * i
        i -= 1
    if f == 0.0:
        return 0.0 * z
    return f * z ** (a - k)


class Pow(ScalarFunc):
    """z^a with analytic derivatives (pow/pow_a, algebra.jl:46-107)."""

    nargs = 1

    def __init__(self, a):
        self.a = a

    def eval(self, values, orders):
        (z,) = values
        (k,) = orders
        return _pow_deriv(z, k, self.a)

    def symbol(self, names):
        if self.a == 0:
            return ""
        if self.a == 1:
            return f"{names[0]}"
        return f"{names[0]}^{self.a}"

    def signature(self):
        return ("Pow", self.a)


pow0 = Pow(0)
pow1 = Pow(1)
pow2 = Pow(2)


def pow_a(a) -> Pow:
    return Pow(a)


class ExpAz(ScalarFunc):
    """exp(a·z); k-th derivative a^k exp(az) (algebra.jl:110-135)."""

    nargs = 1

    def __init__(self, a: complex):
        self.a = complex(a)

    def eval(self, values, orders):
        (z,) = values
        (k,) = orders
        return self.a ** k * _exp(self.a * z)

    def symbol(self, names):
        return f"exp({self.a}*{names[0]})"

    def signature(self):
        return ("ExpAz", self.a)


class ExpDelay(ScalarFunc):
    """exp(-iωτ) with mixed derivatives ∂^m_ω ∂^n_τ (algebra.jl:138-150).

    ∂^m_ω ∂^n_τ exp(aωτ) = a^m exp(aωτ) Σ_{i≤n} C(n,i)·(d^i/dτ^i τ^m)·(aω)^{n-i},
    with a = -i.
    """

    nargs = 2
    a = -1.0j

    def eval(self, values, orders):
        w, tau = values
        m, n = orders
        a = self.a
        f = 0.0
        for i in range(n + 1):
            u = _pow_deriv(tau, i, m)
            f = f + math.comb(n, i) * u * (a * w) ** (n - i)
        return f * a ** m * _exp(a * w * tau)

    def symbol(self, names):
        return f"exp(-i{names[0]}{names[1]})"

    def signature(self):
        return ("ExpDelay",)


exp_delay = ExpDelay()
tau_delay = exp_delay


class ExpPM(ExpDelay):
    """exp(s·iωτ) for s=±1 (algebra.jl:215-227)."""

    def __init__(self, s: int):
        self.s = s
        self.a = 1.0j * s

    def symbol(self, names):
        sgn = "+" if self.s > 0 else "-"
        return f"exp({sgn}i{names[0]}{names[1]})"

    def signature(self):
        return ("ExpPM", self.s)


class StateSpace(ScalarFunc):
    """g(z) = C (iz·I - A)^{-1} B + D  (state-space admittance,
    algebra.jl:158-167).  n-th derivative: (-i)^n n! C (izI-A)^{-n-1} B."""

    nargs = 1

    def __init__(self, A, B, C, D):
        self.A = np.atleast_2d(np.asarray(A, dtype=np.complex128))
        self.B = np.asarray(B, dtype=np.complex128).reshape(self.A.shape[0], -1)
        self.C = np.asarray(C, dtype=np.complex128).reshape(-1, self.A.shape[0])
        self.D = np.asarray(D, dtype=np.complex128).reshape(1, 1)

    def eval(self, values, orders):
        (z,) = values
        (n,) = orders
        M = 1.0j * z * np.eye(self.A.shape[0]) - self.A
        Minv = np.linalg.inv(M)
        f = (-1.0j) ** n * math.factorial(n) * (
            self.C @ np.linalg.matrix_power(Minv, n + 1) @ self.B
        )
        if n == 0:
            f = f + self.D
        return complex(f[0, 0])

    def symbol(self, names):
        return f"C(i{names[0]}I-A)^-1B"

    def signature(self):
        return ("StateSpace", self.A.tobytes(), self.B.tobytes(),
                self.C.tobytes(), self.D.tobytes())


def generate_stsp_z(A, B, C, D) -> StateSpace:
    return StateSpace(A, B, C, D)


class ZTimesG(ScalarFunc):
    """z·g(z); derivative by Leibniz: (z·g)^{(n)} = z g^{(n)} + n g^{(n-1)}
    (algebra.jl:169-179)."""

    nargs = 1

    def __init__(self, g):
        self.g = _wrap(g)

    def eval(self, values, orders):
        (z,) = values
        (n,) = orders
        f = z * self.g.eval((z,), (n,))
        if n > 0:
            f = f + n * self.g.eval((z,), (n - 1,))
        return f

    def symbol(self, names):
        return f"{names[0]}*g({names[0]})"

    def signature(self):
        return ("ZTimesG", self.g.signature())


def generate_z_g_z(g) -> ZTimesG:
    return ZTimesG(g)


class ExpAZ2MZIT(ScalarFunc):
    """exp(aω² - iωτ) with mixed derivatives ∂^m_ω ∂^n_τ ∂^k_a
    ("fancy flame", algebra.jl:229-274)."""

    nargs = 3

    def eval(self, values, orders):
        z, tau, a = values
        m, n, k = orders
        # f(z) = z^(n+2k); g = exp(a z^2) derivs; h = exp(-izτ) derivs in z
        def g(zz, l):
            return _exp_ax2(zz, a, l)

        def h(zz, l):
            return exp_delay.eval((zz, tau), (l, 0))

        coeff = 0.0
        for ii in range(m + 1):
            c_ii = h(z, ii)
            for jj in range(m - ii + 1):
                kk = m - jj - ii
                multi = (math.factorial(m)
                         // (math.factorial(ii) * math.factorial(jj) * math.factorial(kk)))
                coeff = coeff + multi * _pow_deriv(z, kk, n + 2 * k) * g(z, jj) * c_ii
        return coeff * (-1.0j) ** n

    def symbol(self, names):
        return f"exp({names[2]}{names[0]}^2-i{names[0]}{names[1]})"

    def signature(self):
        return ("ExpAZ2MZIT",)


exp_az2mzit = ExpAZ2MZIT()


def _exp_ax2(z, a, n: int):
    """n-th z-derivative of exp(a z²) (algebra.jl:229-253)."""
    if a == 0.0:
        return 1.0 + 0.0j if n == 0 else 0.0 + 0.0j
    f = 0.0
    cnst = 2 ** n * math.factorial(n)
    A = a ** n
    Z = z ** n
    for k in range(n // 2 + 1):
        coeff = cnst * 4.0 ** (-k) / (math.factorial(k) * math.factorial(n - 2 * k))
        f = f + coeff * A * Z
        A = A / a
        Z = Z / z ** 2
    return f * _exp(a * z ** 2)


class SumYExpIKX(ScalarFunc):
    """Σ_k y_k exp(2πi k z / N) — the discrete Bloch wavenumber filter
    (algebra.jl:276-288).  n-th derivative multiplies each mode by
    (2πik/N)^n."""

    nargs = 1

    def __init__(self, y):
        self.y = np.asarray(y, dtype=np.complex128)
        self.N = len(self.y)

    def eval(self, values, orders):
        (z,) = values
        (n,) = orders
        f = 0.0
        for k, yk in enumerate(self.y):
            f = f + k ** n * yk * _exp(2j * np.pi * k / self.N * z)
        return f * (2j * np.pi / self.N) ** n

    def symbol(self, names):
        return f"δ({names[0]})"

    def signature(self):
        return ("SumYExpIKX", self.y.tobytes())


def generate_sum_y_exp_ikx(y) -> SumYExpIKX:
    return SumYExpIKX(y)


class Product(ScalarFunc):
    """g(z)·h(z) via Leibniz (algebra.jl:290-299)."""

    nargs = 1

    def __init__(self, g, h):
        self.g = _wrap(g)
        self.h = _wrap(h)

    def eval(self, values, orders):
        (z,) = values
        (k,) = orders
        f = 0.0
        for i in range(k + 1):
            f = f + math.comb(k, i) * self.h.eval((z,), (k - i,)) * self.g.eval((z,), (i,))
        return f

    def symbol(self, names):
        return self.g.symbol(names) + "*" + self.h.symbol(names)

    def signature(self):
        return ("Product", self.g.signature(), self.h.signature())


def generate_gz_hz(g, h) -> Product:
    return Product(g, h)


class OneMinus(ScalarFunc):
    """1 - g(z) (algebra.jl:301-310)."""

    nargs = 1

    def __init__(self, g):
        self.g = _wrap(g)

    def eval(self, values, orders):
        (z,) = values
        (k,) = orders
        if k == 0:
            return 1.0 - self.g.eval((z,), (0,))
        return -self.g.eval((z,), (k,))

    def symbol(self, names):
        return f"(1-{self.g.symbol(names)})"

    def signature(self):
        return ("OneMinus", self.g.signature())


def generate_1_gz(g) -> OneMinus:
    return OneMinus(g)


class Reciprocal(ScalarFunc):
    """1/g(z) with analytic derivatives of ANY order via the Leibniz
    recurrence on g·h = 1: h⁽ᵏ⁾ = -(1/g)·Σ_{i=1..k} C(k,i) g⁽ⁱ⁾ h⁽ᵏ⁻ⁱ⁾.

    The reference's network admittances hand-code only k≤1 and return NaN
    beyond (network.jl:195-204, 228-238 — a latent limitation this
    combinator removes)."""

    nargs = 1

    def __init__(self, g, name: str = "Z"):
        self.g = _wrap(g)
        self.name = name

    def eval(self, values, orders):
        (z,) = values
        (k,) = orders
        g0 = self.g.eval((z,), (0,))
        h = [1.0 / g0]
        for n in range(1, k + 1):
            s = 0.0
            for i in range(1, n + 1):
                s = s + math.comb(n, i) * self.g.eval((z,), (i,)) * h[n - i]
            h.append(-s / g0)
        return h[k]

    def symbol(self, names):
        return f"1/{self.name}({names[0]})"

    def signature(self):
        return ("Reciprocal", self.g.signature())


def generate_1_over_gz(g, name: str = "Z") -> Reciprocal:
    return Reciprocal(g, name)


class Wrapped(ScalarFunc):
    """Adapt a user callable ``f(z, n) -> n-th derivative`` into a
    ScalarFunc (custom flame-transfer functions, tutorial 08)."""

    nargs = 1

    def __init__(self, fn: Callable, name: str = "FTF"):
        self.fn = fn
        self.name = name

    def eval(self, values, orders):
        return self.fn(values[0], orders[0])

    def symbol(self, names):
        return f"{self.name}({names[0]})"

    def signature(self):
        return ("Wrapped", id(self.fn))


class SumNExpAZ2MZIT(ScalarFunc):
    """Multi-branch fancy flame Σ_j n_j exp(a_jω²-iωτ_j)
    (algebra.jl:313-325).  Arguments: (ω, n_1, τ_1, a_1, ..., n_J, τ_J, a_J)."""

    def __init__(self, J: int):
        self.J = J
        self.nargs = 1 + 3 * J

    def eval(self, values, orders):
        z = values[0]
        m = orders[0]
        f = 0.0
        for j in range(self.J):
            nn, tau, a = values[1 + 3 * j: 4 + 3 * j]
            l, n, k = orders[1 + 3 * j: 4 + 3 * j]
            branch = ExpAZ2MZIT().eval((z, tau, a), (m, n, k))
            f = f + _pow_deriv(nn, l, 1) * branch
        return f

    def signature(self):
        return ("SumNExpAZ2MZIT", self.J)


class ZExpIAZ(ScalarFunc):
    """z·exp(s·i·a·z) with mixed derivatives up to order 1 in each argument
    (z_exp_iaz / z_exp__iaz, algebra.jl:191-210)."""

    nargs = 2

    def __init__(self, s: int):
        self.s = s
        self.a = 1.0j * s

    def eval(self, values, orders):
        z, a = values
        m, n = orders
        ia = self.a * a
        if m == 0 and n == 0:
            return z * _exp(ia * z)
        if m == 1 and n == 0:
            return (ia * z + 1) * _exp(ia * z)
        if m == 0 and n == 1:
            return self.a * z ** 2 * _exp(ia * z)
        raise NotImplementedError(
            "z_exp_iaz supports at most first derivatives")

    def symbol(self, names):
        sgn = "+" if self.s > 0 else "-"
        return f"{names[0]}*exp({sgn}i{names[1]}{names[0]})"

    def signature(self):
        return ("ZExpIAZ", self.s)


# -- raw reference-signature scalar functions (algebra.jl exports) ----------


def pow(z, k: int, a):
    """k-th derivative of z^a (pow, algebra.jl:46-75)."""
    return _pow_deriv(complex(z), int(k), a)


def exp_az(z, a, k: int = 0):
    """k-th derivative of exp(a·z) (exp_az, algebra.jl:129-135)."""
    return complex(a) ** k * _exp(complex(a) * complex(z))


def generate_exp_az(a) -> ExpAz:
    """Coefficient function exp(a·z) (generate_exp_az, algebra.jl:110-126)."""
    return ExpAz(a)


def exp_pm(s: int) -> ExpPM:
    """Coefficient function exp(s·iωτ), s=±1 (exp_pm, algebra.jl:215-227)."""
    return ExpPM(s)


def z_exp_iaz(z, a, m: int = 0, n: int = 0):
    """∂^m_z ∂^n_a of z·exp(+iaz) (z_exp_iaz, algebra.jl:191-198)."""
    return ZExpIAZ(+1).eval((complex(z), complex(a)), (m, n))


def z_exp__iaz(z, a, m: int = 0, n: int = 0):
    """∂^m_z ∂^n_a of z·exp(-iaz) (z_exp__iaz, algebra.jl:203-210)."""
    return ZExpIAZ(-1).eval((complex(z), complex(a)), (m, n))


def sum_n_exp_az2mzit(*args):
    """Raw multi-branch fancy-flame value/derivative
    (Σnexp_az2mzit, algebra.jl:313-325): args = (ω, n₁, τ₁, a₁, …,
    mω, l₁, n₁', k₁, …) — first half values, second half orders."""
    half = len(args) // 2
    J = (half - 1) // 3
    return SumNExpAZ2MZIT(J).eval(args[:half], [int(o) for o in args[half:]])


def _wrap(g) -> ScalarFunc:
    if isinstance(g, ScalarFunc):
        return g
    return Wrapped(g)


__all__ = [
    "ScalarFunc", "Pow", "pow0", "pow1", "pow2", "pow_a", "ExpAz",
    "ExpDelay", "exp_delay", "tau_delay", "ExpPM", "StateSpace",
    "generate_stsp_z", "ZTimesG", "generate_z_g_z", "ExpAZ2MZIT",
    "exp_az2mzit", "SumYExpIKX", "generate_sum_y_exp_ikx", "Product",
    "generate_gz_hz", "OneMinus", "generate_1_gz", "Reciprocal",
    "generate_1_over_gz", "Wrapped", "SumNExpAZ2MZIT", "ZExpIAZ",
    "pow", "exp_az", "generate_exp_az", "exp_pm", "z_exp_iaz", "z_exp__iaz",
    "sum_n_exp_az2mzit",
]
