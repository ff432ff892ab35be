"""Scalar coefficient-function algebra with analytic derivatives.

Copied from the JAX package's ``nlevp/algebra.py``, restricted to the
functions the ported ``discretize`` front-end and the gallery use: the
monomials ``pow1/pow2/pow_a``, the time delay ``exp(-iωτ)`` of the n–τ
flame, and the Bloch factors ``exp(az)``, the discrete wavenumber filter
``Σ y_k exp(2πikz/N)``, the product ``g(z)h(z)`` and ``1-g(z)``.  The
other coefficient functions (state-space admittances, fancy flame, the
other combinators) are ROADMAP.md Queue 1 work.

An :class:`ScalarFunc` represents a scalar function ``f(z_1, ..., z_p)`` of
one or more (complex) parameters together with *all* its mixed partial
derivatives in closed form: ``f.eval(values, orders)`` returns
``∂^{orders}/∂z^{orders} f`` evaluated at ``values``.  Values are host
scalars (numpy) or torch tensors; derivative orders are Python ints.

Reference semantics: src/NLEVP/algebra.jl.
"""
from __future__ import annotations

import math
from typing import Sequence

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
        self.g = g
        self.h = h

    def eval(self, values, orders):
        (z,) = values
        (k,) = orders
        f = 0.0
        for i in range(k + 1):
            f = f + (math.comb(k, i) * self.h.eval((z,), (k - i,))
                     * self.g.eval((z,), (i,)))
        return f

    def symbol(self, names):
        return self.g.symbol(names) + "*" + self.h.symbol(names)

    def signature(self):
        return ("Product", self.g.signature(), self.h.signature())


class OneMinus(ScalarFunc):
    """1 - g(z) (algebra.jl:301-310)."""

    nargs = 1

    def __init__(self, g):
        self.g = g

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


__all__ = ["ScalarFunc", "Pow", "pow1", "pow2", "pow_a", "ExpAz", "ExpDelay",
           "exp_delay", "SumYExpIKX", "generate_sum_y_exp_ikx", "Product",
           "OneMinus"]
