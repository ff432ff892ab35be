"""Arbitrary-order adjoint eigenvalue perturbation (Taylor series).

Counterpart of the JAX package's ``nlevp/perturbation.py``.  The
recurrence is host complex128; only the factorization of L(0,0) and its
solves go to ``device`` (:func:`..ops.linsolve.factorize_with_fallback`
on the session's solve backend).

Computes Taylor coefficients λ_1..λ_N and v_1..v_N of an eigenpair of the
family L with respect to one parameter, to any order N, using the
adjoint-based recurrence of the reference (perturbation.jl:319-444).

The multi-index/partition tables the reference pre-generates to disk at
package build time (deps/build.jl, streamed back in perturb_disk,
perturbation.jl:390-414) are generated here lazily in memory and cached —
they are pure combinatorics and tiny.

One factorization of L(0,0) is reused for all N triangular solves; the
derivative matrices L(m,n) are assembled once per (m,n) from the family's
stacked layout and cached.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from ..ops.linsolve import factorize, factorize_with_fallback
from ..utils.config import CDTYPE
from ..utils.timing import phase
from .family import OperatorFamily, Solution


def partitions(m: int):
    """All integer partitions of m (decreasing parts)."""
    return _partitions_cached(m)


@lru_cache(maxsize=None)
def _partitions_cached(m: int) -> Tuple[Tuple[int, ...], ...]:
    if m == 0:
        return ((),)
    out = []

    def rec(rem, maxpart, cur):
        if rem == 0:
            out.append(tuple(cur))
            return
        for p in range(min(rem, maxpart), 0, -1):
            cur.append(p)
            rec(rem - p, p, cur)
            cur.pop()

    rec(m, m, [])
    return tuple(out)


def part2mult(p: Tuple[int, ...]) -> Tuple[int, ...]:
    """Partition -> multiplicity vector μ with μ[g-1] = #parts of size g
    (perturbation.jl:95-104)."""
    if not p:
        return ()
    mu = [0] * max(p)
    for i in p:
        mu[i - 1] += 1
    return tuple(mu)


def multinomcoeff(mu: Tuple[int, ...]) -> float:
    s = sum(mu)
    c = math.factorial(s)
    for g in mu:
        c //= math.factorial(g)
    return float(c)


def weigh(mu: Tuple[int, ...]) -> int:
    return sum((g + 1) * m for g, m in enumerate(mu))


@lru_cache(maxsize=None)
def multi_index_table(k: int):
    """Table for order k: {(m, n): [(mu, multinom, weight), ...]} where m is
    the eigenvalue-derivative order (= number of parts), n the
    parameter-derivative order.  Excludes the trivial (0,0) entry and the
    partition [k] itself, whose contribution is the λ_k L(1,0)v_0 term
    handled explicitly (generate_multi_indices_at_order,
    perturbation.jl:186-244)."""
    T: Dict[Tuple[int, int], List[Tuple[Tuple[int, ...], float, int]]] = {}

    def add(key, mu):
        T.setdefault(key, []).append((mu, multinomcoeff(mu), weigh(mu)))

    for n in range(1, k + 1):
        add((0, n), ())
    for m in range(1, k + 1):
        for p in partitions(m):
            if p == (k,):
                continue
            mu = part2mult(p)
            for n in range(0, k - m + 1):
                add((sum(mu), n), mu)
    return T


def perturb_series(Lmn, F00, v0, v0_adj, N: int,
                   normalize_series: bool = True, Y=None):
    """Core recurrence (perturbation.jl:374-444).

    Arguments:
      Lmn(m, n):   callable returning the (m,n)-th Taylor-scaled derivative
                   matrix (CSR) of the family w.r.t. (eigval, param)
      F00:         factorization of L(0,0)
      v0, v0_adj:  eigenpair at the expansion point
      N:           series order
      Y:           weighting matrix of the inner products (perturb_norm!,
                   perturbation.jl:487-560); None is the identity
    Returns λ coefficients [N+1] and eigenvector coefficients [N+1, d].
    """
    wt = (lambda x: x) if Y is None else (lambda x: Y @ x)
    v0 = np.asarray(v0, dtype=CDTYPE)
    v0 = v0 / np.sqrt(v0.conj() @ wt(v0))
    v0_adj = np.asarray(v0_adj, dtype=CDTYPE)
    d = v0.shape[0]
    L10_v0 = Lmn(1, 0) @ v0
    denom = v0_adj.conj() @ wt(L10_v0)
    lam = np.zeros(N + 1, dtype=CDTYPE)
    v = np.zeros((N + 1, d), dtype=CDTYPE)
    v[0] = v0
    for k in range(1, N + 1):
        r = np.zeros(d, dtype=CDTYPE)
        for (m, n), entries in multi_index_table(k).items():
            w = np.zeros(d, dtype=CDTYPE)
            for mu, multinom, weight in entries:
                coeff = multinom
                for g, mg in enumerate(mu):
                    if mg:
                        coeff = coeff * lam[g + 1] ** mg
                w = w + coeff * v[k - n - weight]
            r = r + Lmn(m, n) @ w
        lam[k] = -(v0_adj.conj() @ wt(r)) / denom
        rhs = -(r + lam[k] * L10_v0)
        v[k] = F00.solve(rhs)
        v[k] -= (v0.conj() @ wt(v[k])) * v0
        if normalize_series:
            c = 0.0 + 0.0j
            for l in range(1, k):
                c -= 0.5 * (v[l].conj() @ wt(v[k - l]))
            v[k] += c * v0
    return lam, v


def _derivatives(L: OperatorFamily, param: str):
    """Lmn(m, n): the family's (m, n)-th derivative matrix w.r.t. (the
    active eigenvalue, ``param``), assembled once per (m, n)."""
    eig = L.active[0]
    cache: Dict[Tuple[int, int], object] = {}

    def Lmn(m, n):
        if (m, n) not in cache:
            cache[(m, n)] = L.assemble({eig: m, param: n})
        return cache[(m, n)]

    return Lmn


def _family_series(L: OperatorFamily, param: str, N: int, v0, v0_adj,
                   normalize_series: bool, device="cuda"):
    Lmn = _derivatives(L, param)
    F00 = factorize_with_fallback(Lmn(0, 0), device=device)
    return perturb_series(Lmn, F00, v0, v0_adj, N,
                          normalize_series=normalize_series)


def perturb(sol: Solution, L: OperatorFamily, param: str, N: int,
            mode: str = "compact", normalize_series: bool = True, *,
            device="cuda"):
    """Attach order-N Taylor coefficients of sol's eigenvalue/eigenvector
    w.r.t. ``param`` to ``sol`` (perturb!/perturb_fast!,
    LinOpFam.jl:546-589); L(0,0) is factored on ``device``.

    ``mode='compact'`` expands a true eigenvalue of L in one of its
    parameters; ``mode='householder'`` expands the *auxiliary* eigenvalue
    λ(ω) of L(ω)-λM (the __aux__ term is included in the evaluations)."""
    saved = (L.active, dict(L.params), L.mode)
    try:
        with phase("perturb"):
            L.params = dict(sol.params)
            L.active = [sol.eigval, param]
            L.mode = mode
            lam, v = _family_series(L, param, N, sol.v, sol.v_adj,
                                    normalize_series, device)
        lam[0] = sol.params[sol.eigval]
        key = f"{param}/Taylor"
        sol.eigval_pert[key] = lam
        sol.v_pert[key] = v
    finally:
        L.active, L.params, L.mode = saved[0], saved[1], saved[2]
    return sol


# reference-compatible aliases
perturb_fast = perturb


def perturb_norm(sol: Solution, L: OperatorFamily, param: str, N: int,
                 mode: str = "compact", *, device="cuda"):
    """Y-weighted variant (perturb_norm!, perturbation.jl:487-560): uses the
    __aux__ weighting matrix Y for normalization of the series; Y and
    L(0,0) are factored on ``device``."""
    saved = (L.active, dict(L.params), L.mode)
    try:
        with phase("perturb"):
            L.params = dict(sol.params)
            L.active = [sol.eigval, param]
            L.mode = mode
            Y = L.aux_weight()
            Lmn = _derivatives(L, param)
            v0_adj = factorize(Y, device=device).solve(
                np.asarray(sol.v_adj, dtype=CDTYPE))
            F00 = factorize_with_fallback(Lmn(0, 0), device=device)
            lam, v = perturb_series(Lmn, F00, sol.v, v0_adj, N, Y=Y)
        lam[0] = sol.params[sol.eigval]
        key = f"{param}/Taylor"
        sol.eigval_pert[key] = lam
        sol.v_pert[key] = v
    finally:
        L.active, L.params, L.mode = saved[0], saved[1], saved[2]
    return sol


__all__ = ["partitions", "part2mult", "multinomcoeff", "weigh",
           "multi_index_table", "perturb_series", "perturb", "perturb_fast",
           "perturb_norm"]
