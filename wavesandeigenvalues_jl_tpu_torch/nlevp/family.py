"""Parameterized operator families  L(p) = Σ_k f_k(p)·A_k.

Host numpy, copied from the JAX package's ``nlevp/family.py`` (the npz
container is :mod:`.persist`).  Re-design of the reference's ``Term`` /
``LinearOperatorFamily`` / ``Solution`` types
(src/NLEVP/LinOpFam.jl:16-138).  The user-facing semantics match the
reference:

* named complex parameters mutable after discretization (``L.params['n']=1``),
* an eigenvalue symbol and an auxiliary-eigenvalue symbol,
* evaluation with arbitrary mixed parameter-derivative orders,
* term deduplication/merging on ``push``.

The evaluation path differs: all terms are unified onto one shared (union)
sparsity pattern (:class:`~..ops.sparse.StackedOperator`), so ``L(z)`` is a
coefficient contraction + a single structured matrix with static shapes.
"""
from __future__ import annotations

import copy
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..ops.sparse import CSR, StackedOperator
from ..utils.config import CDTYPE
from .algebra import ScalarFunc
from . import pade as _pade

AUX_OPERATOR = "__aux__"


class Term:
    """One term f_1(p_a)·f_2(p_b)···A of an operator family.

    Mirrors Term in LinOpFam.jl:16-35: ``coeff`` is the matrix, ``funcs`` the
    scalar factors, ``params`` the per-factor parameter-symbol tuples."""

    def __init__(self, coeff, funcs: Sequence[ScalarFunc] = (),
                 params: Sequence[Sequence[str]] = (), symbol: str = None,
                 operator: str = ""):
        if isinstance(coeff, CSR):
            self.coeff = coeff
        else:
            self.coeff = CSR.from_dense(np.asarray(coeff, dtype=CDTYPE))
        self.funcs = tuple(funcs)
        self.params = tuple(tuple(p) for p in params)
        self.operator = operator
        if symbol is None:
            symbol = "".join(f.symbol(p) for f, p in zip(self.funcs, self.params))
        self.symbol = symbol
        varlist: List[str] = []
        for p in self.params:
            for v in p:
                if v not in varlist:
                    varlist.append(v)
        self.varlist = varlist

    def signature(self):
        return (tuple(f.signature() for f in self.funcs), self.params)

    def coefficient(self, values: Dict[str, complex], derivs: Dict[str, int]):
        """Product of the scalar factors with given parameter values and
        derivative orders (Term call, LinOpFam.jl:466-479)."""
        c = 1.0 + 0.0j
        for f, pars in zip(self.funcs, self.params):
            vals = tuple(values[p] for p in pars)
            ords = tuple(derivs.get(p, 0) for p in pars)
            c = c * f.eval(vals, ords)
        return c

    def __repr__(self):
        s = f"{self.symbol}*" if self.symbol else ""
        return s + (self.operator or "A")


class Solution:
    """Eigentriple + asymptotic-series data (Solution, LinOpFam.jl:95-112)."""

    def __init__(self, params: Dict[str, complex], v, v_adj, eigval: str,
                 auxval: str = ""):
        self.params = dict(params)
        self.v = None if v is None else np.asarray(v, dtype=CDTYPE)
        self.v_adj = None if v_adj is None else np.asarray(v_adj, dtype=CDTYPE)
        self.eigval = eigval
        self.auxval = auxval
        self.eigval_pert: Dict[str, object] = {}
        self.v_pert: Dict[str, object] = {}

    # -- Padé evaluation ----------------------------------------------------
    def pade_(self, param: str, L: int, M: int, vector: bool = False):
        """Convert stored Taylor coefficients into an [L/M] Padé approximant
        (pade!, LinOpFam.jl:646-680)."""
        pade_key = f"{param}/[{L}/{M}]"
        taylor_key = f"{param}/Taylor"
        coeffs = np.asarray(self.eigval_pert[taylor_key])
        self.eigval_pert[pade_key] = _pade.pade(coeffs, L, M)
        if vector:
            V = np.stack(self.v_pert[taylor_key])  # [N+1, d]
            A, B = _pade.pade_vector(V, L, M)
            self.v_pert[pade_key] = (A, B)

    def __call__(self, param: str, eps, L: int = 0, M: int = 0,
                 vector: bool = False):
        """Evaluate the [L/M] Padé (default [0/0] = Taylor partial sum is NOT
        meant — matches reference: default L=M=0 gives constant; callers pass
        orders) of the eigenvalue at parameter value ``eps``
        (Solution call, LinOpFam.jl:684-699)."""
        pade_key = f"{param}/[{L}/{M}]"
        if pade_key not in self.eigval_pert or (vector and pade_key not in self.v_pert):
            self.pade_(param, L, M, vector=vector)
        a, b = self.eigval_pert[pade_key]
        de = eps - self.params[param]
        eigval = _pade.polyval(a, de) / _pade.polyval(b, de)
        if not vector:
            return eigval
        A, B = self.v_pert[pade_key]
        vec = _pade.polyval_vec(A, de) / _pade.polyval_vec(B, de)
        return eigval, vec

    def __repr__(self):
        lines = ["####Solution####",
                 f"eigval: {self.eigval} = {self.params.get(self.eigval)}"]
        for k, v in self.params.items():
            if k not in (self.eigval, self.auxval):
                lines.append(f"{k} = {v}")
        if self.auxval in self.params:
            lines.append(f"Residual: abs({self.auxval}) = "
                         f"{abs(self.params[self.auxval])}")
        return "\n".join(lines)


class OperatorFamily:
    """Σ_k f_k(params)·A_k with named mutable parameters.

    Reference: LinearOperatorFamily (LinOpFam.jl:131-186).  The first
    constructor parameter is designated the eigenvalue; the last (if more
    than one) the auxiliary eigenvalue."""

    def __init__(self, params: Sequence[str] = ("λ",),
                 values: Optional[Sequence[complex]] = None):
        params = [str(p) for p in params]
        if values is None:
            values = [complex("nan") for _ in params]
        self.terms: List[Term] = []
        self.params: Dict[str, complex] = {p: complex(v)
                                           for p, v in zip(params, values)}
        self.eigval = params[0]
        self.auxval = params[-1] if len(params) > 1 else ""
        self.active: List[str] = [self.eigval]
        self.mode = "all"
        self._stacked: Optional[StackedOperator] = None

    # -- structure ----------------------------------------------------------
    @property
    def size(self) -> int:
        return self.terms[0].coeff.shape[0] if self.terms else 0

    def push(self, term: Term):
        """Add a term, merging with an existing term of identical signature
        (push!, LinOpFam.jl:305-346)."""
        self._stacked = None
        sig = term.signature()
        for idx, t in enumerate(self.terms):
            if t.signature() == sig:
                rows_a, cols_a, vals_a = t.coeff.to_coo()
                rows_b, cols_b, vals_b = term.coeff.to_coo()
                coeff = CSR.from_coo(
                    np.concatenate([rows_a, rows_b]),
                    np.concatenate([cols_a, cols_b]),
                    np.concatenate([vals_a, vals_b]), t.coeff.shape)
                if coeff.nnz == 0:
                    del self.terms[idx]
                    self._prune_params(term)
                else:
                    self.terms[idx] = Term(coeff, t.funcs, t.params, t.symbol,
                                           t.operator)
                return
        for pars in term.params:
            for p in pars:
                if p not in self.params:
                    self.params[p] = complex("nan")
        self.terms.append(term)

    def _prune_params(self, removed: Term):
        bound = set()
        for t in self.terms:
            bound.update(t.varlist)
        for p in removed.varlist:
            if p not in bound and p in self.params:
                del self.params[p]

    def __iadd__(self, term: Term):
        self.push(term)
        return self

    # -- evaluation ---------------------------------------------------------
    def _stack(self) -> StackedOperator:
        if self._stacked is None:
            self._stacked = StackedOperator.from_csrs([t.coeff for t in self.terms])
        return self._stacked

    def coefficients(self, derivs: Optional[Dict[str, int]] = None,
                     oplist: Iterable[str] = (), in_or_ex: bool = False):
        """Per-term scalar coefficients for the requested mixed derivative,
        with the reference's skip rules (LinOpFam.jl:499-528): a term is
        dropped when a requested derivative parameter does not appear in it;
        ``__aux__`` terms are dropped unless mode == 'householder'; the
        ``oplist`` filter includes (in_or_ex=True) or excludes matching
        operators.  In 'compact'/'householder' modes the result carries the
        1/∏(orders!) Taylor scaling."""
        derivs = dict(derivs or {})
        oplist = set(oplist)
        out = np.zeros(len(self.terms), dtype=CDTYPE)
        scale = 1.0
        if self.mode in ("compact", "householder"):
            import math
            for o in derivs.values():
                scale /= math.factorial(o)
        for k, t in enumerate(self.terms):
            if oplist and ((not in_or_ex and t.operator in oplist)
                           or (in_or_ex and t.operator not in oplist)):
                continue
            if self.mode != "householder" and t.operator == AUX_OPERATOR:
                continue
            if any(o > 0 and p not in t.varlist for p, o in derivs.items()):
                continue
            out[k] = t.coefficient(self.params, derivs) * scale
        return out

    def assemble(self, derivs: Optional[Dict[str, int]] = None,
                 oplist: Iterable[str] = (), in_or_ex: bool = False) -> CSR:
        return self._stack().assemble(self.coefficients(derivs, oplist, in_or_ex))

    def __call__(self, *args, oplist=(), in_or_ex=False) -> CSR:
        """Reference calling convention (LinOpFam.jl:482-529): in mode 'all'
        the first ``len(active)`` args set the active parameter values; if
        more args follow, they are the per-active-parameter derivative
        orders.  In 'compact'/'householder' mode the args are derivative
        orders only."""
        n_act = len(self.active)
        if self.mode == "all":
            for var, val in zip(self.active, args):
                self.params[var] = complex(val)
        if self.mode == "all" and len(args) <= n_act:
            derivs = {}
        else:
            orders = args[-n_act:]
            derivs = {v: int(o) for v, o in zip(self.active, orders)}
        return self.assemble(derivs, oplist=oplist, in_or_ex=in_or_ex)

    # -- persistence (npz/json, replacing the eval-based TOML of
    #    LinOpFam.jl:196-294 / toml.jl) ------------------------------------
    def save(self, fname: str):
        from .persist import save_family
        save_family(fname, self)

    @classmethod
    def load(cls, fname: str) -> "OperatorFamily":
        from .persist import load_family
        return load_family(fname)

    def __repr__(self):
        d = self.size
        eq = "+".join(repr(t) for t in self.terms
                      if not t.operator.startswith("_"))
        pars = "\n".join(f"{k}\t{v}" for k, v in self.params.items())
        return (f"{d}×{d}-dimensional operator family: \n\n{eq}"
                f"\n\nParameters\n----------\n{pars}")

    # convenience used by solvers
    def aux_weight(self) -> CSR:
        """-coeff of the trailing __aux__ term (the solver weighting matrix
        M; householder/mslp use M = -L.terms[end].coeff)."""
        t = self.terms[-1]
        return t.coeff.scaled(-1.0)

    def ensure_aux(self):
        """Append a -λ·I __aux__ term if missing (mslp does this,
        iterative_solvers.jl:119-124)."""
        if self.terms and self.terms[-1].operator == AUX_OPERATOR:
            return
        from .algebra import pow1
        d = self.size
        eye = CSR.from_coo(np.arange(d), np.arange(d),
                           -np.ones(d, dtype=CDTYPE), (d, d))
        self.push(Term(eye, (pow1,), (("__aux__",),), "__aux__", AUX_OPERATOR))
        self.auxval = "__aux__"


def project(L: OperatorFamily, Q: np.ndarray) -> OperatorFamily:
    """Galerkin projection P(z)=Q'L(z)Q of a family onto a subspace
    (project, beyn.jl:580-595)."""
    P = OperatorFamily(["λ"])
    P.params = copy.deepcopy(L.params)
    P.eigval, P.auxval = L.eigval, L.auxval
    P.active = list(L.active)
    P.mode = L.mode
    P.terms = []
    if "λ" not in L.params:
        P.params.pop("λ", None)
    for t in L.terms:
        M = Q.conj().T @ (t.coeff @ Q)
        P.push(Term(M, t.funcs, t.params, t.symbol, t.operator))
    return P


__all__ = ["Term", "Solution", "OperatorFamily", "project", "AUX_OPERATOR"]
