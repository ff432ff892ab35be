"""Domain-agnostic nonlinear-eigenvalue (NLEVP) engine of the port:
operator families, the coefficient algebra of the flagship family, the
npz loader, the fused-device local solvers and Beyn's contour solver."""
from .algebra import ExpDelay, Pow, ScalarFunc, exp_delay, pow1, pow2
from .family import AUX_OPERATOR, OperatorFamily, Solution, Term
from .persist import load_family
from .solvers import (beyn, count_poles_and_zeros, decode_error_flag,
                      householder, mslp)

__all__ = ["ExpDelay", "Pow", "ScalarFunc", "exp_delay", "pow1", "pow2",
           "AUX_OPERATOR", "OperatorFamily", "Solution", "Term",
           "load_family", "decode_error_flag", "householder", "mslp", "beyn",
           "count_poles_and_zeros"]
