"""Domain-agnostic nonlinear-eigenvalue (NLEVP) engine of the port:
operator families, the coefficient algebra, the npz loader, the local
solvers (the fused device engines and the general engine with
arbitrary-order perturbation theory and Padé updates), Beyn's contour
solver and the hybrid ``solve``, and a gallery of benchmark problems."""
from .algebra import ExpDelay, Pow, ScalarFunc, exp_delay, pow1, pow2, pow_a
from .family import AUX_OPERATOR, OperatorFamily, Solution, Term
from .pade import pade, poly_roots, polyval
from .perturbation import (multi_index_table, part2mult, partitions, perturb,
                           perturb_fast, perturb_norm)
from .persist import load_family
from .solvers import (beyn, compute_moment_matrices, count_poles_and_zeros,
                      decode_error_flag, gauss_nodes, generate_subspace,
                      guettel, householder, householder_update, initialize_V,
                      inpoly, inveriter, juniper, lancaster, mehrmann,
                      moments2eigs, mslp, nicoud, padesolve, picard, pos_test,
                      rf2s, row_equilibrated_residual, solve, traceiter,
                      verify_eigenpairs, wn)
from . import gallery

__all__ = [n for n in dir() if not n.startswith("_")]
