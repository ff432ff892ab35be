"""Domain-agnostic nonlinear-eigenvalue (NLEVP) engine of the port:
operator families, the coefficient algebra, persistence (the npz
container and the reference's TOML dialect), state-space fitting, the local
solvers (the fused device engines and the general engine with
arbitrary-order perturbation theory and Padé updates), Beyn's contour
solver and the hybrid ``solve``, the parameter studies (branch
continuation, multipoint Padé), the batched Bloch wavenumber sweep, and a
gallery of benchmark problems."""
from .algebra import (ExpAz, ExpDelay, ExpPM, OneMinus, Pow, Product,
                      Reciprocal, ScalarFunc, StateSpace, SumYExpIKX, Wrapped,
                      ZExpIAZ, ZTimesG, exp_az, exp_az2mzit, exp_delay,
                      exp_pm, generate_1_gz, generate_1_over_gz,
                      generate_exp_az, generate_gz_hz, generate_stsp_z,
                      generate_sum_y_exp_ikx, generate_z_g_z, pow, pow0,
                      pow1, pow2, pow_a, sum_n_exp_az2mzit, tau_delay,
                      z_exp__iaz, z_exp_iaz)
from .family import AUX_OPERATOR, OperatorFamily, Solution, Term, project
from .pade import (MultipointPade, Polynomial, RationalPolynomial,
                   conv_radius, estimate_pol, multipoint_pade,
                   newton_polynomial, pade, pade_vector, poly_roots, polyval,
                   polyval_vec, taylor_shift)
from .perturbation import (multi_index_table, part2mult, partitions, perturb,
                           perturb_fast, perturb_norm)
from .fitting import fit_state_space
from .persist import load_family, read_solution, save_family, save_solution
from .toml_compat import (load_family_toml, load_solution_toml, read_toml,
                          save_family_toml, save_solution_toml)
from .solvers import (beyn, compute_moment_matrices, count_poles_and_zeros,
                      decode_error_flag, gauss_nodes, generate_subspace,
                      guettel, householder, householder_update, initialize_V,
                      inpoly, inveriter, juniper, lancaster, mehrmann,
                      moments2eigs, mslp, nicoud, padesolve, picard, pos_test,
                      rf2s, row_equilibrated_residual, solve, traceiter,
                      verify_eigenpairs, wn)
from .continuation import track_branch
from .bloch_sweep import bloch_mode_sweep
from . import gallery

# reference-compatible aliases
LinearOperatorFamily = OperatorFamily
read_sol = read_solution


def save(fname: str, obj):
    """Persist an OperatorFamily or Solution by type dispatch
    (save, LinOpFam.jl:231 / save.jl:2)."""
    if isinstance(obj, OperatorFamily):
        return save_family(fname, obj)
    if isinstance(obj, Solution):
        return save_solution(fname, obj)
    raise TypeError(f"cannot save object of type {type(obj).__name__}")


__all__ = [n for n in dir() if not n.startswith("_")]
