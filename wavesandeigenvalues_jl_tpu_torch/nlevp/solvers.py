"""Local nonlinear-eigenvalue solvers — the front door of the port.

Counterpart of the JAX package's ``nlevp/solvers.py`` for the fused device
route: ``mslp`` and ``householder`` with ``order=1, nev=1,
num_order<=1`` run :func:`.fused_local.try_fused_local` on ``device``,
the card (``"cuda"``) unless the caller asks for the CPU.  It routes
n ≤ 1,400 to the dense engine (kernel K2) and larger n to the slab engine
(kernel K3), as the JAX package does.  Other settings (higher orders, several eigenvalues, the
host engine with perturbation theory) and the other solvers raise
``NotImplementedError``; they are ROADMAP.md Queue 1 work.

Reference implementations: src/NLEVP/{Householder.jl,iterative_solvers.jl}.
"""
from __future__ import annotations

import numpy as np

from .family import OperatorFamily
from .fused_local import try_fused_local

# ---------------------------------------------------------------------------
# status flags (iterative_solvers.jl:4-14)
ITSOL_CONVERGED = 0
ITSOL_MAXITER = 1
ITSOL_SLOW_CONVERGENCE = 2
ITSOL_IMPOSSIBLE = -1
ITSOL_SINGULAR_EXCEPTION = -2
ITSOL_EIGS_EXCEPTION = -3
ITSOL_ISNAN = -4
ITSOL_UNKNOWN = -5

_FLAG_MSG = {
    ITSOL_CONVERGED: "Solution converged, everything OK!",
    ITSOL_MAXITER: "Warning: Maximum number of iterations has been reached!",
    ITSOL_SLOW_CONVERGENCE: "Warning: Slow progress!",
    ITSOL_IMPOSSIBLE: "Error: This error should be impossible. Please contact the developers!",
    ITSOL_SINGULAR_EXCEPTION: "Error: Singular matrix (iterate may be fully converged)!",
    ITSOL_EIGS_EXCEPTION: "Error: inner eigensolver failed!",
    ITSOL_ISNAN: "Error: eigenvalue is NaN!",
    ITSOL_UNKNOWN: "Error: Unknown error occurred!",
}


def decode_error_flag(flag: int) -> str:
    """Human-readable meaning of a solver status flag (fixed re-write of the
    reference's buggy decode_error_flag, iterative_solvers.jl:22-44)."""
    return _FLAG_MSG.get(flag, "Unknown flag code.")


def _local_engine(L: OperatorFamily, z, *, maxiter, tol, relax, lam_tol,
                  order, nev, v0, v0_adj, output, num_order, scale, device):
    if not (nev == 1 and order == 1 and num_order <= 1):
        raise NotImplementedError(
            f"order={order}, nev={nev}, num_order={num_order}: only the "
            "fused order-1 single-eigenvalue route is ported (ROADMAP.md "
            "Queue 1: host _local_engine with perturbation.py)")
    return try_fused_local(L, z, maxiter=maxiter, tol=tol, relax=relax,
                           lam_tol=lam_tol, v0=v0, v0_adj=v0_adj,
                           output=output, scale=scale, device=device)


def householder(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
                lam_tol=np.inf, order=1, nev=1, v0=None, v0_adj=None,
                output=False, *, device="cuda"):
    """Generalized Rayleigh-quotient / Householder iteration
    (Householder.jl:70-192) on ``device``."""
    return _local_engine(L, z, maxiter=maxiter, tol=tol, relax=relax,
                         lam_tol=lam_tol, order=order, nev=nev, v0=v0,
                         v0_adj=v0_adj, output=output, num_order=1, scale=1,
                         device=device)


def mslp(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
         lam_tol=np.inf, order=1, nev=1, v0=None, v0_adj=None, num_order=1,
         scale=1, output=False, *, device="cuda"):
    """Method of successive linear problems (iterative_solvers.jl:93-252)
    on ``device``."""
    return _local_engine(L, z, maxiter=maxiter, tol=tol, relax=relax,
                         lam_tol=lam_tol, order=order, nev=nev, v0=v0,
                         v0_adj=v0_adj, output=output, num_order=num_order,
                         scale=scale, device=device)


__all__ = ["ITSOL_CONVERGED", "ITSOL_MAXITER", "ITSOL_SLOW_CONVERGENCE",
           "ITSOL_IMPOSSIBLE", "ITSOL_SINGULAR_EXCEPTION",
           "ITSOL_EIGS_EXCEPTION", "ITSOL_ISNAN", "ITSOL_UNKNOWN",
           "decode_error_flag", "householder", "mslp"]
