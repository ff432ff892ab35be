"""Eigenvalue-branch continuation over a parameter sweep.

Counterpart of the JAX package's ``nlevp/continuation.py``.  The reference
has no continuation utility — its tutorials re-solve at each parameter
value from a hand-picked guess (the τ sweeps of
docs/src/tutorial_04_perturbation_theory.md), which hops branches whenever
another eigenvalue drifts closer to the stale guess.  ``track_branch``
formalizes the loop: after each converged solve it computes a Taylor jet
of the eigenvalue in the sweep parameter (adjoint perturbation theory,
:mod:`.perturbation`) and seeds the next solve with the extrapolated
prediction.  With ``order >= 1`` the prediction error is
O(Δp^{order+1}).

The solves and the jets run on ``device``: ``mslp`` through the fused
engines (and their kernels) where the family fits them, ``perturb_fast``
through the session's solve backend.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.timing import request
from .family import OperatorFamily, Solution
from .pade import polyval
from .perturbation import perturb_fast
from .solvers import mslp


@request("track_branch")
def track_branch(L: OperatorFamily, param: str, values: Sequence[complex],
                 z0: complex, order: int = 2, solver: Callable = mslp,
                 tol: float = 1e-11, maxiter: int = 30, output: bool = False,
                 *, device="cuda",
                 **solver_kwargs) -> Tuple[List[Optional[Solution]],
                                           List[int]]:
    """Follow one eigenvalue branch ω(param) across ``values`` on
    ``device``.

    At each sweep point the family's ``param`` is set, ``solver`` is run
    from the current prediction, and (for ``order`` > 0, at every point
    but the last) an order-``order`` Taylor jet of ω in ``param`` is
    computed to extrapolate the guess for the next point.  Returns
    ``(solutions, flags)`` aligned with ``values``; a failed solve stores
    ``None`` and continues the sweep with a zeroth-order guess.

    A jet the perturbation cannot compute (a singular factorization:
    ``np.linalg.LinAlgError``, of which ``SingularMatrixError`` is one)
    leaves the next guess at zeroth order, as in the JAX package; any
    other error (a device, build or launch fault) propagates.

    The sweep is one request of ``utils.timing``; each solve in it is a
    child span of that request.

    Example — growth-rate curve of the active Rijke mode over flame delay::

        sols, flags = track_branch(L, "τ", np.linspace(1e-4, 2e-3, 20),
                                   340 * 2 * np.pi)
        growth = [s.params["ω"].imag for s in sols if s is not None]
    """
    values = [complex(v) for v in values]
    sols: List[Optional[Solution]] = []
    flags: List[int] = []
    guess = complex(z0)
    jet = None
    prev_val = None
    for i, val in enumerate(values):
        if jet is not None:
            guess = complex(polyval(jet, val - prev_val))
        L.params[param] = val
        sol, n, flag = solver(L, guess, tol=tol, maxiter=maxiter,
                              output=False, device=device, **solver_kwargs)
        flags.append(flag)
        if flag < 0 or not np.isfinite(sol.params[sol.eigval]):
            if output:
                print(f"[track_branch] {param}={val}: solver flag {flag}, "
                      "keeping prediction as next guess")
            sols.append(None)
            jet = None  # fall back to zeroth order from the prediction
            prev_val = val
            continue
        sols.append(sol)
        guess = sol.params[sol.eigval]
        if output:
            print(f"[track_branch] {param}={val}: ω={guess} ({n} its)")
        if order > 0 and i + 1 < len(values):
            try:
                perturb_fast(sol, L, param, order, device=device)
                jet = np.asarray(sol.eigval_pert[f"{param}/Taylor"])
            except np.linalg.LinAlgError:
                jet = None  # keep sweeping with zeroth-order continuation
        prev_val = val
    return sols, flags


__all__ = ["track_branch"]
