"""Mixed-precision iterative refinement (host numpy).

Copied from the JAX package's ``ops/refine.py``: the residual is evaluated
in complex128 on the host, only the correction solve runs at the lower
precision.  Converges to complex128-level backward error in 2–4 sweeps
whenever κ(A)·ε_c64 < 1.

    x₀ = solve64(b);  repeat: r = b − A x (c128);  x += solve64(r)
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np

from ..utils.config import CDTYPE
from .sparse import CSR


def refine(A: Union[CSR, np.ndarray], b: np.ndarray,
           solve_lowprec: Callable[[np.ndarray], np.ndarray],
           iters: int = 4, tol: float = 1e-13):
    """Iteratively refine ``solve_lowprec`` (any complex64 solver) to
    complex128 accuracy; its right-hand sides are cast to complex64.

    Returns (x, relres_history)."""
    b = np.asarray(b, dtype=CDTYPE)
    matvec = (lambda v: A @ v) if not isinstance(A, np.ndarray) \
        else (lambda v: A.dot(v))
    bnorm = np.linalg.norm(b)
    bnorm = bnorm if bnorm else 1.0

    x = np.asarray(solve_lowprec(b.astype(np.complex64)), dtype=CDTYPE)
    hist = []
    for _ in range(iters):
        r = b - matvec(x)
        relres = np.linalg.norm(r) / bnorm
        hist.append(relres)
        if relres < tol:
            break
        dx = np.asarray(solve_lowprec(r.astype(np.complex64)), dtype=CDTYPE)
        x = x + dx
    hist.append(np.linalg.norm(b - matvec(x)) / bnorm)
    return x, np.asarray(hist)


__all__ = ["refine"]
