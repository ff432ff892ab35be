"""Shifted linear solves: the reference's UMFPACK role.

Counterpart of the JAX package's ``ops/linsolve.py``.  The "host" backend
is numpy/scipy: SuperLU for large sparse systems, LAPACK dense LU below
``SPARSE_LU_MIN_DIM``, a least-squares solve for the exactly singular
L(0,0) of the perturbation recurrence.  The other backends ("device",
"device_lu", "device_gmres", ``utils.config``) go to
:func:`.device_solve.device_factorize`, which factors on ``device``.  Beyn's
"host" backend, and the complex128 polish after the fused device loop
(:mod:`..nlevp.polish`) above its device limit or where its device factor
fails, ask for "host" whatever the session default.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import scipy.linalg as sla

from ..utils.config import CDTYPE
from .sparse import CSR


class SingularMatrixError(np.linalg.LinAlgError):
    pass


class Factorization:
    """Abstract factorization supporting direct and conj-transpose solves."""

    def solve(self, b, trans: str = "N"):
        raise NotImplementedError

    @property
    def ok(self) -> bool:
        return True


class DenseLU(Factorization):
    """Dense partial-pivot LU (LAPACK)."""

    def __init__(self, A: np.ndarray):
        A = np.asarray(A, dtype=CDTYPE)
        self.n = A.shape[0]
        self.lu, self.piv = sla.lu_factor(A, check_finite=False)
        self._ok = bool(np.all(np.isfinite(self.lu)))
        if self._ok:
            # exact zero pivot => singular (reference maps this to the
            # SingularException flag, Householder.jl:145-148)
            self._ok = bool(np.all(np.abs(np.diag(self.lu)) > 0))

    @property
    def ok(self) -> bool:
        return self._ok

    def solve(self, b, trans: str = "N"):
        t = {"N": 0, "T": 1, "H": 2}[trans]
        return sla.lu_solve((self.lu, self.piv), np.asarray(b, dtype=CDTYPE),
                            trans=t, check_finite=False)


class DenseQRLstsq(Factorization):
    """Least-squares (pivoted QR/SVD) fallback for exactly singular systems.

    The reference factorizes the (by construction singular) L(0,0) of the
    perturbation recurrence with ``lu(·, check=false)`` and falls back to a
    sparse QR when LU fails (perturbation.jl:329-332, 385-388); this is the
    equivalent minimum-norm solve."""

    def __init__(self, A: np.ndarray):
        self.A = np.asarray(A, dtype=CDTYPE)

    def solve(self, b, trans: str = "N"):
        A = self.A
        if trans == "T":
            A = A.T
        elif trans == "H":
            A = A.conj().T
        x, *_ = sla.lstsq(A, np.asarray(b, dtype=CDTYPE), check_finite=False,
                          lapack_driver="gelsd")
        return x


class SparseLU(Factorization):
    """Sparse LU (SuperLU) — the direct counterpart of the reference's
    UMFPACK factorization (SparseArrays.lu).  A matrix SuperLU refuses (an
    exactly singular one raises RuntimeError) gives ``ok = False``, as in
    the JAX package, and :func:`factorize` retries it as a dense LU."""

    def __init__(self, A: CSR):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
        M = sp.csr_matrix((A.data.astype(CDTYPE), A.indices, A.indptr),
                          shape=A.shape).tocsc()
        try:
            self.F = spla.splu(M)
        except RuntimeError:
            self.F, self._ok = None, False
            return
        u = self.F.U.diagonal()
        self._ok = bool(np.all(np.isfinite(u)) and np.all(u != 0))

    @property
    def ok(self) -> bool:
        return self._ok

    def solve(self, b, trans: str = "N"):
        return self.F.solve(np.asarray(b, dtype=CDTYPE), trans=trans)


#: below this dimension dense LAPACK LU beats SuperLU's symbolic overhead
SPARSE_LU_MIN_DIM = 600


def _host_factor(A: Union[CSR, np.ndarray]) -> Factorization:
    """SuperLU from ``SPARSE_LU_MIN_DIM`` on, else (or where SuperLU
    fails) dense LAPACK LU."""
    if isinstance(A, CSR):
        if A.shape[0] >= SPARSE_LU_MIN_DIM:
            F = SparseLU(A)
            if F.ok:
                return F
        A = A.to_dense()
    return DenseLU(A)


def factorize(A: Union[CSR, np.ndarray], check: bool = False,
              backend: str | None = None, device="cuda") -> Factorization:
    """Factorize for repeated shifted solves (the UMFPACK role,
    Householder.jl:100-101).  ``backend`` overrides the session default
    (``utils.config.solve_backend()``): "host" is SuperLU from
    ``SPARSE_LU_MIN_DIM`` on, dense LAPACK LU below, and, as in the JAX
    package, a dense LU retry of a sparse factorization that failed; the
    others factor on ``device`` (:mod:`.device_solve`).  ``check`` raises
    :class:`SingularMatrixError` where the factorization failed."""
    from ..utils.config import solve_backend
    backend = backend or solve_backend()
    if backend != "host":
        from .device_solve import device_factorize
        F = device_factorize(A, backend, device)
        if check and not F.ok:
            raise SingularMatrixError(
                "device LU factorization failed (singular matrix)")
        return F
    F = _host_factor(A)
    if check and not F.ok:
        raise SingularMatrixError("LU factorization failed (singular matrix)")
    return F


def factorize_with_fallback(A: Union[CSR, np.ndarray],
                            device="cuda") -> Factorization:
    """LU if it exists, else least-squares QR (the reference's
    lu-then-qr strategy for the singular L(0,0), perturbation.jl:329-332).
    On a device backend (the session's) a failed device LU falls back to
    the host path."""
    from ..utils.config import solve_backend
    backend = solve_backend()
    if backend != "host":
        from .device_solve import device_factorize
        F = device_factorize(A, backend, device)
        if F.ok:
            return F
    F = _host_factor(A)
    if F.ok:
        return F
    return DenseQRLstsq(A.to_dense() if isinstance(A, CSR) else A)


def solve(A, b, trans: str = "N", device="cuda"):
    return factorize(A, device=device).solve(b, trans)


__all__ = ["Factorization", "DenseLU", "DenseQRLstsq", "SparseLU",
           "factorize", "factorize_with_fallback", "solve",
           "SingularMatrixError", "SPARSE_LU_MIN_DIM"]
