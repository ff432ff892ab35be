"""Host shifted linear solves: the reference's UMFPACK role.

Host numpy/scipy, copied from the JAX package's ``ops/linsolve.py`` without
its device branches: scipy SuperLU for large sparse systems, LAPACK dense
LU below ``SPARSE_LU_MIN_DIM``.  The port uses it in the complex128 polish
after the fused device loop (:mod:`..nlevp.fused_local`).
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


def factorize(A: Union[CSR, np.ndarray], check: bool = False) -> Factorization:
    """Factorize for repeated shifted solves (the UMFPACK role,
    Householder.jl:100-101): SuperLU from ``SPARSE_LU_MIN_DIM`` on, dense
    LAPACK LU below, and, as in the JAX package's host ``factorize``, a
    dense LU retry of a sparse factorization that failed.  ``check``
    raises :class:`SingularMatrixError` only if the dense LU fails too."""
    if isinstance(A, CSR):
        if A.shape[0] >= SPARSE_LU_MIN_DIM:
            F = SparseLU(A)
            if F.ok:
                return F
        A = A.to_dense()
    F = DenseLU(A)
    if check and not F.ok:
        raise SingularMatrixError("LU factorization failed (singular matrix)")
    return F


__all__ = ["Factorization", "DenseLU", "SparseLU", "factorize",
           "SingularMatrixError", "SPARSE_LU_MIN_DIM"]
