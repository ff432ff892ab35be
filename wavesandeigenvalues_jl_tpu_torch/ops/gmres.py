"""Block-Jacobi inverses for the dense local solver (host numpy,
complex128), and the dense test problem the kernel K2 is checked on.

Copied from the JAX package's ``ops/gmres.py``; the iterative solvers
there (``gmres_impl``, ``gmres``, ``block_jacobi``,
``solve_shifted_batch``) are not on the ported path yet (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np


def _block_diag_inv(rows, cols, data, n: int, bs: int) -> np.ndarray:
    """[nb, bs, bs] inverted diagonal blocks of a COO matrix (duplicates
    summed); empty pad rows regularized to identity."""
    nb = (n + bs - 1) // bs
    D = np.zeros((nb, bs, bs), np.complex128)
    sel = (rows // bs) == (cols // bs)
    np.add.at(D, (rows[sel] // bs, rows[sel] % bs, cols[sel] % bs),
              data[sel])
    idx = np.arange(bs)
    dead = np.abs(D[:, idx, idx]) == 0
    D[:, idx, idx] = np.where(dead, 1.0, D[:, idx, idx])
    return np.linalg.inv(D)


def gmres_test_problem(N: int, seed: int = 0, bs: int = 128):
    """The dense GMRES test problem of the JAX package's
    ``tests/test_pallas_gmres.py:13-29`` for both sides (A and Aᴴ), with
    this module's block-Jacobi inverse.  Returns the pre-preconditioned
    P = D⁻¹G [2, N, N] and D⁻¹b [2, N] in complex64, and the complex128
    operators G (a list of two) and rhs b for the true residuals."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    A = A * 0.05 + np.diag(3.0 + rng.standard_normal(N)
                           + 1j * 0.3 * rng.standard_normal(N))
    b = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    nb = N // bs
    rows, cols = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    Ps, b0s, Gs = [], [], []
    for G in (A, A.conj().T):
        D = _block_diag_inv(rows.ravel(), cols.ravel(), G.ravel(), N, bs)
        Ps.append(np.einsum("bij,bjk->bik", D,
                            G.reshape(nb, bs, N)).reshape(N, N))
        b0s.append(np.einsum("bij,bj->bi", D, b.reshape(nb, bs)).reshape(N))
        Gs.append(G)
    return (np.stack(Ps).astype(np.complex64),
            np.stack(b0s).astype(np.complex64), Gs, b)


class BatchedBlockDiagInv:
    """Precomputed diagonal-block structure for inverting the [bs,bs]
    block-Jacobi smoother at many shifts in one shot: structure indices are
    built once, each batch is one fancy-index scatter + one batched LAPACK
    inversion."""

    def __init__(self, rows, cols, n: int, bs: int):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        self.n, self.bs = int(n), int(bs)
        self.nb = (n + bs - 1) // bs
        sel = (rows // bs) == (cols // bs)
        self.sel = np.where(sel)[0]
        self.bi = rows[self.sel] // bs
        self.ri = rows[self.sel] % bs
        self.ci = cols[self.sel] % bs
        # COO inputs may carry duplicate entries (to be summed); union-CSR
        # patterns are unique and take the direct-assignment fast path
        key = (self.bi * bs + self.ri) * bs + self.ci
        self.unique = len(np.unique(key)) == len(key)

    def inv(self, data: np.ndarray) -> np.ndarray:
        """[c, nnz] per-shift data -> [c, nb, bs, bs] inverted blocks."""
        data = np.atleast_2d(np.asarray(data, np.complex128))
        c = data.shape[0]
        D = np.zeros((c, self.nb, self.bs, self.bs), np.complex128)
        if self.unique:
            D[:, self.bi, self.ri, self.ci] = data[:, self.sel]
        else:
            np.add.at(D, (np.arange(c)[:, None], self.bi[None, :],
                          self.ri[None, :], self.ci[None, :]),
                      data[:, self.sel])
        idx = np.arange(self.bs)
        diag = D[:, :, idx, idx]
        D[:, :, idx, idx] = np.where(np.abs(diag) == 0, 1.0, diag)
        return np.linalg.inv(D)


__all__ = ["BatchedBlockDiagInv", "_block_diag_inv", "gmres_test_problem"]
