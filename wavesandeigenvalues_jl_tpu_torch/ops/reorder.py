"""Bandwidth-reducing row reordering (Cuthill–McKee), copied from the JAX
package's ``ops/reorder.py``.

Reordering fills the dense blocks of the BSR layout (:mod:`.device`).  As
in the JAX package, the reverse ordering is the native C++ BFS
(:func:`..native.rcm`, built from the same source), so it gives the JAX
package's permutation.  The numpy/deque BFS (:func:`cuthill_mckee_numpy`,
the JAX package's fallback) orders equal-degree neighbours differently;
it serves the forward ordering and is the plain version the tests hold
the native one against.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .. import native
from .sparse import CSR


def adjacency_from_csr(A: CSR):
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    cols = A.indices.astype(np.int64)
    mask = rows != cols
    # symmetrize
    r = np.concatenate([rows[mask], cols[mask]])
    c = np.concatenate([cols[mask], rows[mask]])
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    keep = np.ones(len(r), bool)
    keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    r, c = r[keep], c[keep]
    indptr = np.zeros(A.shape[0] + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    return np.cumsum(indptr), c


def cuthill_mckee(A: CSR, reverse: bool = True) -> np.ndarray:
    """Permutation ``perm`` (new→old) reducing the bandwidth of A: the
    native reverse Cuthill–McKee, or the numpy forward ordering."""
    indptr, nbrs = adjacency_from_csr(A)
    if reverse:
        return native.rcm(indptr, nbrs)
    return cuthill_mckee_numpy(indptr, nbrs, reverse=False)


def cuthill_mckee_numpy(indptr, nbrs, reverse: bool = True) -> np.ndarray:
    """Cuthill–McKee on a symmetric adjacency (``adjacency_from_csr``) by
    a numpy/deque BFS: the JAX package's fallback path."""
    n = len(indptr) - 1
    degree = np.diff(indptr)
    visited = np.zeros(n, bool)
    perm = np.empty(n, np.int64)
    pos = 0
    order_seed = np.argsort(degree)
    for seed in order_seed:
        if visited[seed]:
            continue
        visited[seed] = True
        queue = deque([seed])
        while queue:
            u = queue.popleft()
            perm[pos] = u
            pos += 1
            nb = nbrs[indptr[u]:indptr[u + 1]]
            nb = nb[~visited[nb]]
            if len(nb):
                visited[nb] = True
                for v in nb[np.argsort(degree[nb])]:
                    queue.append(v)
    if reverse:
        perm = perm[::-1].copy()
    return perm


def permute_csr(A: CSR, perm: np.ndarray) -> CSR:
    """Symmetric permutation PAPᵀ; perm maps new index → old index."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    rows, cols, vals = A.to_coo()
    return CSR.from_coo(inv[rows], inv[cols], vals, A.shape)


def bandwidth(A: CSR) -> int:
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    if len(rows) == 0:
        return 0
    return int(np.abs(rows - A.indices).max())


__all__ = ["cuthill_mckee", "cuthill_mckee_numpy", "permute_csr", "bandwidth",
           "adjacency_from_csr"]
