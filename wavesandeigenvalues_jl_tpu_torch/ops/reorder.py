"""Bandwidth-reducing row reordering (Cuthill–McKee), host numpy, copied
from the JAX package's ``ops/reorder.py``.

Reordering fills the dense blocks of the BSR layout (:mod:`.device`).  The
JAX function tries a native C++ BFS first; that library is not ported yet
(ROADMAP.md), so the port always takes the numpy/deque path, which is the
JAX package's own fallback and gives the same permutation as it.
"""
from __future__ import annotations

from collections import deque

import numpy as np

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
    """Permutation ``perm`` (new→old) reducing the bandwidth of A."""
    n = A.shape[0]
    indptr, nbrs = adjacency_from_csr(A)
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


__all__ = ["cuthill_mckee", "permute_csr", "bandwidth", "adjacency_from_csr"]
