"""Row partitioning of sparse operators for the distributed layer, copied
from the JAX package's ``parallel/partition.py``.

After Cuthill–McKee reordering (:mod:`..ops.reorder`, the native reverse
ordering, the JAX package's permutation) the bandwidth is small, so
contiguous equal-size row blocks reference columns only within ±H rows of
their own range: the halo exchange of the distributed SpMV
(:mod:`.dist_spmv`) then moves a few neighbouring parts, never all of
them.  Host numpy; the arrays equal the JAX package's exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.reorder import cuthill_mckee
from ..ops.sparse import CSR, StackedOperator
from ..utils.config import IDTYPE


@dataclass
class RowPartitionedEll:
    """Stacked per-part ELL structure for halo-exchange SpMV.

    Arrays are stacked on a leading parts axis P (laid over the ranks of a
    mesh axis, :func:`.mesh.local_parts`):
      cols     [P, m, w]  column index into the extended local window
                          [halo_left(H) | own(m) | halo_right(H) | zero-pad]
      values   [K, P, m, w]  per-term ELL values (K=1 for a single matrix)
      row_mask [P, m]     valid (non-padding) rows
      perm     [n]        partition-order index -> original row index
    """

    cols: np.ndarray
    values: np.ndarray
    row_mask: np.ndarray
    perm: np.ndarray
    n_parts: int
    m: int
    halo: int
    n: int

    @property
    def window(self) -> int:
        return self.m + 2 * self.halo

    def shard_vector(self, x: np.ndarray) -> np.ndarray:
        """Original-order vector -> [P, m] partition-order shards."""
        xp = np.zeros(self.n_parts * self.m, dtype=np.asarray(x).dtype)
        xp[:self.n] = np.asarray(x)[self.perm]
        return xp.reshape(self.n_parts, self.m)

    def unshard_vector(self, xs: np.ndarray) -> np.ndarray:
        """[P, m] shards -> original-order vector."""
        flat = np.asarray(xs).reshape(-1)[:self.n]
        out = np.empty_like(flat)
        out[self.perm] = flat
        return out


def _partition_structure(indptr, indices, values_kn, n, n_parts):
    """Core: partition (indptr, indices) with stacked values [K, nnz]."""
    K = values_kn.shape[0]
    counts = np.diff(indptr)
    nnz = len(indices)
    w = int(counts.max()) if n else 1
    m = -(-n // n_parts)
    # vectorized ragged→padded ELL in global numbering (no per-row loop:
    # setup must stay sub-second at 10⁵–10⁶ DOF)
    cols_g = np.zeros((n, w), dtype=np.int64)
    vals_g = np.zeros((K, n, w), dtype=values_kn.dtype)
    mask = np.zeros((n, w), dtype=bool)
    ridx = np.repeat(np.arange(n), counts)
    pos = np.arange(nnz) - np.repeat(indptr[:-1], counts)
    cols_g[ridx, pos] = indices
    vals_g[:, ridx, pos] = values_kn
    mask[ridx, pos] = True
    starts = (np.arange(n) // m) * m
    rel = cols_g - starts[:, None]
    rel_lo = int(np.where(mask, rel, 0).min()) if n else 0
    rel_hi = int(np.where(mask, rel, 0).max()) if n else 0
    H = max(0, -rel_lo, rel_hi - (m - 1))
    W = m + 2 * H
    # split into parts by padding the row axis to n_parts·m and reshaping;
    # local window index = global col − (part_start − H), padding → W
    local = np.where(mask, rel + H, W)
    npad = n_parts * m
    cols = np.full((npad, w), W, dtype=IDTYPE)
    cols[:n] = local
    values = np.zeros((K, npad, w), dtype=values_kn.dtype)
    values[:, :n] = vals_g
    row_mask = np.zeros(npad, dtype=bool)
    row_mask[:n] = True
    return (cols.reshape(n_parts, m, w),
            values.reshape(K, n_parts, m, w),
            row_mask.reshape(n_parts, m), m, H)


def _permute_pattern(indptr, indices, values_kn, perm, n):
    """Symmetric permutation of a (pattern, stacked-values) pair without
    dropping structural zeros."""
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    new_rows = inv[rows]
    new_cols = inv[indices]
    order = np.lexsort((new_cols, new_rows))
    new_rows, new_cols = new_rows[order], new_cols[order]
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(new_indptr, new_rows + 1, 1)
    return (np.cumsum(new_indptr), new_cols.astype(IDTYPE),
            values_kn[:, order])


def partition_rows(A: CSR, n_parts: int, reorder: bool = True
                   ) -> RowPartitionedEll:
    """Partition a single matrix into contiguous row blocks (CMK-reordered
    by default)."""
    n = A.shape[0]
    perm = cuthill_mckee(A) if reorder else np.arange(n)
    indptr, indices, values = _permute_pattern(A.indptr, A.indices,
                                               A.data[None, :], perm, n)
    cols, vals, row_mask, m, H = _partition_structure(indptr, indices,
                                                      values, n, n_parts)
    return RowPartitionedEll(cols=cols, values=vals, row_mask=row_mask,
                             perm=perm, n_parts=n_parts, m=m, halo=H, n=n)


def partition_stack(S: StackedOperator, n_parts: int, reorder: bool = True
                    ) -> RowPartitionedEll:
    """Partition a K-term stacked operator family: ONE shared structure,
    per-term values [K, P, m, w].  Evaluating the family on a part is a
    coefficient contraction over axis K followed by the halo SpMV."""
    n = S.shape[0]
    base = CSR(S.indptr, S.indices, np.ones(S.nnz, np.complex128), S.shape)
    perm = cuthill_mckee(base) if reorder else np.arange(n)
    indptr, indices, values = _permute_pattern(S.indptr, S.indices,
                                               S.values, perm, n)
    cols, vals, row_mask, m, H = _partition_structure(indptr, indices,
                                                      values, n, n_parts)
    return RowPartitionedEll(cols=cols, values=vals, row_mask=row_mask,
                             perm=perm, n_parts=n_parts, m=m, halo=H, n=n)


__all__ = ["RowPartitionedEll", "partition_rows", "partition_stack"]
