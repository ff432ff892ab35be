"""Device sparse layouts: the block-sparse-row (BSR) operator (host numpy,
copied from the JAX package's ``ops/device.py``).

Dense [bs×bs] blocks on a block-sparse row structure, packed after a
Cuthill–McKee reordering so the blocks are well filled; kernel K1
(:mod:`.bsr_spmm`) applies it to a panel of right-hand sides.  The ELL
operator, the device-stacked family and the float64-pair helpers of that
module are not on the ported path yet (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .sparse import CSR


@dataclass
class BsrOperator:
    """Block-sparse rows: dense [bs, bs] blocks; per block-row a padded list
    of block-column indices (pad: column 0 with a zero block)."""

    blocks: np.ndarray      # [n_block_rows, max_blocks, bs, bs]
    block_cols: np.ndarray  # [n_block_rows, max_blocks] int32
    block_mask: np.ndarray  # [n_block_rows, max_blocks] bool
    bs: int
    n: int                  # padded dimension

    @classmethod
    def from_csr(cls, A: CSR, bs: int = 128) -> "BsrOperator":
        n = ((A.shape[0] + bs - 1) // bs) * bs
        nbr = n // bs
        rows, cols, vals = A.to_coo()
        br, bc = rows // bs, cols // bs
        key = br.astype(np.int64) * nbr + bc
        order = np.argsort(key)
        key_s, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
        uniq, start = np.unique(key_s, return_index=True)
        boundaries = np.append(start, len(key_s))
        n_blocks = len(uniq)
        blocks = np.zeros((n_blocks + 1, bs, bs), dtype=vals.dtype)  # +1 zero pad
        ub_r = (uniq // nbr).astype(np.int64)
        ub_c = (uniq % nbr).astype(np.int64)
        for b in range(n_blocks):
            s, e = boundaries[b], boundaries[b + 1]
            blocks[b][rows[s:e] - ub_r[b] * bs, cols[s:e] - ub_c[b] * bs] = vals[s:e]
        counts = np.bincount(ub_r, minlength=nbr)
        maxb = int(counts.max()) if n_blocks else 1
        block_cols = np.zeros((nbr, maxb), np.int32)
        block_ids = np.full((nbr, maxb), n_blocks, np.int64)  # pad: zero block
        block_mask = np.zeros((nbr, maxb), bool)
        fill = np.zeros(nbr, np.int64)
        for b in range(n_blocks):
            r = ub_r[b]
            block_cols[r, fill[r]] = ub_c[b]
            block_ids[r, fill[r]] = b
            block_mask[r, fill[r]] = True
            fill[r] += 1
        # order blocks array in row-major scan so the kernel's per-row block
        # list indexes into a contiguous [nbr, maxb, bs, bs] tensor
        gathered = blocks[block_ids]  # [nbr, maxb, bs, bs]
        return cls(gathered, block_cols, block_mask, bs, n)

    @property
    def fill_ratio(self) -> float:
        nz = np.count_nonzero(self.blocks)
        return nz / self.blocks.size

    def matvec_reference(self, x: np.ndarray) -> np.ndarray:
        """Host reference BSR SpMV for testing."""
        xp = np.zeros(self.n, dtype=x.dtype)
        xp[:len(x)] = x
        xb = xp.reshape(-1, self.bs)
        y = np.einsum("rkij,rkj->ri", self.blocks, xb[self.block_cols])
        return y.reshape(-1)[:len(x)]


__all__ = ["BsrOperator"]
