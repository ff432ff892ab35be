"""Device sparse layouts (the port of the JAX package's ``ops/device.py``).

* **ELL** (padded fixed-width rows, :class:`EllOperator`): SpMV as gather
  + row-reduce, PyTorch tensors on an explicit device.
* **The device-stacked family** (:class:`DeviceStackedOperator`): the
  union-pattern value stack [K, nnz] of an operator family on the device,
  so evaluating L(z) is one small product ``coeffs @ values`` there.  The
  JAX package keeps it in complex64 on a TPU (complex128 does not compile
  there); the port keeps complex128 and casts only at a kernel.
* **BSR** (dense [bs×bs] blocks on a block-sparse row structure, host
  numpy): packed after a Cuthill–McKee reordering so the blocks are well
  filled; kernel K1 (:mod:`.bsr_spmm`) applies it to a panel.

The float64-pair helpers of the JAX module are a TPU workaround and are
not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.config import TORCH_CDTYPE
from .sparse import CSR, StackedOperator, csr_to_ell


@dataclass
class EllOperator:
    """Padded fixed-width-row sparse structure on a device."""

    cols: torch.Tensor     # [n_rows, w] int64 column ids (pad: 0)
    gather: torch.Tensor   # [n_rows, w] int64 slot -> nnz index (pad: nnz)
    mask: torch.Tensor     # [n_rows, w] bool
    n_cols: int
    nnz: int

    @classmethod
    def from_csr(cls, A: CSR, width: Optional[int] = None,
                 device="cuda") -> "EllOperator":
        cols, gather, mask = csr_to_ell(A.indptr, A.indices, A.shape[1], width)
        return cls(torch.from_numpy(cols.astype(np.int64)).to(device),
                   torch.from_numpy(gather).to(device),
                   torch.from_numpy(mask).to(device), A.shape[1], A.nnz)

    def pack(self, data: torch.Tensor) -> torch.Tensor:
        """nnz data vector -> padded [n_rows, w] ELL values."""
        padded = torch.cat([data, data.new_zeros(1)])
        return padded[self.gather]

    def matvec(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y = A x with packed ELL values [n_rows, w]."""
        return spmv_ell(vals, self.cols, x)

    def matmat(self, vals: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """Y = A X for X [n_cols, k]."""
        return torch.sum(vals[:, :, None] * X[self.cols, :], dim=1)


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Functional ELL SpMV."""
    return torch.sum(vals * x[cols], dim=1)


class DeviceStackedOperator:
    """Device mirror of :class:`.sparse.StackedOperator`: shared ELL
    structure + value stack [K, nnz] on ``device``; evaluation for one
    coefficient vector (or a batch [B, K]) is one product ``c @ values``."""

    def __init__(self, stack: StackedOperator, device="cuda",
                 dtype=TORCH_CDTYPE, width: Optional[int] = None):
        self.dtype = dtype
        self.ell = EllOperator.from_csr(
            CSR(stack.indptr, stack.indices,
                np.zeros(len(stack.indices), np.complex128), stack.shape),
            width, device)
        self.values = torch.from_numpy(
            np.ascontiguousarray(stack.values)).to(device, dtype)  # [K, nnz]
        self.shape = stack.shape
        self.row_ids = torch.from_numpy(
            stack.row_ids().astype(np.int64)).to(device)           # [nnz]
        self.col_ids = torch.from_numpy(
            stack.indices.astype(np.int64)).to(device)             # [nnz]

    def data(self, coeffs) -> torch.Tensor:
        """nnz data for one coefficient vector (or [B, nnz] for a batch)."""
        c = torch.as_tensor(np.asarray(coeffs)).to(self.values.device,
                                                   self.dtype)
        return c @ self.values

    def matvec(self, coeffs, x) -> torch.Tensor:
        vals = self.ell.pack(self.data(coeffs))
        x = torch.as_tensor(np.asarray(x)).to(self.values.device, self.dtype)
        return self.ell.matvec(vals, x)

    def dense(self, coeffs) -> torch.Tensor:
        """Dense assembly on the device: scatter the nnz data into a [d, d]
        buffer (or [B, d, d] for batched coeffs)."""
        data = self.data(coeffs)
        d = self.shape[0]
        buf = data.new_zeros(data.shape[:-1] + (d, d))
        buf[..., self.row_ids, self.col_ids] = data
        return buf

    def __repr__(self):
        return (f"DeviceStackedOperator(shape={self.shape}, "
                f"K={self.values.shape[0]}, nnz={self.values.shape[1]}, "
                f"dtype={self.dtype})")


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


__all__ = ["EllOperator", "spmv_ell", "DeviceStackedOperator", "BsrOperator"]
