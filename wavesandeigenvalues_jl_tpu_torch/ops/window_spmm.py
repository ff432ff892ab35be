"""CSR SpMM for large operators: the port's counterpart of kernels K4 and
K5, and of their wrappers ``WindowSpmm`` and ``ChunkSpmm``.

:func:`window_spmm` computes ``Y[i] = Σ_{k ∈ row i} vals[k]·X[cols[k]]``
as one launch of the hand-written CUDA kernel ``csrc/window_spmm.cu``.  It
replaces both windowed Pallas TPU kernels of the JAX package:
``ops/window_spmm.py :: _make_kernel`` (K4, slot-padded 128×128 blocks) and
``ops/window_spmm2.py :: _build_call`` (K5, compact 8×128 blocks chunked
by window column).  Those layouts exist because Mosaic cannot lower a
per-row gather; on this card the kernel gathers per row from the
compressed rows themselves, so it has no window limit: an operator whose
band exceeds the TPU's 3-tile window, which K4 and K5 refuse, gets the
right Y.

* :func:`window_spmm_ref` is its plain PyTorch version: a gather of X rows
  times the values, then ``index_add_`` into the rows.
* :func:`window_spmm` takes the plain version only for tensors that lie on
  the CPU; for CUDA tensors it launches the kernel or raises.  It counts
  its launches (``window_spmm.launches``) and its CPU calls
  (``window_spmm.twin_calls``).
* :class:`WindowSpmm` holds a reordered CSR operator on the device (the
  counterpart of ``WindowSpmm`` and ``ChunkSpmm``), with ``chain`` for m
  normalized applies (the counterpart of ``chain_fn``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from . import cuda_build
from .sparse import CSR

#: the kernel takes panels whose width is a multiple of this (4 complex
#: columns a lane, two 16-byte loads)
COL_MULTIPLE = 4


def window_spmm_ref(indptr: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch CSR SpMM (same contract as the kernel): indptr
    [n + 1], cols [nnz], vals [nnz], X [n_cols, r] -> Y [n, r]."""
    n = indptr.numel() - 1
    rows = torch.repeat_interleave(
        torch.arange(n, device=X.device), indptr.diff().long())
    prod = vals[:, None] * X[cols.long()]                   # [nnz, r]
    Y = X.new_zeros(n, X.shape[1])
    torch.view_as_real(Y).index_add_(0, rows, torch.view_as_real(prod))
    return Y


@functools.cache
def build() -> dict:
    """Compile ``csrc/window_spmm.cu`` (once per source hash) and load it:
    {"lib", "path", "seconds", "log"} (see :func:`.cuda_build.load`)."""
    info = cuda_build.load("window_spmm")
    fn = info["lib"].window_spmm_c64
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return info


def _check(indptr, cols, vals, X):
    if vals.dtype != torch.complex64 or X.dtype != torch.complex64:
        raise TypeError(f"window_spmm takes complex64, got {vals.dtype} and "
                        f"{X.dtype}")
    if indptr.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError(f"indptr and cols must be int32, got {indptr.dtype} "
                        f"and {cols.dtype}")
    if not (indptr.device == cols.device == vals.device == X.device):
        raise ValueError(f"indptr on {indptr.device}, cols on {cols.device}, "
                         f"vals on {vals.device}, X on {X.device}")
    if indptr.dim() != 1 or indptr.numel() < 2 or cols.dim() != 1 or \
            vals.shape != cols.shape or X.dim() != 2:
        raise ValueError(
            f"shapes {tuple(indptr.shape)}, {tuple(cols.shape)}, "
            f"{tuple(vals.shape)}, {tuple(X.shape)}: expected [n + 1] with "
            "n ≥ 1, [nnz], [nnz] and [n_cols, r]")
    if not all(t.is_contiguous() for t in (indptr, cols, vals, X)):
        raise ValueError("window_spmm takes contiguous tensors")


def window_spmm(indptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                X: torch.Tensor) -> torch.Tensor:
    """Y [n, r] = the CSR product.  CPU tensors: plain version; CUDA
    tensors: the kernel (r a multiple of 4).  The structure must be valid
    CSR with columns in [0, n_cols) (:class:`WindowSpmm` checks)."""
    _check(indptr, cols, vals, X)
    if X.device.type == "cpu":
        window_spmm.twin_calls += 1
        return window_spmm_ref(indptr, cols, vals, X)
    if X.device.type != "cuda":
        raise ValueError(f"window_spmm has no kernel for {X.device}")
    n, r = indptr.numel() - 1, X.shape[1]
    if r % COL_MULTIPLE or X.data_ptr() % 16:
        raise ValueError(f"the kernel takes r a multiple of {COL_MULTIPLE} "
                         f"and a 16-byte aligned panel, got r={r}")
    lib = build()["lib"]
    Y = X.new_empty(n, r)
    with torch.cuda.device(X.device):
        code = lib.window_spmm_c64(
            indptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            X.data_ptr(), Y.data_ptr(), n, r,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, "window_spmm", code)
    window_spmm.launches += 1
    return Y


window_spmm.launches = 0
window_spmm.twin_calls = 0


class WindowSpmm(nn.Module):
    """Device-resident CSR operator: Y = A X in complex64 on a panel of
    ``nrhs`` columns, through :func:`window_spmm` (the counterpart of the
    JAX package's ``WindowSpmm`` and ``ChunkSpmm``)."""

    def __init__(self, indptr, cols, vals, shape, nrhs: int = 128,
                 device="cuda"):
        super().__init__()
        indptr = np.asarray(indptr, np.int64)
        cols = np.asarray(cols, np.int64)
        n, n_cols = shape
        if len(indptr) != n + 1 or indptr[0] != 0 or \
                np.any(np.diff(indptr) < 0) or indptr[-1] != len(cols):
            raise ValueError("indptr is not a CSR row pointer of this shape")
        if len(cols) >= 2 ** 31:
            raise ValueError("the kernel indexes nonzeros in int32")
        if len(cols) and not (0 <= cols.min() and cols.max() < n_cols):
            raise ValueError("column index out of range")
        self.n, self.n_cols, self.nrhs = n, n_cols, nrhs
        self.nnz = len(cols)
        #: work of one apply (flops) and the bytes this layout moves: the
        #: values, columns and row pointer, X read once and Y written once
        self.flops = 8.0 * self.nnz * nrhs
        self.stream_bytes = (12.0 * self.nnz + 4.0 * (n + 1)
                             + 8.0 * (n_cols + n) * nrhs)
        self.register_buffer("indptr", torch.from_numpy(
            indptr.astype(np.int32)), persistent=False)
        self.register_buffer("cols", torch.from_numpy(
            cols.astype(np.int32)), persistent=False)
        self.register_buffer("vals", torch.from_numpy(
            np.asarray(vals).astype(np.complex64)), persistent=False)
        self.to(device)

    @classmethod
    def from_csr(cls, A: CSR, nrhs: int = 128, device="cuda") -> "WindowSpmm":
        """From a (Cuthill–McKee-reordered) host CSR: plain numpy arrays, so
        the JAX package's assembled operator fits as well."""
        return cls(A.indptr, A.indices, A.data, A.shape, nrhs, device)

    def panel(self, X) -> torch.Tensor:
        """Host [n_cols, nrhs] -> device complex64 panel."""
        X = torch.as_tensor(np.asarray(X, np.complex64))
        return X.to(self.vals.device).contiguous()

    def apply(self, Xd: torch.Tensor) -> torch.Tensor:
        """Y = A X on device tensors (the counterpart of ``apply_split``)."""
        return window_spmm(self.indptr, self.cols, self.vals, Xd)

    def forward(self, X) -> np.ndarray:
        """X [n_cols, nrhs] complex (host) -> Y [n, nrhs] complex64 (host)."""
        return self.apply(self.panel(X)).cpu().numpy()

    def chain(self, m: int, spmm=window_spmm):
        """f(Xd) -> m applies, each followed by scaling the whole panel by
        1/max(‖Y‖_F, 1e-30) (the counterpart of ``chain_fn``,
        ``window_spmm.py:275-304``).  ``spmm`` is the product to chain:
        :func:`window_spmm_ref` gives the plain chain."""
        def call(Xd: torch.Tensor) -> torch.Tensor:
            for _ in range(m):
                Y = spmm(self.indptr, self.cols, self.vals, Xd)
                # on the device, no sync: s = 1 / max(‖Y‖_F, 1e-30)
                Xd = Y * (1.0 / torch.linalg.vector_norm(Y).clamp_min(1e-30))
            return Xd
        return call


__all__ = ["window_spmm", "window_spmm_ref", "build", "WindowSpmm",
           "COL_MULTIPLE"]
