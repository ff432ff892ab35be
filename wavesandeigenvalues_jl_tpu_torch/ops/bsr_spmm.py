"""Block-sparse-row SpMM: kernel K1 of the port, and the operator apply
Y = L(ω)·X that runs it.

:func:`bsr_spmm` computes ``Y[row] = Σ_k blocks[row, k] @ X[cols[row, k]]``
on the nonzeros of the blocks only, as one launch of the hand-written CUDA
kernel ``csrc/bsr_spmm.cu``: the counterpart of the Pallas TPU kernel
``wavesandeigenvalues_jl_tpu/ops/pallas_spmv.py :: _bsr_spmm_kernel``.

* :func:`pack` turns a :class:`.device.BsrOperator` (dense blocks, as the
  JAX package builds them) into the kernel's layout: per row, its nonzeros
  in CSR form with local columns ``slot·bs + j`` into the block row's X
  window; :func:`unpack` gives the dense blocks back.
* :func:`bsr_spmm_packed_ref` is the kernel's plain PyTorch version (a
  gather of the window and ``index_add_``); :func:`bsr_spmm_ref` is the
  dense-block einsum of the JAX package's ``bsr_spmm_xla``, kept as the
  tests' bridge to the JAX package.
* :func:`bsr_spmm` takes the plain version only for tensors that lie on the
  CPU; for CUDA tensors it launches the kernel or raises.  It counts its
  launches and its CPU calls in ``utils.timing``'s counters
  ``bsr_spmm.launches`` and ``bsr_spmm.twin_calls``.
* :class:`BsrSpmm` holds a packed operator on the device (the counterpart
  of ``PallasBsrSpmm``); :func:`operator_apply` is the entry point:
  evaluate the family at z, write its values into the packed layout of the
  cached Cuthill–McKee ordering (:class:`ApplyPlan`), apply to the panel.
  With ``kernel="window"`` it goes instead through the CSR SpMM kernel of
  :mod:`.window_spmm` (the large-operator form, K4/K5), evaluating the
  family on the device (:class:`WindowPlan`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..utils import timing
from . import cuda_build
from .device import BsrOperator, DeviceStackedOperator
from .reorder import cuthill_mckee, permute_csr
from .sparse import CSR, StackedOperator
from .window_spmm import WindowSpmm

#: block sizes the kernel is built for, and its panel-column tile
BLOCK_SIZES = (32, 64, 128)
TILE_COLS = 32


class PackedBsr(NamedTuple):
    """The nonzeros of a :class:`.device.BsrOperator`, per row in CSR form,
    addressed into the row's staged X window: the kernel's layout."""

    row_ptr: np.ndarray     # [nbr·bs + 1] int32
    lcol: np.ndarray        # [nnz] int32: slot·bs + j, ascending per row
    vals: np.ndarray        # [nnz] the blocks' dtype


def _real_slots(block_cols: np.ndarray) -> np.ndarray:
    """[nbr] number of real slots of each block row, by the kernel's rule:
    slot 0 and every following slot whose block column exceeds the one
    before (padding slots repeat column 0)."""
    grows = np.diff(block_cols, axis=1) > 0
    return 1 + np.cumprod(grows, axis=1).sum(axis=1)


def pack(bsr: BsrOperator) -> PackedBsr:
    """The nonzero entries of ``bsr.blocks`` in the kernel's layout."""
    nbr, maxb, bs, _ = bsr.blocks.shape
    br, k, i, j = np.nonzero(bsr.blocks)
    if len(br) >= 2 ** 31:
        raise ValueError("the kernel indexes nonzeros in int32")
    if np.any(k >= _real_slots(bsr.block_cols)[br]):
        raise ValueError("a padding slot holds nonzeros")
    rows, lcol = br * bs + i, k * bs + j
    order = np.lexsort((lcol, rows))
    row_ptr = np.zeros(nbr * bs + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=nbr * bs), out=row_ptr[1:])
    return PackedBsr(row_ptr, lcol[order].astype(np.int32),
                     bsr.blocks[br, k, i, j][order])


def unpack(row_ptr, lcol, vals, maxb: int, bs: int) -> np.ndarray:
    """The dense blocks [nbr, maxb, bs, bs] of a packed layout (host
    arrays), zeros where it holds no entry: the inverse of :func:`pack`."""
    row_ptr, lcol, vals = (np.asarray(a) for a in (row_ptr, lcol, vals))
    nrows = len(row_ptr) - 1
    rows = np.repeat(np.arange(nrows), np.diff(row_ptr))
    blocks = np.zeros((nrows // bs, maxb, bs, bs), vals.dtype)
    blocks[rows // bs, lcol // bs, rows % bs, lcol % bs] = vals
    return blocks


def bsr_spmm_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """Dense-block BSR SpMM, the gather + einsum of the JAX package's
    ``bsr_spmm_xla``: blocks [nbr, maxb, bs, bs], block_cols [nbr, maxb],
    X [nb, bs, r] -> Y [nbr, bs, r].  The tests' bridge between the packed
    layout and the JAX package."""
    Xg = X[block_cols.long()]                          # [nbr, maxb, bs, r]
    return torch.einsum("rkij,rkjm->rim", blocks, Xg)


def bsr_spmm_packed_ref(row_ptr: torch.Tensor, lcol: torch.Tensor,
                        vals: torch.Tensor, block_cols: torch.Tensor,
                        X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract): gather each
    block row's X window [maxb·bs, r], then sum vals·window[lcol] into the
    rows with ``index_add_`` -> Y [nbr, bs, r]."""
    nbr, maxb = block_cols.shape
    _, bs, r = X.shape
    window = X[block_cols.long()].reshape(nbr, maxb * bs, r)
    rows = torch.repeat_interleave(
        torch.arange(nbr * bs, device=X.device), row_ptr.diff().long())
    prod = vals[:, None] * window[rows // bs, lcol.long()]     # [nnz, r]
    Y = X.new_zeros(nbr * bs, r)
    torch.view_as_real(Y).index_add_(0, rows, torch.view_as_real(prod))
    return Y.view(nbr, bs, r)


@functools.cache
def build() -> dict:
    """Compile ``csrc/bsr_spmm.cu`` (once per source hash) and load it:
    {"lib", "path", "seconds", "log"} (see :func:`.cuda_build.load`)."""
    info = cuda_build.load("bsr_spmm")
    fn = info["lib"].bsr_spmm_c64
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return info


def _check(row_ptr, lcol, vals, block_cols, X):
    if vals.dtype != torch.complex64 or X.dtype != torch.complex64:
        raise TypeError(f"bsr_spmm takes complex64, got {vals.dtype} and "
                        f"{X.dtype}")
    if not (row_ptr.dtype == lcol.dtype == block_cols.dtype == torch.int32):
        raise TypeError(f"row_ptr, lcol and block_cols must be int32, got "
                        f"{row_ptr.dtype}, {lcol.dtype}, {block_cols.dtype}")
    devices = sorted({str(t.device) for t in (row_ptr, lcol, vals,
                                              block_cols, X)})
    if len(devices) != 1:
        raise ValueError(f"bsr_spmm's tensors lie on {devices}")
    if block_cols.dim() != 2 or X.dim() != 3 or row_ptr.dim() != 1 or \
            lcol.dim() != 1 or vals.shape != lcol.shape or \
            row_ptr.numel() != block_cols.shape[0] * X.shape[1] + 1:
        raise ValueError(
            f"shapes {tuple(row_ptr.shape)}, {tuple(lcol.shape)}, "
            f"{tuple(vals.shape)}, {tuple(block_cols.shape)}, "
            f"{tuple(X.shape)}: expected [nbr·bs + 1], [nnz], [nnz], "
            "[nbr, maxb] and [nb, bs, r]")
    if not all(t.is_contiguous() for t in (row_ptr, lcol, vals, block_cols,
                                           X)):
        raise ValueError("bsr_spmm takes contiguous tensors")


def bsr_spmm(row_ptr: torch.Tensor, lcol: torch.Tensor, vals: torch.Tensor,
             block_cols: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y [nbr, bs, r] = the BSR product in the packed layout of
    :func:`pack`.  CPU tensors: plain version; CUDA tensors: the kernel
    (bs ∈ {32, 64, 128}, r a multiple of 32; a window of more slots than
    shared memory holds is staged in passes).  The block columns must lie
    in [0, nb) and the layout must be one :func:`pack` makes
    (:class:`BsrSpmm` ensures both)."""
    _check(row_ptr, lcol, vals, block_cols, X)
    if X.device.type == "cpu":
        timing.count("bsr_spmm.twin_calls")
        return bsr_spmm_packed_ref(row_ptr, lcol, vals, block_cols, X)
    if X.device.type != "cuda":
        raise ValueError(f"bsr_spmm has no kernel for {X.device}")
    nbr, maxb = block_cols.shape
    _, bs, r = X.shape
    if bs not in BLOCK_SIZES or r % TILE_COLS or r == 0 or X.data_ptr() % 16:
        raise ValueError(f"the kernel takes bs in {BLOCK_SIZES}, r a "
                         f"multiple of {TILE_COLS} and a 16-byte aligned "
                         f"panel, got bs={bs}, r={r}")
    lib = build()["lib"]
    Y = X.new_empty(nbr, bs, r)
    with torch.cuda.device(X.device):
        code = lib.bsr_spmm_c64(
            row_ptr.data_ptr(), lcol.data_ptr(), vals.data_ptr(),
            block_cols.data_ptr(), X.data_ptr(), Y.data_ptr(), nbr, maxb,
            bs, r, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, "bsr_spmm", code)
    timing.count("bsr_spmm.launches")
    return Y


class BsrSpmm(nn.Module):
    """Device-resident BSR operator in the packed layout: Y = A X in
    complex64 on a panel of ``nrhs`` columns (counterpart of the JAX
    package's ``PallasBsrSpmm``).  ``packed`` may pass a :func:`pack` of
    ``bsr`` made already."""

    def __init__(self, bsr: BsrOperator, device, nrhs: int = 128,
                 packed: PackedBsr | None = None):
        super().__init__()
        nb = bsr.n // bsr.bs
        if bsr.block_cols.size and not (
                0 <= bsr.block_cols.min() and bsr.block_cols.max() < nb):
            raise ValueError("block column index out of range")
        packed = pack(bsr) if packed is None else packed
        self.bs, self.n, self.nrhs = bsr.bs, bsr.n, nrhs
        self.nbr, self.maxb = bsr.block_cols.shape
        self.nnz_blocks = int(np.count_nonzero(bsr.block_mask))
        #: nonzero entries, the work of one apply (flops) and the bytes the
        #: product must move: each nonzero's value and column, row_ptr and
        #: block_cols once, X read once and Y written once
        self.nnz = len(packed.vals)
        self.flops = 8.0 * self.nnz * nrhs
        self.bytes = (12.0 * self.nnz + 4.0 * (len(packed.row_ptr)
                                               + bsr.block_cols.size)
                      + 16.0 * bsr.n * nrhs)
        #: what a product over the dense [bs, bs] blocks would move
        self.padded_bytes = (8.0 * bsr.blocks.size + 4.0 * bsr.block_cols.size
                             + 16.0 * bsr.n * nrhs)
        for name, a in (("row_ptr", packed.row_ptr), ("lcol", packed.lcol),
                        ("vals", packed.vals.astype(np.complex64)),
                        ("block_cols", bsr.block_cols.astype(np.int32))):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(a)), persistent=False)
        self.to(device)

    def panel(self, X) -> torch.Tensor:
        """Host [n_logical, nrhs] -> device complex64 panel [nb, bs, nrhs]
        (zero-padded rows)."""
        X = torch.as_tensor(np.asarray(X, np.complex64))
        Xp = X.new_zeros(self.n, self.nrhs)
        Xp[:X.shape[0]] = X
        return Xp.view(-1, self.bs, self.nrhs).to(self.vals.device)

    def apply(self, Xp: torch.Tensor) -> torch.Tensor:
        """Y [nbr, bs, nrhs] = A X on a device panel from :meth:`panel`."""
        return bsr_spmm(self.row_ptr, self.lcol, self.vals, self.block_cols,
                        Xp)

    def forward(self, X) -> np.ndarray:
        """X [n_logical, nrhs] complex (host) -> Y [n_logical, nrhs]
        complex64 (host)."""
        n_logical = np.asarray(X).shape[0]
        Y = self.apply(self.panel(X))
        return Y.reshape(-1, self.nrhs)[:n_logical].cpu().numpy()


def _tagged_permutation(stack):
    """(perm, Ar, src): the Cuthill–McKee permutation (new → old) of the
    union pattern, the permuted pattern as a CSR whose data are the union
    entries' indices + 1 (so any packing of it says where every entry
    went; a padding stays 0), and ``src``, the union entry of each of Ar's
    nonzeros."""
    nnz = len(stack.indices)
    tagged = CSR(stack.indptr, stack.indices,
                 np.arange(1, nnz + 1, dtype=np.complex128), stack.shape)
    with timing.phase("apply_plan.cuthill_mckee"):
        perm = cuthill_mckee(tagged)
    with timing.phase("apply_plan.permute"):
        Ar = permute_csr(tagged, perm)
    return perm, Ar, Ar.data.real.astype(np.int64) - 1


class ApplyPlan:
    """What the apply of one family keeps between calls: the Cuthill–McKee
    permutation and packed BSR structure of its union pattern, which do not
    depend on z, the device operator, and which union entry each of its
    nonzeros holds.  :meth:`load` writes the values of L(z) into it."""

    def __init__(self, stack, bs: int, device, nrhs: int):
        self.perm, Ar, _ = _tagged_permutation(stack)
        bsr = BsrOperator.from_csr(Ar, bs=bs)
        packed = pack(bsr)
        self.src = packed.vals.real.astype(np.int64) - 1
        self.op = BsrSpmm(bsr, device, nrhs=nrhs, packed=packed)

    def load(self, data: np.ndarray):
        """Write the union-pattern values ``data`` [nnz] into the packed
        values."""
        self.op.vals.copy_(torch.from_numpy(
            data[self.src].astype(np.complex64)))

    def __call__(self, L, X: np.ndarray) -> np.ndarray:
        self.load(L.assemble({}).data)
        Y = np.empty((L.size, X.shape[1]), np.complex64)
        Y[self.perm] = self.op(X[self.perm])
        return Y


class WindowPlan:
    """What the window apply of one family keeps between calls: the
    Cuthill–McKee permutation (and its inverse) on the device, the permuted
    CSR structure there (:class:`.window_spmm.WindowSpmm`), and the
    family's permuted value stack there in complex128
    (:class:`.device.DeviceStackedOperator`).  A call evaluates the family
    on the device as ``coeffs @ values``, casts to complex64 and launches
    the kernel once; the host only moves the panel in and out."""

    def __init__(self, stack, device, nrhs: int):
        perm, Ar, src = _tagged_permutation(stack)
        self.family = DeviceStackedOperator(
            StackedOperator(Ar.indptr, Ar.indices, stack.values[:, src],
                            stack.shape), device)
        self.op = WindowSpmm(Ar.indptr, Ar.indices,
                             np.zeros(len(src), np.complex64), stack.shape,
                             nrhs, device)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        dev = self.op.vals.device
        self.perm = torch.from_numpy(perm).to(dev)
        self.inv = torch.from_numpy(inv).to(dev)

    def __call__(self, L, X: np.ndarray) -> np.ndarray:
        vals = self.family.data(L.coefficients()).to(torch.complex64)
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.complex64)).to(
            self.perm.device)[self.perm]
        return self.op.apply(Xd, vals)[self.inv].cpu().numpy()


def _plan(L, attr: str, key, build):
    """The plan cached on L under ``attr`` while its union pattern
    (``L._stack()``) and ``key`` stay the same; else a new ``build()``."""
    cached = getattr(L, attr, None)
    if cached is not None and cached[0] is L._stack() and cached[1] == key:
        return cached[2]
    plan = build()
    setattr(L, attr, (L._stack(), key, plan))
    return plan


def operator_apply(L, z, X, *, bs: int = 128, device="cuda",
                   kernel: str = "bsr") -> np.ndarray:
    """Y = L(z)·X for a host panel X [n, r] on ``device`` (the card unless
    the caller asks for the CPU); Y comes back in the original ordering as
    complex64 [n, r].  The Cuthill–McKee ordering and the device structure
    are built on the first call per family and reused (cached on L).

    * ``kernel="bsr"`` (K1): the family is evaluated at z on the host
      (complex128), its values are written into [bs, bs] blocks
      (:class:`ApplyPlan`) and applied in complex64.
    * ``kernel="window"`` (the CSR SpMM of K4/K5, for large operators):
      the family is evaluated on the device and applied in complex64
      (:class:`WindowPlan`); ``bs`` is not used."""
    X = np.asarray(X)
    key = (torch.device(device), X.shape[1])
    if kernel == "bsr":
        plan = _plan(L, "_bsr_plan", (bs,) + key,
                     lambda: ApplyPlan(L._stack(), bs, device, X.shape[1]))
    elif kernel == "window":
        plan = _plan(L, "_window_plan", key,
                     lambda: WindowPlan(L._stack(), device, X.shape[1]))
    else:
        raise ValueError(f"kernel must be 'bsr' or 'window', got {kernel!r}")
    L.params[L.eigval] = complex(z)
    return plan(L, X)


def random_panel(n: int, r: int, seed: int = 0) -> np.ndarray:
    """A seeded complex64 [n, r] panel of standard normal entries."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, r))
            + 1j * rng.standard_normal((n, r))).astype(np.complex64)


__all__ = ["bsr_spmm", "bsr_spmm_ref", "bsr_spmm_packed_ref", "build",
           "pack", "unpack", "PackedBsr", "BsrSpmm", "ApplyPlan", "WindowPlan",
           "operator_apply", "random_panel", "BLOCK_SIZES", "TILE_COLS"]
