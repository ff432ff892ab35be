"""Block-sparse-row SpMM: kernel K1 of the port, and the operator apply
Y = L(ω)·X that runs it.

:func:`bsr_spmm` computes ``Y[row] = Σ_k blocks[row, k] @ X[cols[row, k]]``
as one launch of the hand-written CUDA kernel ``csrc/bsr_spmm.cu``: the
counterpart of the Pallas TPU kernel ``wavesandeigenvalues_jl_tpu/ops/
pallas_spmv.py :: _bsr_spmm_kernel``.

* :func:`bsr_spmm_ref` is its plain PyTorch version: the gather + einsum of
  the JAX package's ``bsr_spmm_xla``.
* :func:`bsr_spmm` takes the plain version only for tensors that lie on the
  CPU; for CUDA tensors it launches the kernel or raises.  It counts its
  launches (``bsr_spmm.launches``) and its CPU calls
  (``bsr_spmm.twin_calls``).
* :class:`BsrSpmm` holds a :class:`.device.BsrOperator` on the device (the
  counterpart of ``PallasBsrSpmm``); :func:`operator_apply` is the entry
  point: evaluate the family at z, write its values into the blocks of the
  cached Cuthill–McKee ordering (:class:`ApplyPlan`), apply to the panel.
  With ``kernel="window"`` it goes instead through the CSR SpMM kernel of
  :mod:`.window_spmm` (the large-operator form, K4/K5), evaluating the
  family on the device (:class:`WindowPlan`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from ..utils import timing
from . import cuda_build
from .device import BsrOperator, DeviceStackedOperator
from .reorder import cuthill_mckee, permute_csr
from .sparse import CSR, StackedOperator
from .window_spmm import WindowSpmm, window_spmm

#: block sizes the kernel is built for, and its panel-column tile
BLOCK_SIZES = (32, 64, 128)
TILE_COLS = 32


def bsr_spmm_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch BSR SpMM (same contract as the kernel): blocks
    [nbr, maxb, bs, bs], block_cols [nbr, maxb], X [nb, bs, r] ->
    Y [nbr, bs, r]."""
    Xg = X[block_cols.long()]                          # [nbr, maxb, bs, r]
    return torch.einsum("rkij,rkjm->rim", blocks, Xg)


@functools.cache
def build() -> dict:
    """Compile ``csrc/bsr_spmm.cu`` (once per source hash) and load it:
    {"lib", "path", "seconds", "log"} (see :func:`.cuda_build.load`)."""
    info = cuda_build.load("bsr_spmm")
    fn = info["lib"].bsr_spmm_c64
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return info


def _check(blocks: torch.Tensor, block_cols: torch.Tensor, X: torch.Tensor):
    if blocks.dtype != torch.complex64 or X.dtype != torch.complex64:
        raise TypeError(f"bsr_spmm takes complex64, got {blocks.dtype} and "
                        f"{X.dtype}")
    if block_cols.dtype != torch.int32:
        raise TypeError(f"block_cols must be int32, got {block_cols.dtype}")
    if not (blocks.device == block_cols.device == X.device):
        raise ValueError(f"blocks on {blocks.device}, block_cols on "
                         f"{block_cols.device}, X on {X.device}")
    if blocks.dim() != 4 or block_cols.dim() != 2 or X.dim() != 3:
        raise ValueError(
            f"shapes {tuple(blocks.shape)}, {tuple(block_cols.shape)}, "
            f"{tuple(X.shape)}: expected [nbr, maxb, bs, bs], [nbr, maxb] "
            "and [nb, bs, r]")
    nbr, maxb, bs, bs2 = blocks.shape
    if bs2 != bs or X.shape[1] != bs or \
            tuple(block_cols.shape) != (nbr, maxb):
        raise ValueError(
            f"shapes {tuple(blocks.shape)}, {tuple(block_cols.shape)}, "
            f"{tuple(X.shape)} do not match")
    if not (blocks.is_contiguous() and block_cols.is_contiguous()
            and X.is_contiguous()):
        raise ValueError("bsr_spmm takes contiguous tensors")


def bsr_spmm(blocks: torch.Tensor, block_cols: torch.Tensor,
             X: torch.Tensor) -> torch.Tensor:
    """Y [nbr, bs, r] = the BSR product.  CPU tensors: plain version; CUDA
    tensors: the kernel (bs ∈ {32, 64, 128}, r a multiple of 32).  The
    block-column indices must lie in [0, nb) (:class:`BsrSpmm` checks)."""
    _check(blocks, block_cols, X)
    if blocks.device.type == "cpu":
        bsr_spmm.twin_calls += 1
        return bsr_spmm_ref(blocks, block_cols, X)
    if blocks.device.type != "cuda":
        raise ValueError(f"bsr_spmm has no kernel for {blocks.device}")
    nbr, maxb, bs, _ = blocks.shape
    r = X.shape[2]
    if bs not in BLOCK_SIZES or r % TILE_COLS:
        raise ValueError(f"the kernel takes bs in {BLOCK_SIZES} and r a "
                         f"multiple of {TILE_COLS}, got bs={bs}, r={r}")
    lib = build()["lib"]
    Y = X.new_empty(nbr, bs, r)
    with torch.cuda.device(blocks.device):
        code = lib.bsr_spmm_c64(
            blocks.data_ptr(), block_cols.data_ptr(), X.data_ptr(),
            Y.data_ptr(), nbr, maxb, bs, r,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, "bsr_spmm", code)
    bsr_spmm.launches += 1
    return Y


bsr_spmm.launches = 0
bsr_spmm.twin_calls = 0


class BsrSpmm(nn.Module):
    """Device-resident BSR operator: Y = A X in complex64 on a panel of
    ``nrhs`` columns (counterpart of the JAX package's ``PallasBsrSpmm``)."""

    def __init__(self, bsr: BsrOperator, device, nrhs: int = 128):
        super().__init__()
        nb = bsr.n // bsr.bs
        if bsr.block_cols.size and not (
                0 <= bsr.block_cols.min() and bsr.block_cols.max() < nb):
            raise ValueError("block column index out of range")
        self.bs, self.n, self.nrhs = bsr.bs, bsr.n, nrhs
        self.nbr, self.maxb = bsr.block_cols.shape
        self.nnz_blocks = int(np.count_nonzero(bsr.block_mask))
        #: nonzero entries of the blocks
        self.nnz = int(np.count_nonzero(bsr.blocks))
        #: work of one apply (flops): what the product needs, and what the
        #: kernel does on whole blocks (as the JAX bench counts it)
        self.flops = 8.0 * self.nnz * nrhs
        self.padded_flops = 8.0 * self.nnz_blocks * bsr.bs ** 2 * nrhs
        self.register_buffer("blocks", torch.from_numpy(
            np.ascontiguousarray(bsr.blocks.astype(np.complex64))),
            persistent=False)
        self.register_buffer("block_cols", torch.from_numpy(
            np.ascontiguousarray(bsr.block_cols, np.int32)),
            persistent=False)
        self.to(device)

    def panel(self, X) -> torch.Tensor:
        """Host [n_logical, nrhs] -> device complex64 panel [nb, bs, nrhs]
        (zero-padded rows)."""
        X = torch.as_tensor(np.asarray(X, np.complex64))
        Xp = X.new_zeros(self.n, self.nrhs)
        Xp[:X.shape[0]] = X
        return Xp.view(-1, self.bs, self.nrhs).to(self.blocks.device)

    def forward(self, X) -> np.ndarray:
        """X [n_logical, nrhs] complex (host) -> Y [n_logical, nrhs]
        complex64 (host)."""
        n_logical = np.asarray(X).shape[0]
        Y = bsr_spmm(self.blocks, self.block_cols, self.panel(X))
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
    permutation and BSR structure of its union pattern, which do not depend
    on z, the device operator, and where each union entry lands in its
    blocks.  :meth:`load` writes the values of L(z) into the blocks."""

    def __init__(self, stack, bs: int, device, nrhs: int):
        self.perm, Ar, _ = _tagged_permutation(stack)
        bsr = BsrOperator.from_csr(Ar, bs=bs)
        flat = bsr.blocks.reshape(-1)
        dest = np.flatnonzero(flat)
        self.src = flat[dest].real.astype(np.int64) - 1
        self.op = BsrSpmm(bsr, device, nrhs=nrhs)
        self.op.blocks.zero_()
        self.dest = torch.from_numpy(dest).to(self.op.blocks.device)

    def load(self, data: np.ndarray):
        """Write the union-pattern values ``data`` [nnz] into the blocks."""
        vals = torch.from_numpy(data[self.src].astype(np.complex64))
        self.op.blocks.view(-1)[self.dest] = vals.to(self.op.blocks.device)

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
        Y = window_spmm(self.op.indptr, self.op.cols, vals, Xd)
        return Y[self.inv].cpu().numpy()


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


__all__ = ["bsr_spmm", "bsr_spmm_ref", "build", "BsrSpmm", "ApplyPlan",
           "WindowPlan", "operator_apply", "random_panel", "BLOCK_SIZES",
           "TILE_COLS"]
