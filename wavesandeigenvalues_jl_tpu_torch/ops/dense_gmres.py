"""Dense restarted GMRES(m) in one launch: kernel K2 of the port.

:func:`dense_gmres` solves ``sides`` independent dense systems P x = b
(P = D⁻¹G, pre-preconditioned by the caller) with ``cycles`` restarts of
exactly ``m`` Arnoldi steps, as ONE cooperative launch of the hand-written
CUDA kernel ``csrc/dense_gmres.cu``: the counterpart of the Pallas TPU
kernel ``wavesandeigenvalues_jl_tpu/ops/pallas_gmres.py ::
build_dense_gmres``.  The source note of the kernel gives its design;
:func:`plan` gives its launch: row blocks per side, rows per block, and
which rows of P stay in shared memory.

* :func:`dense_gmres_ref` is its plain PyTorch version: the same
  arithmetic (CGS2, complex Givens, clamped norms and back substitution)
  as Python loops over complex64 tensors.
* :func:`dense_gmres` takes the plain version only for tensors that lie on
  the CPU; for CUDA tensors it launches the kernel or raises.  It counts
  its launches and its CPU calls in ``utils.timing``'s counters
  ``dense_gmres.launches`` and ``dense_gmres.twin_calls``, keyed by the
  launch shape (sides, N, m, cycles).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import timing
from . import cuda_build

#: N must be a multiple of this (the JAX kernel's lane width)
LANE = 128
#: the largest N the kernel takes: FUSED_MAX_DIM = 1,400 padded to LANE
N_MAX = 1408
_TINY = 1e-37
#: what csrc/dense_gmres.cu takes: threads (and warps) of a block, shared
#: memory of a block on an H100, fewest rows a row block owns, row blocks
#: of a side at most
THREADS, WARPS = 256, 8
SMEM_MAX = 232448
MIN_ROWS = 8
MAX_G = 132


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """[S, n] complex -> [S] float sum of |v|²."""
    return (v.real * v.real + v.imag * v.imag).sum(-1)


def dense_gmres_ref(P: torch.Tensor, b: torch.Tensor, m: int,
                    cycles: int) -> torch.Tensor:
    """Plain PyTorch GMRES(m), ``cycles`` restarts from x0 = 0, exactly m
    Arnoldi steps each (same contract as the kernel): P [S, N, N], b [S, N]
    complex64 -> x [S, N].  complex128 inputs run it in double precision
    (the yardstick of the kernel on inputs where float32 loses digits)."""
    S, N = b.shape
    dev = b.device
    x = torch.zeros_like(b)
    for _ in range(cycles):
        r = b - (P @ x.unsqueeze(-1)).squeeze(-1)
        beta = _norm2(r).clamp_min(_TINY).sqrt()
        V = b.new_zeros(S, m + 1, N)
        Ht = b.new_zeros(S, m + 1, m + 1)             # Ht[:, j, k] = R[k, j]
        V[:, 0] = r / beta[:, None]
        g = b.new_zeros(S, m + 1)
        g[:, 0] = beta
        cs = torch.zeros(S, m + 1, dtype=b.real.dtype, device=dev)
        sn = b.new_zeros(S, m + 1)
        for j in range(m):
            w = (P @ V[:, j].unsqueeze(-1)).squeeze(-1)
            Vj = V[:, :j + 1]
            h = b.new_zeros(S, m + 1)
            for _ in range(2):                        # CGS2
                hp = (Vj.conj() @ w.unsqueeze(-1)).squeeze(-1)
                w = w - (hp.unsqueeze(1) @ Vj).squeeze(1)
                h[:, :j + 1] += hp
            hn = _norm2(w).clamp_min(_TINY).sqrt()
            V[:, j + 1] = w / hn[:, None]
            h[:, j + 1] = hn
            for k in range(j):                        # earlier rotations
                c, s = cs[:, k], sn[:, k]
                a, bb = h[:, k].clone(), h[:, k + 1].clone()
                h[:, k] = c * a + s * bb
                h[:, k + 1] = -s.conj() * a + c * bb
            a, bb = h[:, j].clone(), h[:, j + 1].clone()
            a2 = a.real * a.real + a.imag * a.imag
            absa = a2.clamp_min(0.0).sqrt()
            den = (a2 + bb.real * bb.real + bb.imag * bb.imag
                   ).clamp_min(_TINY).sqrt()
            c = torch.where(den == 0, torch.ones_like(den), absa / den)
            zero = absa == 0
            safe = torch.where(zero, torch.ones_like(absa), absa)
            ph = torch.where(zero, torch.ones_like(a), a / safe)
            s = ph * bb.conj() / den
            cs[:, j], sn[:, j] = c, s
            h[:, j] = c * a + s * bb
            h[:, j + 1] = 0
            gj = g[:, j].clone()
            g[:, j + 1] = -s.conj() * gj
            g[:, j] = c * gj
            Ht[:, j] = h
        y = b.new_zeros(S, m + 1)
        for i in range(m - 1, -1, -1):                # back substitution
            num = g[:, i] - (y * Ht[:, :, i]).sum(-1)
            d = Ht[:, i, i]
            d2 = (d.real * d.real + d.imag * d.imag).clamp_min(_TINY)
            y[:, i] = num * d.conj() / d2
        x = x + (y.unsqueeze(1) @ V).squeeze(1)
    return x


class Plan(NamedTuple):
    """The launch of K2 for (sides, N, m) on a card of ``n_sm`` SMs: ``G``
    row blocks per side, each owning ``R`` consecutive rows (the last one
    the rest), the first ``res`` of them resident in shared memory and the
    others streamed (the first ``WARPS`` prefetched one a warp, any more
    read from L2 in the matvec), plus one Givens block per side; ``smem``
    bytes of dynamic shared memory a block."""
    sides: int
    N: int
    m: int
    G: int
    R: int
    res: int
    smem: int

    @property
    def grid(self) -> int:
        return self.sides * (self.G + 1)

    def rows(self, g: int) -> range:
        """The rows of P that row block g of a side owns."""
        return range(g * self.R, min(self.N, (g + 1) * self.R))

    def resident(self, g: int) -> int:
        return min(len(self.rows(g)), self.res)

    def streamed(self, g: int) -> int:
        return len(self.rows(g)) - self.resident(g)


def _row_smem(N: int, m: int, R: int, res: int) -> int:
    """Bytes of a row block: resident P rows, v, the V slice, w and x rows,
    a projection, the reduction scratch, an mbarrier (``row_smem`` in the
    source)."""
    return (res * N + N + R * m + 2 * R + m + 1 + THREADS) * 8 + 8


def _givens_smem(m: int) -> int:
    """Bytes of a Givens block: Ht, h1, h2, g, sn, y, the reduction scratch
    and cs."""
    m1 = m + 1
    return (m1 * m1 + 5 * m1 + THREADS) * 8 + 4 * m1


@functools.cache
def plan(sides: int, N: int, m: int, n_sm: int) -> Plan:
    """One row block per SM beside the sides' Givens blocks, with the
    fewest blocks that give the least rows a block (so G = 64, R = 22 at
    (2, 1408, m, 132)), and as many resident rows as shared memory holds
    beside the rest of the block's state.  Raises where the kernel cannot
    take (sides, N, m)."""
    if sides not in (1, 2):
        raise ValueError(f"sides = {sides}: the kernel takes 1 or 2")
    if N % LANE or not 0 < N <= N_MAX:
        raise ValueError(f"N = {N} is not a multiple of {LANE} up to {N_MAX}")
    gmax = min(n_sm // sides - 1, MAX_G)
    if gmax < 1:
        raise ValueError(f"{sides} sides do not fit {n_sm} SMs")
    if m >= THREADS:
        raise ValueError(f"m = {m}: the kernel takes m < {THREADS}")
    R = max(MIN_ROWS, -(-N // gmax))
    G = -(-N // R)
    fixed = _row_smem(N, m, R, 0)
    res = min(R, (SMEM_MAX - fixed) // (8 * N)) if fixed < SMEM_MAX else 0
    if res < 1:
        raise ValueError(f"(sides, N, m) = ({sides}, {N}, {m}): {R} rows a "
                         f"block, {max(res, 0)} fit in shared memory")
    smem = max(_row_smem(N, m, R, res), _givens_smem(m))
    if smem > SMEM_MAX:
        raise ValueError(f"m = {m}: the Givens block needs {smem} bytes")
    return Plan(sides, N, m, G, R, res, smem)


@functools.cache
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def build() -> dict:
    """Compile ``csrc/dense_gmres.cu`` (once per source hash) and load it:
    {"lib", "path", "seconds", "log"} (see :func:`.cuda_build.load`)."""
    info = cuda_build.load("dense_gmres")
    bind(info["lib"])
    return info


def bind(lib):
    """Argument types of the kernel's C entry point."""
    lib.dense_gmres_c64.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.dense_gmres_c64.restype = ctypes.c_int


def _check(P: torch.Tensor, b: torch.Tensor, m: int, cycles: int):
    if P.dtype != torch.complex64 or b.dtype != torch.complex64:
        raise TypeError(f"dense_gmres takes complex64, got {P.dtype} and "
                        f"{b.dtype}")
    if P.device != b.device:
        raise ValueError(f"P on {P.device}, b on {b.device}")
    if P.dim() != 3 or b.dim() != 2:
        raise ValueError(f"shapes {tuple(P.shape)}, {tuple(b.shape)}: "
                         "expected [sides, N, N] and [sides, N]")
    S, N = b.shape
    if tuple(P.shape) != (S, N, N):
        raise ValueError(f"P shape {tuple(P.shape)} does not match b shape "
                         f"{tuple(b.shape)}")
    if N % LANE:
        raise ValueError(f"N = {N} is not a multiple of {LANE}")
    if m < 1 or cycles < 1:
        raise ValueError(f"m = {m} and cycles = {cycles} must be >= 1")
    if not (P.is_contiguous() and b.is_contiguous()):
        raise ValueError("dense_gmres takes contiguous tensors")


def launch(lib, P: torch.Tensor, b: torch.Tensor, m: int, cycles: int,
           n_sm: int | None = None) -> torch.Tensor:
    """One launch of the kernel in ``lib`` on CUDA tensors (checked by the
    caller) with the scratch it needs, planned for a card of ``n_sm`` SMs
    (default: the tensors' card); returns x."""
    S, N = b.shape
    pl = plan(S, N, m, n_sm or sm_count(P.device))
    x = torch.empty_like(b)
    W = b.new_empty(S, m + 1, N)
    part = b.new_empty(S, 2, m * (m + 1) // 2, pl.G)
    pn = torch.empty(S, m + 1, pl.G, dtype=torch.float32, device=b.device)
    y = b.new_empty(S, m + 1)
    sync = torch.zeros(S, 64, dtype=torch.int32, device=b.device)
    code = lib.dense_gmres_c64(
        P.data_ptr(), b.data_ptr(), x.data_ptr(), W.data_ptr(),
        part.data_ptr(), pn.data_ptr(), y.data_ptr(), sync.data_ptr(), S, N,
        m, cycles, pl.G, pl.R, pl.res,
        torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, "dense_gmres", code)
    return x


def dense_gmres(P: torch.Tensor, b: torch.Tensor, m: int,
                cycles: int) -> torch.Tensor:
    """x [sides, N] ≈ P⁻¹b by GMRES(m) with ``cycles`` restarts.  CPU
    tensors: plain version; CUDA tensors: one launch of the kernel."""
    _check(P, b, m, cycles)
    shape = (*b.shape, m, cycles)
    if P.device.type == "cpu":
        timing.count("dense_gmres.twin_calls", key=shape)
        return dense_gmres_ref(P, b, m, cycles)
    if P.device.type != "cuda":
        raise ValueError(f"dense_gmres has no kernel for {P.device}")
    lib = build()["lib"]
    with torch.cuda.device(P.device):
        x = launch(lib, P, b, m, cycles)
    timing.count("dense_gmres.launches", key=shape)
    return x


__all__ = ["dense_gmres", "dense_gmres_ref", "build", "plan", "Plan",
           "LANE", "N_MAX"]
