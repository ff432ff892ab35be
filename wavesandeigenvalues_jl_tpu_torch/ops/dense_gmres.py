"""Dense restarted GMRES(m) in one launch: kernel K2 of the port.

:func:`dense_gmres` solves ``sides`` independent dense systems P x = b
(P = D⁻¹G, pre-preconditioned by the caller) with ``cycles`` restarts of
exactly ``m`` Arnoldi steps, as ONE cooperative launch of the hand-written
CUDA kernel ``csrc/dense_gmres.cu``: the counterpart of the Pallas TPU
kernel ``wavesandeigenvalues_jl_tpu/ops/pallas_gmres.py ::
build_dense_gmres``.  The source note of the kernel gives its design.

* :func:`dense_gmres_ref` is its plain PyTorch version: the same
  arithmetic (CGS2, complex Givens, clamped norms and back substitution)
  as Python loops over complex64 tensors.
* :func:`dense_gmres` takes the plain version only for tensors that lie on
  the CPU; for CUDA tensors it launches the kernel or raises.  It counts
  its launches (``dense_gmres.launches``) and its CPU calls
  (``dense_gmres.twin_calls``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

#: N must be a multiple of this (the JAX kernel's lane width)
LANE = 128
_TINY = 1e-37


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """[S, n] complex -> [S] float sum of |v|²."""
    return (v.real * v.real + v.imag * v.imag).sum(-1)


def dense_gmres_ref(P: torch.Tensor, b: torch.Tensor, m: int,
                    cycles: int) -> torch.Tensor:
    """Plain PyTorch GMRES(m), ``cycles`` restarts from x0 = 0, exactly m
    Arnoldi steps each (same contract as the kernel): P [S, N, N], b [S, N]
    complex64 -> x [S, N]."""
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
        cs = torch.zeros(S, m + 1, dtype=torch.float32, device=dev)
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


@functools.cache
def build() -> dict:
    """Compile ``csrc/dense_gmres.cu`` (once per source hash) and load it:
    {"lib", "path", "seconds", "log"} (see :func:`.cuda_build.load`)."""
    info = cuda_build.load("dense_gmres")
    lib = info["lib"]
    lib.dense_gmres_blocks_per_side.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.dense_gmres_blocks_per_side.restype = ctypes.c_int
    lib.dense_gmres_c64.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.dense_gmres_c64.restype = ctypes.c_int
    return info


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


def dense_gmres(P: torch.Tensor, b: torch.Tensor, m: int,
                cycles: int) -> torch.Tensor:
    """x [sides, N] ≈ P⁻¹b by GMRES(m) with ``cycles`` restarts.  CPU
    tensors: plain version; CUDA tensors: one launch of the kernel."""
    _check(P, b, m, cycles)
    if P.device.type == "cpu":
        dense_gmres.twin_calls += 1
        return dense_gmres_ref(P, b, m, cycles)
    if P.device.type != "cuda":
        raise ValueError(f"dense_gmres has no kernel for {P.device}")
    lib = build()["lib"]
    S, N = b.shape
    with torch.cuda.device(P.device):
        G = ctypes.c_int(0)
        cuda_build.check(lib, "dense_gmres", lib.dense_gmres_blocks_per_side(
            S, N, m, ctypes.byref(G)))
        G = G.value
        x = torch.empty_like(b)
        V = b.new_empty(S, m + 1, N)
        part = b.new_empty(S, 3, m + 1, G)
        y = b.new_empty(S, m + 1)
        code = lib.dense_gmres_c64(
            P.data_ptr(), b.data_ptr(), x.data_ptr(), V.data_ptr(),
            part.data_ptr(), y.data_ptr(), S, N, m, cycles, G,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, "dense_gmres", code)
    dense_gmres.launches += 1
    return x


dense_gmres.launches = 0
dense_gmres.twin_calls = 0


__all__ = ["dense_gmres", "dense_gmres_ref", "build", "LANE"]
