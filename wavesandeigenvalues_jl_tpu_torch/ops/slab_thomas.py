"""Block-tridiagonal (Thomas) substitution: kernel K3 of the port.

:func:`slab_thomas` runs the whole forward + backward recursion of the
slab-direct solve (see ``csrc/slab_thomas.cu`` for the recursion and the
layout) as one launch of a hand-written CUDA kernel, the counterpart of the
Pallas TPU kernel ``wavesandeigenvalues_jl_tpu/ops/pallas_thomas.py ::
build_slab_thomas``.

* The kernel runs each side on a thread-block cluster: every block owns a
  column stripe of the blocks, a producer warp streams the stripes ahead
  of the recursion through a shared-memory ring, and the carry row goes
  to every block of the cluster through distributed shared memory.
* :func:`slab_thomas_ref` is its plain PyTorch version: a Python loop of
  [1, s] x [s, s] products.
* :func:`slab_thomas` takes the plain version only for tensors that lie on
  the CPU; for CUDA tensors it launches the kernel or raises.  It counts
  its launches and its CPU calls in ``utils.timing``'s counters
  ``slab_thomas.launches`` and ``slab_thomas.twin_calls``, keyed by the
  shape (sides, m, s).
* The kernel is compiled from the repository's source on first use with
  ``nvcc`` and loaded with ctypes (:mod:`.cuda_build`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import timing
from . import cuda_build

#: the kernel takes slab widths s that are a multiple of this, up to S_MAX
#: (its double-buffered carry row and two ring stages fill shared memory)
S_MULTIPLE = 128
S_MAX = 9472


def slab_thomas_ref(stream: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch block-Thomas substitution (same contract as the
    kernel): stream [sides, 2m, s, s], bt [sides, m, s] -> x [sides, m, s]."""
    sides, m2, s, _ = stream.shape
    m = m2 // 2
    x = torch.empty_like(bt)
    prev = torch.zeros(sides, 1, s, dtype=bt.dtype, device=bt.device)
    for i in range(m):                               # y_i = bt_i - y_{i-1} Wᵀ_i
        prev = bt[:, i:i + 1] - prev @ stream[:, i]
        x[:, i] = prev[:, 0]
    prev = torch.zeros_like(prev)
    for i in range(m):                               # x_j = y_j - x_{j+1} Cᵀ_j
        j = m - 1 - i
        prev = x[:, j:j + 1] - prev @ stream[:, m + i]
        x[:, j] = prev[:, 0]
    return x


@functools.cache
def build() -> dict:
    """Compile ``csrc/slab_thomas.cu`` (once per source hash) and load it:
    {"lib", "path", "seconds", "log"} (see :func:`.cuda_build.load`)."""
    info = cuda_build.load("slab_thomas")
    fn = info["lib"].slab_thomas_c64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return info


def _check(stream: torch.Tensor, bt: torch.Tensor):
    if stream.dtype != torch.complex64 or bt.dtype != torch.complex64:
        raise TypeError(f"slab_thomas takes complex64, got {stream.dtype} "
                        f"and {bt.dtype}")
    if stream.device != bt.device:
        raise ValueError(f"stream on {stream.device}, bt on {bt.device}")
    if stream.dim() != 4 or bt.dim() != 3:
        raise ValueError(f"shapes {tuple(stream.shape)}, {tuple(bt.shape)}: "
                         "expected [sides, 2m, s, s] and [sides, m, s]")
    sides, m, s = bt.shape
    if tuple(stream.shape) != (sides, 2 * m, s, s):
        raise ValueError(f"stream shape {tuple(stream.shape)} does not "
                         f"match bt shape {tuple(bt.shape)}")
    if not (stream.is_contiguous() and bt.is_contiguous()):
        raise ValueError("slab_thomas takes contiguous tensors")


def slab_thomas(stream: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """x [sides, m, s] = block-Thomas substitution of bt through the W/C
    stream.  CPU tensors: plain version; CUDA tensors: the kernel (s a
    multiple of 128, as ``FusedSlabPencilSolver`` pads it, up to 9,472)."""
    _check(stream, bt)
    sides, m, s = bt.shape
    if stream.device.type == "cpu":
        timing.count("slab_thomas.twin_calls", key=(sides, m, s))
        return slab_thomas_ref(stream, bt)
    if stream.device.type != "cuda":
        raise ValueError(f"slab_thomas has no kernel for {stream.device}")
    if s % S_MULTIPLE or s > S_MAX or stream.data_ptr() % 16 or \
            bt.data_ptr() % 16:
        raise ValueError(f"the kernel takes s a multiple of {S_MULTIPLE} up "
                         f"to {S_MAX} and 16-byte aligned tensors, got "
                         f"s={s}")
    lib = build()["lib"]
    x = torch.empty_like(bt)
    with torch.cuda.device(stream.device):
        code = lib.slab_thomas_c64(
            stream.data_ptr(), bt.data_ptr(), x.data_ptr(), sides, m, s,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, "slab_thomas", code)
    timing.count("slab_thomas.launches", key=(sides, m, s))
    return x


__all__ = ["slab_thomas", "slab_thomas_ref", "build", "S_MULTIPLE",
           "S_MAX"]
