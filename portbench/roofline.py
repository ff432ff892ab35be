"""Published peaks of one NVIDIA H100 SXM and the work of the port's
kernels, counted from their shapes.

Peaks: HBM3 at 3.35 TB/s and 67 TFLOP/s in float32 outside the tensor
cores (NVIDIA's data sheet, at the 700 W power limit).  A kernel's bound
time is the larger of its bytes over the bandwidth and its operations
over the rate: each input byte read once, each output byte written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def slab_thomas_work(sides: int, m: int, s: int):
    """(bytes, flops) of one block-Thomas launch (kernel K3) at
    (sides, m, s): the complex64 stream [sides, 2m, s, s] and bt
    [sides, m, s] read once, x [sides, m, s] written once; 8 real
    operations per complex multiply-add of the 2m [1, s] × [s, s]
    products of each side."""
    stream = sides * 2 * m * s * s
    vec = sides * m * s
    return 8 * (stream + 2 * vec), 8 * sides * 2 * m * s * s


__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS_PER_S", "bound_s",
           "slab_thomas_work"]
