"""The work of kernel K2 (``dense_gmres_kernel``, the one-launch dense
GMRES of the port's dense local engine), counted from its launch shape.
The bound time is :func:`.roofline.bound_s` of it."""
from __future__ import annotations


def dense_gmres_work(S: int, N: int, m: int, cycles: int):
    """(bytes, flops) of one K2 launch at (S, N, m, cycles): the complex64
    operators P [S, N, N] and right-hand sides b [S, N] read once and x
    [S, N] written once; float32 operations of GMRES(m) from x0 = 0, with m
    matvecs a cycle plus one for the residual of each restart (the first
    cycle's is b), CGS2 dots and updates, norms and x += V y over the m
    basis vectors."""
    nbytes = 8 * (S * N * N + 2 * S * N)
    matvecs = m * cycles + cycles - 1
    per = 32 * N * m * (m + 1) // 2 + (m + 1) * 4 * N + 8 * N * m
    return nbytes, S * (matvecs * 8 * N * N + cycles * per)


__all__ = ["dense_gmres_work"]
