"""The complex128 Newton polish step after a fused device loop.

One step of the two-sided Rayleigh-functional Newton iteration at z: the
shift-invert Arnoldi of the pencil (L(z), M) from the right vector and,
with the same factor, of its adjoint from the left vector (the
reference's back-to-back ARPACK calls, Householder.jl:100-101), then
dz = −λ/λ′ with λ′ = ŵᴴL′(z)v̂ / ŵᴴMv̂.  The fused local engines
(:func:`.fused_local.try_fused_local`) and the Bloch sweep
(:func:`.bloch_sweep.bloch_mode_sweep`) both call :func:`polish_step`;
each keeps its own loop, stopping tests and error handling.

Where L(z) is factored (:func:`polish_factor`): up to
``POLISH_DEVICE_MAX_DIM`` on the caller's device, in complex128, as a
:class:`..ops.device_solve.DeviceLU` (the CSR scattered to a dense matrix
there, rows equilibrated, ``torch.linalg.lu_factor_ex``: cuSOLVER's zgetrf
on a card, LAPACK on the CPU), and every operator application of the
Arnoldi is one ``lu_solve`` there with no refinement, as a SuperLU solve
is one solve.  Above it, where the device factor has a zero or non-finite
pivot, or where the device has not the memory for it, the host factors as
the JAX package does (SuperLU, with a dense LAPACK retry).  The counter
``polish.factor`` is keyed ``device`` or ``host``, once a step.  The JAX
package polishes on the host only because a TPU has no complex128.

The callers keep the device iterate where the numerics refuse a step
(``RuntimeError``, ``LinAlgError``).  Any other torch error in the device
factor or its solves is a fault, raised as :class:`DeviceFault`, which
they let through.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.device_solve import DeviceLU
from ..ops.linsolve import Factorization, factorize
from ..utils.timing import count, phase
from .eigs import eigs_shift_invert
from .family import OperatorFamily

#: largest dimension whose polish factors on the device, the slab cell's
#: 7,259 DOF rounded up: the largest measured (PERF.md §6).  The dense
#: zgetrf grows as n³ and SuperLU's fill on these meshes far more slowly,
#: so above it the crossover is unmeasured
POLISH_DEVICE_MAX_DIM = 8192


class DeviceFault(Exception):
    """A torch error in the polish's device factor or solves other than
    the factor's out-of-memory.  Not a ``RuntimeError``, so that the
    callers' ``except``, which keeps the device iterate where the numerics
    refuse a step, lets it through."""


def polish_factor(A, device) -> Factorization:
    """The factor of L(z) for one polish step: on ``device`` up to
    ``POLISH_DEVICE_MAX_DIM`` (one solve a call, no refinement) unless its
    factor has a zero or non-finite pivot or runs out of the device's
    memory, else on the host, which raises ``SingularMatrixError`` where it
    fails too.  Returns once the factor has finished (``DeviceLU.ok`` waits
    for the device)."""
    if A.shape[0] <= POLISH_DEVICE_MAX_DIM:
        try:
            F = DeviceLU(A, device, refine=False)
        except torch.cuda.OutOfMemoryError:
            F = None
        except RuntimeError as err:
            raise DeviceFault("the polish's device factor failed") from err
        if F is not None and F.ok:
            count("polish.factor", key="device")
            return F
        del F
    count("polish.factor", key="host")
    return factorize(A, check=True, backend="host")


def polish_step(L: OperatorFamily, z: complex, v: np.ndarray,
                v_adj: np.ndarray, device):
    """One complex128 Newton step at z from the right and left vectors v
    and v_adj: (dz, λ, v̂, ŵ).  Sets L's eigenvalue to z and its auxiliary
    value to 0.  Phases ``assemble`` (L(z), L′(z), M), ``lu``, ``arnoldi``
    (both runs, m = 8) and ``quotient``, under the caller's open phase."""
    with phase("assemble"):
        L.params[L.eigval] = z
        L.params[L.auxval] = 0.0
        A = L(z)
        A1 = L(z, 1)
        M = L.aux_weight()
    with phase("lu"):
        F = polish_factor(A, device)
    with phase("arnoldi"):
        try:
            lam, V = eigs_shift_invert(A, M, nev=1, v0=v, m=8, factor=F)
            _, W = eigs_shift_invert(A, M, nev=1, v0=v_adj, m=8, factor=F,
                                     adjoint=True)
        except RuntimeError as err:
            # the host Arnoldi raises LinAlgError; a RuntimeError here is
            # the device's solves
            if isinstance(F, DeviceLU):
                raise DeviceFault("a polish solve on the device "
                                  "failed") from err
            raise
    with phase("quotient"):
        lam_p = complex(lam[0])
        vh = V[:, 0]
        wh = W[:, 0]
        lam_d = np.vdot(wh, A1 @ vh) / np.vdot(wh, M @ vh)
        dz = -lam_p / lam_d
    return dz, lam_p, vh, wh


__all__ = ["polish_step", "polish_factor", "DeviceFault",
           "POLISH_DEVICE_MAX_DIM"]
