"""Global configuration of the PyTorch port.

Two numeric regimes, as in the JAX package:

* **reference precision** (numpy complex128) for the host orchestration:
  mesh, FEM tables, CSR, the coefficient algebra and the polish's
  Arnoldi and quotients (its LU is complex128 on the device,
  :mod:`..nlevp.polish`);
* **device precision** for the device step: complex64 for the inner
  solvers (the slab factorization and the block-Thomas kernel, the dense
  GMRES kernel), complex128 for the residual refinement and the Rayleigh
  quotients.  The general local engine's ``DeviceLU`` and ``DeviceGMRES``
  (:mod:`..ops.device_solve`) compute in complex128, as the JAX package's
  do on every device but a TPU.

Reduced-precision matrix passes broke GMRES orthogonality and the
coefficient contractions in the JAX package, which forces full float32
matmul precision (``utils/config.py`` there).  The port does the same:
TF32 is off for matmuls and cuDNN.
"""
from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

#: dtype of the host orchestration layer (matches the reference).
CDTYPE = np.complex128
#: index dtype of the sparse structures.
IDTYPE = np.int32

#: torch dtypes of the device step.
TORCH_CDTYPE = torch.complex128
DEVICE_CDTYPE = torch.complex64


# ---------------------------------------------------------------------------
# shifted-solve backend (the reference's UMFPACK role), the JAX package's
# four values:
#   'host'         scipy SuperLU / LAPACK on the host
#   'device'       DeviceLU (dense LU) up to DEVICE_DENSE_MAX_DIM, DeviceGMRES
#                  above, on the solver's ``device``
#   'device_lu' / 'device_gmres'   force one of the two
# The port's default is "device", where the JAX package's is "host": the
# port's entry points run on the card unless the caller asks for the CPU.
# There is no environment variable; call set_solve_backend.

_SOLVE_BACKENDS = ("host", "device", "device_lu", "device_gmres")
_solve_backend = "device"


def solve_backend() -> str:
    """Current default backend of :func:`..ops.linsolve.factorize`."""
    return _solve_backend


def set_solve_backend(backend: str) -> str:
    """Set the default shifted-solve backend; returns the previous value
    (so callers can restore it)."""
    global _solve_backend
    if backend not in _SOLVE_BACKENDS:
        raise ValueError(f"unknown solve backend {backend!r}; "
                         f"one of {_SOLVE_BACKENDS}")
    prev = _solve_backend
    _solve_backend = backend
    return prev


__all__ = ["CDTYPE", "IDTYPE", "TORCH_CDTYPE", "DEVICE_CDTYPE",
           "solve_backend", "set_solve_backend"]
