"""Global configuration of the PyTorch port.

Two numeric regimes, as in the JAX package:

* **reference precision** (numpy complex128) for the host orchestration:
  mesh, FEM tables, CSR, the coefficient algebra and the scipy polish;
* **device precision** for the device step: complex64 for the inner
  solvers (the slab factorization and the block-Thomas kernel, the dense
  GMRES kernel), complex128 for the residual refinement and the Rayleigh
  quotients.

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
# shifted-solve backend (the reference's UMFPACK role).  The port implements
# the fused device engine only; the host engine is ROADMAP.md Queue 1,
# "host _local_engine with perturbation.py".

_SOLVE_BACKENDS = ("device",)
_solve_backend = "device"


def solve_backend() -> str:
    """Current default backend of the local eigensolvers."""
    return _solve_backend


def set_solve_backend(backend: str) -> str:
    """Set the default shifted-solve backend; returns the previous value."""
    global _solve_backend
    if backend == "host" or backend.startswith("device_"):
        raise NotImplementedError(
            f"solve backend {backend!r} is not ported yet (ROADMAP.md "
            "Queue 1: host _local_engine with perturbation.py)")
    if backend not in _SOLVE_BACKENDS:
        raise ValueError(f"unknown solve backend {backend!r}; "
                         f"one of {_SOLVE_BACKENDS}")
    prev = _solve_backend
    _solve_backend = backend
    return prev


__all__ = ["CDTYPE", "IDTYPE", "TORCH_CDTYPE", "DEVICE_CDTYPE",
           "solve_backend", "set_solve_backend"]
