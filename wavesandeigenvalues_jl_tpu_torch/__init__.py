"""wavesandeigenvalues_jl_tpu_torch — the PyTorch/CUDA port of
``wavesandeigenvalues_jl_tpu``.

The JAX package stays beside this one as the reference; the port is held
against it slice by slice (ROADMAP.md).  Host code (mesh, FEM tables, CSR,
coefficient algebra) is numpy as in the JAX package; the device step and
the complex128 polish's LU are PyTorch, and every Pallas kernel on a
ported path is a hand-written CUDA kernel under ``csrc/``.  The port never
imports jax.

Subpackages: ``mesh``, ``fem``, ``models``, ``nlevp``, ``ops``,
``parallel``, ``utils``, and ``native`` (the host C++ library).
"""
from .utils import config  # noqa: F401  (sets the TF32 flags, dtypes)

__version__ = "0.1.0"


def __getattr__(name):
    # lazy subpackage access, as in the JAX package
    import importlib
    if name in ("mesh", "fem", "models", "nlevp", "ops", "parallel",
                "utils", "native"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
