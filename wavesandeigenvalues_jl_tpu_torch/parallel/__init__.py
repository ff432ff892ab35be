"""Device-batched Beyn contour integration (single device).

Counterpart of the JAX package's ``parallel/``: the single-device part of
``dist_beyn`` is ported; the sharded layer (``partition``, ``dist_spmv``,
``dist_solve``, ``dist_moments``, ``multihost``) is ROADMAP.md Queue 1
item 8."""
from .dist_beyn import (DENSE_BEYN_MAX_DIM, batched_moments, beyn_batched,
                        matfree_moments)

__all__ = ["batched_moments", "matfree_moments", "beyn_batched",
           "DENSE_BEYN_MAX_DIM"]
