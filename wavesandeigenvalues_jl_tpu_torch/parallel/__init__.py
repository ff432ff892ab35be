"""The distributed layer on torch.distributed, and device-batched Beyn.

Counterpart of the JAX package's ``parallel/``: row partitioning
(:mod:`.partition`), the device mesh and the row parts a rank holds
(:mod:`.mesh`), the halo-exchange SpMV (:mod:`.dist_spmv`), the
(shift × row)-sharded GMRES (:mod:`.dist_solve`), the batched and
distributed Beyn contour (:mod:`.dist_beyn`), multi-process set-up and the
pod mesh (:mod:`.multihost`), scaling records (:mod:`.scaling`) and the
multi-rank dry run (:mod:`.dryrun`)."""
from .dist_beyn import (DENSE_BEYN_MAX_DIM, batched_moments, beyn_batched,
                        beyn_dist, dist_moments, matfree_moments)
from .dist_spmv import dist_dot, halo_exchange, make_dist_spmm, make_dist_spmv
from .multihost import init_multihost, pod_mesh, pod_spec_check
from .partition import RowPartitionedEll, partition_rows, partition_stack

__all__ = ["batched_moments", "beyn_batched", "dist_dot", "halo_exchange",
           "make_dist_spmv", "make_dist_spmm", "RowPartitionedEll",
           "partition_rows", "partition_stack", "init_multihost",
           "pod_mesh", "pod_spec_check", "matfree_moments", "dist_moments",
           "beyn_dist", "DENSE_BEYN_MAX_DIM"]
