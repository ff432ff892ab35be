from .bsr_spmm import (BsrSpmm, bsr_spmm, bsr_spmm_packed_ref, bsr_spmm_ref,
                       operator_apply)
from .dense_gmres import dense_gmres, dense_gmres_ref
from .device import BsrOperator, DeviceStackedOperator, EllOperator, spmv_ell
from .gmres import (BatchedBlockDiagInv, block_jacobi, gmres,
                    solve_shifted_batch)
from .linsolve import (DenseLU, Factorization, SingularMatrixError, SparseLU,
                       factorize, factorize_with_fallback)
from .reorder import bandwidth, cuthill_mckee, permute_csr
from .slab_solve import SlabPartition, bfs_levels
from .slab_thomas import slab_thomas, slab_thomas_ref
from .sparse import (CSR, StackedOperator, coo_sum_duplicates, csr_to_ell,
                     union_pattern)
from .window_spmm import WindowSpmm, window_spmm, window_spmm_ref

__all__ = ["CSR", "StackedOperator", "coo_sum_duplicates", "union_pattern",
           "DenseLU", "SparseLU", "Factorization", "SingularMatrixError",
           "factorize", "factorize_with_fallback", "gmres", "block_jacobi",
           "solve_shifted_batch", "SlabPartition", "bfs_levels", "slab_thomas",
           "slab_thomas_ref", "dense_gmres", "dense_gmres_ref",
           "BatchedBlockDiagInv", "BsrOperator", "BsrSpmm", "bsr_spmm",
           "bsr_spmm_ref", "bsr_spmm_packed_ref", "operator_apply",
           "cuthill_mckee", "permute_csr", "bandwidth", "csr_to_ell",
           "EllOperator", "spmv_ell",
           "DeviceStackedOperator", "WindowSpmm", "window_spmm",
           "window_spmm_ref"]
