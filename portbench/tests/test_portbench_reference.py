"""The plain reference against a CPU run of the program at a small size:
the assembled family and the judged answers."""
import numpy as np
import scipy.sparse as sp

from portbench.problems import rijke_tube
from portbench.reference.solve import family_gap, newton, residual

from .conftest import small


def _csr(A):
    return sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)


def test_rijke_family_and_mslp_at_437():
    from wavesandeigenvalues_jl_tpu_torch.models import active_rijke_family
    from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp
    cfg, _ = small("rijke7259.mslp_map")
    mesh = rijke_tube.mesh(cfg)
    R = rijke_tube.reference_family(mesh, cfg)
    assert R.n == 437
    z = 2 * np.pi * 300 + 50j
    for L in (rijke_tube.port_family(mesh, cfg), active_rijke_family()):
        L.params["λ"] = 0.0
        assert family_gap(_csr(L(z)), R.matrix(z)) < 1e-14
    L = rijke_tube.port_family(mesh, cfg)
    sol, _, flag = mslp(L, 340 * 2 * np.pi, maxiter=20, tol=1e-11,
                        device="cpu")
    om = sol.params["ω"]
    assert flag == 0
    z_ref, _, ok = newton(R, om, tol=1e-13)
    assert ok and abs(om - z_ref) / abs(z_ref) < 1e-12
    assert residual(R.matrix(om), sol.v) < 1e-13
    # the answer of tests/test_fused_slab.py's family
    assert abs(om - (1074.9363291294444 + 373.1589412263712j)) < 1e-8
