"""The dense cell ``rijke1369.mslp_map``: its control comes out not correct
at the cell's own size (1,369 DOF, where its limits were set; the
reference alone, a few seconds on the CPU), and the program's dense
engine agrees with the reference at seeded draws of its mix at a CPU size
(437 DOF)."""
import itertools
import os

import numpy as np
import pytest

from portbench.control import control_numbers
from portbench.harness import load_json
from portbench.problems import rijke_tube
from portbench.reference.solve import newton, residual
from portbench.requests import requests

from .conftest import ROOT, small

CELL = "rijke1369.mslp_map"


@pytest.mark.parametrize("workload", [CELL])
def test_control_fails_a_limit(workload):
    mix = load_json(os.path.join(ROOT, "portbench", "traffic",
                                 "mslp_map_dense.json"))
    mix["check"]["sample"] = 3
    rows = control_numbers(workload, [2 ** 31 + 5], 3, device="cpu",
                           root=ROOT, mix=mix)
    for row in rows:
        assert row["checked"] > 0
        assert any(row["numbers"][k] > row["limits"][k]
                   for k in row["limits"]), row


@pytest.fixture(scope="module")
def families():
    cfg, mix = small(CELL)
    mesh = rijke_tube.mesh(cfg)
    return (rijke_tube.port_family(mesh, cfg),
            rijke_tube.reference_family(mesh, cfg), mix)


@pytest.mark.parametrize("seed,index", [(2 ** 31 + 21, 0), (2 ** 31 + 21, 5),
                                        (2 ** 33 + 7, 2)])
def test_dense_mslp_matches_the_reference_at_drawn_points(families, seed,
                                                          index):
    """One request of the mix, drawn from the seed: flag 0 on the dense
    engine, ω within 1e-12 of the reference's complex128 Newton from it,
    and a residual below 1e-13 in the reference's L(ω)."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp
    from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local import \
        FusedPencilSolver
    L, R, mix = families
    req = next(itertools.islice(requests(mix, seed), index, None))
    params = {k: req[k] for k in rijke_tube.PORT_NAMES}
    for k, v in params.items():
        L.params[rijke_tube.PORT_NAMES[k]] = v
    sol, _, flag = mslp(L, req["z0"], device="cpu", **mix["solver"])
    assert isinstance(L._fused_solver[1], FusedPencilSolver)
    om = complex(sol.params[sol.eigval])
    assert flag == 0 and np.isfinite(om)
    z_ref, _, ok = newton(R, om, params, tol=1e-13)
    assert ok and abs(om - z_ref) / abs(z_ref) < 1e-12
    assert residual(R.matrix(om, params), sol.v) < 1e-13
