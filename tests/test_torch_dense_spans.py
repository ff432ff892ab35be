"""What the dense local engine (nlevp/fused_local.FusedPencilSolver)
records in ``utils.timing`` on the small active Rijke tube (n = 437,
N = 512), on the CPU: the block-Jacobi refresh's span and counter, and
kernel K2's calls keyed by their shape.  The same keys on the card are
checked in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

from wavesandeigenvalues_jl_tpu_torch.models.rijke import active_rijke_family
from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local import (
    GMRES_CYCLES, GMRES_M, FusedPencilSolver)
from wavesandeigenvalues_jl_tpu_torch.utils import timing

from port_threads import one_thread  # noqa: F401

Z0 = 340 * 2 * np.pi
REFRESH = "fused_local.bj_refresh"
#: the (n, τ) points of the requests: two corners of the stability map
POINTS = ((1.0, 0.001), (0.5, 0.0015))


@pytest.fixture(scope="module")
def solved():
    """The span records and counters of two dense mslp requests on one
    family."""
    L = active_rijke_family()
    timing.reset()
    flags = []
    for n, tau in POINTS:
        L.params["n"], L.params["τ"] = n, tau
        flags.append(mslp(L, Z0, maxiter=20, tol=1e-11, device="cpu")[2])
    spans = timing.spans()
    counted = {name: timing.counts(name) for name in
               (REFRESH, "dense_gmres.twin_calls", "dense_gmres.launches")}
    counted["total"] = timing.total("dense_gmres.twin_calls")
    roots = [s for s in spans if s.id == s.request]
    by_request = {r.id: {name: timing.counts(name, request=r.id)
                         for name in counted if name != "total"}
                  for r in roots}
    timing.reset()
    return L, flags, spans, roots, counted, by_request


def test_requests_run_on_the_dense_engine(solved):
    L, flags, _, roots, _, _ = solved
    assert isinstance(L._fused_solver[1], FusedPencilSolver)
    assert flags == [0] * len(POINTS)
    assert len(roots) == len(POINTS)
    assert all(r.attrs["engine"] == "FusedPencilSolver" for r in roots)


def test_bj_refresh_spans_equal_its_counter(solved):
    """One ``bj_refresh`` span for each count of the refresh, at least one
    a request, under the step's ``coefficients`` or at request level."""
    _, _, spans, roots, counted, by_request = solved
    refreshes = [s for s in spans if s.name == "bj_refresh"]
    assert len(refreshes) == sum(counted[REFRESH].values())
    assert set(counted[REFRESH]) == {None}
    assert {s.path for s in refreshes} <= {
        "fused_local.device_step.coefficients.bj_refresh", "bj_refresh"}
    for r in roots:
        mine = [s for s in refreshes if s.request == r.id]
        assert len(mine) == by_request[r.id][REFRESH][None] >= 1
        assert all(s.wall_s > 0 for s in mine)


def test_refresh_at_step_zero_and_after_it(solved):
    """The refresh protocol as spans: step 0 refreshes inside its
    ``coefficients``, and σ's refresh follows at request level."""
    _, _, spans, roots, _, _ = solved
    for r in roots:
        paths = [s.path for s in spans if s.request == r.id
                 and s.name == "bj_refresh"]
        assert paths[:2] == [
            "fused_local.device_step.coefficients.bj_refresh", "bj_refresh"]


def test_k2_calls_keyed_by_shape(solved):
    """K2's plain version ran at (2, N, 80, 1), N = 437 padded to 512, three
    times a device step (``timing.total`` sums over the keys), and the
    kernel never launched."""
    L, _, _, roots, counted, by_request = solved
    shape = (2, L._fused_solver[1].N, GMRES_M, GMRES_CYCLES)
    assert shape == (2, 512, 80, 1)
    assert counted["dense_gmres.launches"] == {}
    steps = sum(r.attrs["device_steps"] for r in roots)
    assert counted["dense_gmres.twin_calls"] == {shape: 3 * steps}
    assert counted["total"] == 3 * steps
    for r in roots:
        assert by_request[r.id]["dense_gmres.twin_calls"] == {
            shape: 3 * r.attrs["device_steps"]}


@pytest.mark.parametrize("engine", ["dense", "slab"])
@pytest.mark.parametrize("maxiter", [1, 2, 3])
def test_last_iteration_is_left_to_the_polish(engine, maxiter):
    """A device loop that does not land within ``maxiter`` (5 steps from
    340·2π here) leaves the last iteration to one complex128 polish step,
    so the request shows both phases (ROADMAP.md Queue 3, F9); with
    ``maxiter`` 1 the one iteration is a device step.  Either way the
    request ends at flag 1 (ITSOL_MAXITER) within ``maxiter`` iterations,
    as when the device loop took them all."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
        FusedSlabPencilSolver
    from wavesandeigenvalues_jl_tpu_torch.nlevp.solvers import ITSOL_MAXITER
    L = active_rijke_family()
    if engine == "slab":
        L._fused_solver = (L._stack(), FusedSlabPencilSolver(L, "cpu"))
    timing.reset()
    _, n_it, flag = mslp(L, Z0, maxiter=maxiter, tol=1e-11, device="cpu")
    root, = [s for s in timing.spans() if s.id == s.request]
    timing.reset()
    assert root.attrs["engine"] == type(L._fused_solver[1]).__name__
    assert flag == ITSOL_MAXITER and max(maxiter - 1, 1) <= n_it <= maxiter
    assert root.attrs["device_steps"] == max(maxiter - 1, 1)
    assert root.attrs["polish_steps"] == (maxiter > 1)
