"""Kernel K3 of the port (ops/slab_thomas.py) and the slab partition it
runs on, against the JAX package's Pallas kernel (interpret mode) and
``SlabPartition``."""
import numpy as np
import pytest
import torch

from wavesandeigenvalues_jl_tpu.ops.pallas_thomas import build_slab_thomas
from wavesandeigenvalues_jl_tpu.ops.slab_solve import \
    SlabPartition as SlabPartitionJax
from wavesandeigenvalues_jl_tpu_torch.models.rijke import active_rijke_family
from wavesandeigenvalues_jl_tpu_torch.ops.slab_solve import SlabPartition
from wavesandeigenvalues_jl_tpu_torch.ops.slab_thomas import (slab_thomas,
                                                               slab_thomas_ref)
from wavesandeigenvalues_jl_tpu_torch.utils import timing

from port_threads import one_thread  # noqa: F401

#: float32 sums taken in another order over a 2m-step recursion
RTOL = 1e-5


def _inputs(sides, m, s, seed=0):
    """Seeded complex64 stream [sides, 2m, s, s] and bt [sides, m, s]; the
    blocks are scaled to 0.5/s so the recursion stays bounded."""
    rng = np.random.default_rng(seed)
    shp = (sides, 2 * m, s, s)
    stream = ((rng.standard_normal(shp) + 1j * rng.standard_normal(shp))
              * (0.5 / s)).astype(np.complex64)
    bt = (rng.standard_normal((sides, m, s))
          + 1j * rng.standard_normal((sides, m, s))).astype(np.complex64)
    return stream, bt


def _max_rel(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("m,s", [(13, 128), (5, 256)])
def test_ref_matches_pallas_interpret(m, s):
    stream, bt = _inputs(2, m, s)
    solve = build_slab_thomas(m, s, sides=2, interpret=True)
    xr, xi = solve(np.ascontiguousarray(stream.real),
                   np.ascontiguousarray(stream.imag),
                   np.ascontiguousarray(bt.real)[:, :, None, :],
                   np.ascontiguousarray(bt.imag)[:, :, None, :])
    x_jax = (np.asarray(xr) + 1j * np.asarray(xi))[:, :, 0, :]
    x_ref = slab_thomas_ref(torch.from_numpy(stream),
                            torch.from_numpy(bt)).numpy()
    assert _max_rel(x_ref, x_jax) <= RTOL


def test_wrapper_takes_the_twin_on_cpu_only():
    stream, bt = _inputs(2, 3, 8, seed=1)
    st, b = torch.from_numpy(stream), torch.from_numpy(bt)
    calls = timing.total("slab_thomas.twin_calls")
    launches = timing.total("slab_thomas.launches")
    x = slab_thomas(st, b)
    assert timing.total("slab_thomas.twin_calls") == calls + 1
    assert timing.total("slab_thomas.launches") == launches
    assert torch.equal(x, slab_thomas_ref(st, b))
    with pytest.raises(TypeError):
        slab_thomas(st.to(torch.complex128), b.to(torch.complex128))
    with pytest.raises(ValueError):
        slab_thomas(st[:, :4], b)
    with pytest.raises(ValueError):
        slab_thomas(st.transpose(2, 3), b)
    with pytest.raises(ValueError):            # no kernel and no twin
        slab_thomas(st.to("meta"), b.to("meta"))


def test_slab_partition_identical():
    """Same BFS slabs on the union pattern of the active family (n = 437),
    which includes the flame's non-local coupling columns."""
    S = active_rijke_family()._stack()
    pj = SlabPartitionJax(S.indptr, S.indices, S.shape[0])
    pt = SlabPartition(S.indptr, S.indices, S.shape[0])
    assert (pt.m, pt.smax, pt.n) == (pj.m, pj.smax, pj.n) == (13, 44, 437)
    for attr in ("sizes", "perm", "iperm", "slab_of_new", "starts",
                 "loc_of_new"):
        np.testing.assert_array_equal(getattr(pt, attr), getattr(pj, attr))
    rows, cols = S.row_ids(), S.indices
    for a, b in zip(pt.entry_destinations(rows, cols),
                    pj.entry_destinations(rows, cols)):
        np.testing.assert_array_equal(a, b)

