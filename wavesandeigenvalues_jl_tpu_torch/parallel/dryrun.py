"""Multi-rank dry run of the distributed layer.

The twin of the JAX package's ``__graft_entry__.dryrun_multichip``: one
full distributed solver step over an n-rank (shift × row) mesh —
per-shift coefficient assembly, the row-partitioned halo-exchange SpMV,
norms summed over the row axis, a mean over the shift axis — then the
composed row-sharded GMRES node solve against a serial host solve, then
the pod layout's per-axis sums.  The JAX package runs it on n virtual CPU
devices of one process; here it runs on n gloo processes
(:func:`.multihost.run_world`)::

    python -c "from wavesandeigenvalues_jl_tpu_torch.parallel.dryrun \\
        import dryrun_multichip; dryrun_multichip(4)"
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _flagship_family(n_rings=2, nz=6):
    """Small self-contained Rijke-tube Helmholtz family (no data files),
    the JAX package's ``__graft_entry__._flagship_family``."""
    from ..mesh.generate import rijke_mesh
    from ..models import discretize

    mesh = rijke_mesh(n_rings=n_rings, nz_cold=nz, nz_hot=nz)
    gamma, R, Tu, Tb, P0 = 1.4, 287.05, 300.0, 1200.0, 101325.0
    Q02U0 = P0 * (Tb / Tu - 1) * np.pi * 0.025 ** 2 * gamma / (gamma - 1)
    c = mesh.generate_field(
        lambda x, y, z: np.where(z < 0, np.sqrt(gamma * R * Tu),
                                 np.sqrt(gamma * R * Tb)))
    dscrp = {
        "Interior": ("interior", ()),
        "Outlet": ("admittance", ("Y", 1e15)),
        "Flame": ("flame", (gamma, 1.225, Q02U0, [0.0, 0.0, -0.0012],
                            [0.0, 0.0, 1.0], "n", "τ", 1.0, 1e-3)),
    }
    return discretize(mesh, dscrp, c)


def _dryrun_body() -> dict:
    """One rank of :func:`dryrun_multichip`; returns its checks."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..ops.linsolve import factorize
    from ..ops.slab_solve import family_coefficients
    from .dist_solve import dist_beyn_node_solve
    from .dist_spmv import halo_exchange, local_spmv
    from .mesh import all_reduce_sum, axis_rank, local_parts
    from .multihost import init_multihost, pod_spec_check
    from .partition import partition_stack

    n = dist.get_world_size()
    n_shift = 2 if n % 2 == 0 and n > 1 else 1
    n_row = n // n_shift
    mesh = init_device_mesh("cpu", (n_shift, n_row),
                            mesh_dim_names=("shift", "row"))
    L = _flagship_family(n_rings=1, nz=4)
    part = partition_stack(L._stack(), n_row)
    parts = local_parts(n_row, mesh, "row")
    vals = torch.from_numpy(part.values[:, parts.start:parts.stop]).to(
        torch.complex64)
    cols = torch.from_numpy(part.cols[parts.start:parts.stop].astype(
        np.int64))
    # this rank's shift: its frequency's family coefficients (host)
    omegas = 2 * np.pi * (np.linspace(200, 400, n_shift) + 5j)
    s = axis_rank(mesh, "shift")
    c = torch.from_numpy(family_coefficients(L, omegas[s:s + 1])[0]).to(
        torch.complex64)
    data = torch.tensordot(c, vals, dims=1)               # [q, m, w]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_shift, n_row, part.m)).astype(np.float32)
    x = torch.from_numpy(x[s, parts.start:parts.stop]).to(torch.complex64)
    y = local_spmv(data, cols, halo_exchange(x, part.halo, mesh, "row"))
    nrm = all_reduce_sum((y.abs() ** 2).sum(), mesh, "row").sqrt()
    y = y / (nrm + 1e-30)
    diag = all_reduce_sum(nrm.clone(), mesh, "shift") / n_shift
    assert bool(torch.isfinite(diag)) and bool(torch.isfinite(y).all())

    # the composed distributed node solve on the same mesh, against a
    # serial host solve of the first node
    d = L.size
    V = np.zeros((d, 2), np.complex128)
    V[0, 0] = V[1, 1] = 1.0
    zs = 2 * np.pi * (np.linspace(200, 400, n_shift) + 5j)
    X, res = dist_beyn_node_solve(
        L, zs, V, mesh, n_row_parts=n_row,
        shift_axis="shift" if n_shift > 1 else None,
        bs=16, tol=1e-8, restart=30, max_restarts=20)
    assert np.all(np.isfinite(X))
    Xd = factorize(L(complex(zs[0])), backend="host").solve(V)
    err = float(np.linalg.norm(X[0] - Xd) / np.linalg.norm(Xd))
    assert err < 1e-5, f"distributed Beyn node solve off by {err:.2e}"
    out = {"diag": float(diag), "node_solve_err": err,
           "multi": init_multihost()}
    if n >= 4 and n % 2 == 0:
        out["pod"] = pod_spec_check(n, n_host=2)
    return out


def dryrun_multichip(n_devices: int) -> list:
    """Run the dry run on ``n_devices`` gloo processes; returns each
    rank's checks (raises if a rank fails one)."""
    from .multihost import run_world
    return run_world(f"{__name__}:_dryrun_body", n_devices)


__all__ = ["dryrun_multichip"]
