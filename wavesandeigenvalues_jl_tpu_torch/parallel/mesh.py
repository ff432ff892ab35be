"""The device mesh of the distributed layer, and the row parts a rank holds.

The counterpart of the JAX package's ``jax.sharding.Mesh`` is
torch.distributed's :class:`~torch.distributed.device_mesh.DeviceMesh`,
with the JAX package's axis names: ``"row"`` (the row parts of an
operator), ``"shift"`` (independent quadrature shifts) and ``"host"`` (the
pod mesh, :func:`.multihost.pod_mesh`).  ``mesh.get_group(axis)`` is the
process group of an axis; every collective of the layer goes through one.

How row parts map to ranks.  In the JAX package's ``shard_map`` bodies
each device holds one row part.  Here the P row parts of a
:class:`.partition.RowPartitionedEll` are laid contiguously over the r
ranks of the row axis: rank k owns parts [k·q, (k+1)·q), q = P / r, held
as one stacked tensor [q, m, ...] on its device.  With q = 1 this is the
JAX layout exactly; with q > 1 one rank holds several parts and the halos
between them are real (:func:`.dist_spmv.halo_exchange` takes them from
the local stack), which is how a single card runs the layer.  It is a
mapping of the row axis onto ranks, not another result: the parts, their
halos and every sum are the same.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself; TypeError unless it is a DeviceMesh."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def _dim(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along ``axis``."""
    return mesh.size(_dim(mesh, axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    _dim(mesh, axis)
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: its current CUDA device on
    a "cuda" mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_parts(n_parts: int, mesh: DeviceMesh, axis: str = "row") -> range:
    """The row parts this rank owns: [k·q, (k+1)·q) for its coordinate k
    along ``axis``, q = n_parts / (ranks along ``axis``).  ValueError when
    n_parts is not a multiple of the axis size."""
    size = axis_size(mesh, axis)
    if n_parts % size:
        raise ValueError(f"{n_parts} row parts cannot be laid evenly over "
                         f"the {size} ranks of mesh axis {axis!r}")
    q = n_parts // size
    k = axis_rank(mesh, axis)
    return range(k * q, (k + 1) * q)


def all_reduce_sum(t: torch.Tensor, mesh: DeviceMesh, axis: str
                   ) -> torch.Tensor:
    """``t`` summed over the ranks of ``axis`` (in place; a no-op on an
    axis of one rank).  Complex tensors go as they are."""
    if axis_size(mesh, axis) > 1:
        dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def all_gather_stack(t: torch.Tensor, mesh: DeviceMesh, axis: str
                     ) -> torch.Tensor:
    """[size, *t.shape]: ``t`` of every rank along ``axis``, in coordinate
    order (``t[None]`` on an axis of one rank)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return t[None]
    t = t.contiguous()
    flat = torch.view_as_real(t) if t.is_complex() else t
    out = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(out, flat, group=mesh.get_group(axis))
    out = torch.stack(out)
    return torch.view_as_complex(out) if t.is_complex() else out


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np
    return torch.from_numpy(np.zeros(0, dtype)).dtype


__all__ = ["check_mesh", "axis_size", "axis_rank", "mesh_device",
           "local_parts", "all_reduce_sum", "all_gather_stack",
           "torch_dtype"]
