"""Distributed SpMV / operator-family application over the row axis of a
device mesh.

Counterpart of the JAX package's ``parallel/dist_spmv.py``.  There the
row-partitioned ELL parts (:mod:`.partition`) are mapped over a mesh axis
with ``shard_map``, the halo rows come by ``ppermute`` shifts and dot
products reduce with ``psum``.  Here a rank holds its q parts as one
stacked tensor (:mod:`.mesh`): the halo rows of a part come from the
neighbouring parts of the same stack, and from the ranks within ⌈nh/q⌉
hops by one ``batch_isend_irecv``; a ``psum`` is the sum over the local
parts followed by an ``all_reduce`` over the row group when it has more
than one rank.  Plain PyTorch: the JAX layer is XLA, with no Pallas
kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import (all_gather_stack, all_reduce_sum, axis_rank, axis_size,
                   check_mesh, local_parts, mesh_device, torch_dtype)
from .partition import RowPartitionedEll


def halo_exchange(x_local: torch.Tensor, halo: int, mesh: DeviceMesh,
                  axis: str = "row") -> torch.Tensor:
    """Extend each of a rank's parts x_local [q, m, ...] to its window
    [q, H | m | H | 0-pad, ...] (trailing axes, e.g. a panel's columns,
    ride along).  A window reaches nh = ⌈H/m⌉ parts to each side: those
    in the local stack are read from it, those of other ranks come from
    the ranks within ⌈nh/q⌉ hops along ``axis`` in one
    ``batch_isend_irecv``; beyond the first and the last part the window
    is zero (an open boundary)."""
    q, m = x_local.shape[:2]
    trail = tuple(x_local.shape[2:])
    pad = x_local.new_zeros((q, 1) + trail)
    if halo == 0:
        return torch.cat([x_local, pad], 1)
    nh = -(-halo // m)
    left = x_local.new_zeros((nh, m) + trail)
    right = x_local.new_zeros((nh, m) + trail)
    size = axis_size(mesh, axis)
    if size > 1:
        group = mesh.get_group(axis)
        ranks = dist.get_process_group_ranks(group)
        me = axis_rank(mesh, axis)
        ops, recvs = [], []
        for d in range(1, -(-nh // q) + 1):
            cnt = min(q, nh - (d - 1) * q)
            for peer, send, side in ((me - d, x_local[:cnt], "left"),
                                     (me + d, x_local[q - cnt:], "right")):
                if not 0 <= peer < size:
                    continue
                buf = x_local.new_empty((cnt, m) + trail)
                ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                      ranks[peer], group))
                ops.append(dist.P2POp(dist.irecv, buf, ranks[peer], group))
                recvs.append((side, d, cnt, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for side, d, cnt, buf in recvs:
            if side == "left":      # the last cnt parts of rank me − d
                e0 = nh - (d - 1) * q - cnt
                left[e0:e0 + cnt] = buf
            else:                   # the first cnt parts of rank me + d
                right[(d - 1) * q:(d - 1) * q + cnt] = buf
    ext = torch.cat([left, x_local, right]).reshape(((q + 2 * nh) * m,)
                                                    + trail)
    W = m + 2 * halo
    start = (nh + torch.arange(q, device=x_local.device)) * m - halo
    idx = start[:, None] + torch.arange(W, device=x_local.device)[None]
    return torch.cat([ext[idx], pad], 1)


def local_spmv(vals: torch.Tensor, cols: torch.Tensor, x_ext: torch.Tensor):
    """Owned-rows ELL product of a rank's parts: vals, cols [q, m, w]
    against the windows x_ext [q, window + 1] → [q, m]."""
    parts = torch.arange(cols.shape[0], device=cols.device)[:, None, None]
    return (vals * x_ext[parts, cols]).sum(-1)


def local_spmm(vals: torch.Tensor, cols: torch.Tensor, X_ext: torch.Tensor):
    """Owned-rows ELL panel product: vals, cols [q, m, w], X_ext
    [q, window + 1, r] → [q, m, r], a part at a time (the gather
    X_ext[cols] is [m, w, r] for one part)."""
    return torch.stack([torch.einsum("mw,mwr->mr", v, X[c])
                        for v, c, X in zip(vals, cols, X_ext)])


class _LocalOperator:
    """A rank's parts of a partitioned family on its device: values
    [K, q, m, w] and cols [q, m, w]."""

    def __init__(self, part: RowPartitionedEll, mesh: DeviceMesh, axis: str,
                 dtype):
        check_mesh(mesh)
        self.part, self.mesh, self.axis = part, mesh, axis
        self.parts = local_parts(part.n_parts, mesh, axis)
        self.device = mesh_device(mesh)
        self.dtype = torch_dtype(dtype or part.values.dtype)
        sl = slice(self.parts.start, self.parts.stop)
        self.vals = torch.from_numpy(part.values[:, sl]).to(self.device,
                                                            self.dtype)
        self.cols = torch.from_numpy(
            part.cols[sl].astype(np.int64)).to(self.device)

    def data(self, coeffs):
        """[q, m, w] values of the family at ``coeffs`` (term 0 if None)."""
        if coeffs is None:
            return self.vals[0]
        c = torch.as_tensor(np.asarray(coeffs), device=self.device)
        return torch.tensordot(c.to(self.dtype), self.vals, dims=1)

    def gather_rows(self, y: torch.Tensor) -> np.ndarray:
        """[q, m, ...] local parts → host [n, ...] in the original order,
        on every rank of the axis."""
        full = all_gather_stack(y, self.mesh, self.axis)
        flat = full.reshape((-1,) + tuple(y.shape[2:]))[:self.part.n]
        flat = flat.cpu().numpy()
        out = np.empty_like(flat)
        out[self.part.perm] = flat
        return out

    def local_rows(self, x) -> torch.Tensor:
        """Host [n, ...] in the original order → this rank's [q, m, ...]."""
        x = np.asarray(x)
        xp = np.zeros((self.part.n_parts * self.part.m,) + x.shape[1:],
                      x.dtype)
        xp[:self.part.n] = x[self.part.perm]
        xp = xp.reshape((self.part.n_parts, self.part.m) + x.shape[1:])
        return torch.from_numpy(xp[self.parts.start:self.parts.stop]).to(
            self.device, self.dtype)


def make_dist_spmv(part: RowPartitionedEll, mesh: DeviceMesh,
                   axis: str = "row", dtype=None):
    """Distributed matvec y = A x over the row axis of ``mesh``.

    Returns (spmv, shard, unshard): ``spmv`` maps this rank's parts
    x [q, m] to y [q, m]; ``shard`` takes a host vector (original order)
    to this rank's parts on its device; ``unshard`` gathers y from every
    rank of the axis into a host vector in the original order.  For
    K-term families pass ``spmv(x, coeffs)``: the term contraction happens
    part-locally.  (The JAX package's arrays span all P parts; here each
    rank holds its own q, :mod:`.mesh`.)"""
    op = _LocalOperator(part, mesh, axis, dtype)

    def spmv(x, coeffs=None):
        x_ext = halo_exchange(x, part.halo, mesh, axis)
        return local_spmv(op.data(coeffs), op.cols, x_ext)

    return spmv, op.local_rows, op.gather_rows


def make_dist_spmm(part: RowPartitionedEll, mesh: DeviceMesh,
                   axis: str = "row", dtype=None):
    """Row-sharded multi-RHS SpMM Y = A X for X [n, r] panels: ONE halo
    exchange moves the whole panel, the local product is an einsum a part.
    Returns (spmm, shard, unshard) as :func:`make_dist_spmv`, on this
    rank's [q, m, r] panel parts.  ``spmm(X, coeffs)`` contracts a K-term
    family part-locally first."""
    op = _LocalOperator(part, mesh, axis, dtype)

    def spmm(X, coeffs=None):
        X_ext = halo_exchange(X, part.halo, mesh, axis)
        return local_spmm(op.data(coeffs), op.cols, X_ext)

    return spmm, op.local_rows, op.gather_rows


def dist_dot(x: torch.Tensor, y: torch.Tensor, mesh: DeviceMesh,
             axis: str = "row") -> torch.Tensor:
    """Global conjugated dot product of row-sharded vectors (this rank's
    parts of each); the same 0-d tensor on every rank."""
    return all_reduce_sum((x.conj() * y).sum(), check_mesh(mesh), axis)


__all__ = ["halo_exchange", "local_spmv", "local_spmm",
           "make_dist_spmv", "make_dist_spmm", "dist_dot"]
