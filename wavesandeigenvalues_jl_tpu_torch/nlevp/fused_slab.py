"""Fused-device local NLEVP solver — the slab (block-tridiagonal) DIRECT
variant, in PyTorch.

Counterpart of the JAX package's ``nlevp/fused_slab.py``, for families
above ``FUSED_MAX_DIM`` (:mod:`.fused_local`).  The Newton step is
:class:`.pencil.PencilSolver`'s; this engine's inner solve
(:meth:`FusedSlabPencilSolver.solver`) is:

* complex128 row equilibration per side (ELL gather + row max) BEFORE any
  cast to complex64 — the Y≈1e15 penalty rows otherwise destroy the
  float32 factorization;
* the scatter into band panels [2, m, 3, s, s] (destinations are unique
  per entry, so ``index_put_`` without accumulation is exact);
* the block-Thomas factorization as a Python loop of m batched
  ``torch.linalg.solve`` / matmul steps on [2, s, s] complex64, which
  produces the per-slab inverses Dt_i⁻¹ and the coupling stream
  Wᵀ_i = (Dt_i⁻¹L_i)ᵀ, Cᵀ_i = (Dt_i⁻¹U_i)ᵀ;
* every inner solve is Dt⁻¹b followed by ONE launch of the block-Thomas
  kernel (:func:`..ops.slab_thomas.slab_thomas`, kernel K3).

The precision split is the JAX package's: complex64 factorization and
stream, complex128 refinement and quotients.

Reference counterpart: Householder.jl:70-192 — ARPACK shift-invert over
one UMFPACK factorization per outer iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.slab_solve import SlabPartition
from ..ops.slab_thomas import slab_thomas
from ..utils.config import DEVICE_CDTYPE
from .family import OperatorFamily
from .pencil import PencilSolver, _pad0

#: cap on the streamed W/C blocks (device bytes, both sides): the
#: factorization and the stream must coexist with the family stacks
SLAB_FUSED_MAX_STREAM = 4.0e9

class FusedSlabPencilSolver(PencilSolver):
    """Slab-direct Newton state for one family (see the module
    docstring)."""

    def __init__(self, L: OperatorFamily, device):
        super().__init__(L)
        n = self.n
        S = L._stack()
        part = SlabPartition(S.indptr, S.indices, n)
        self.part = part
        m = part.m
        s = ((part.smax + 127) // 128) * 128
        self.m, self.s = m, s
        stream_bytes = 2 * 2 * m * s * s * 8
        if stream_bytes > SLAB_FUSED_MAX_STREAM:
            raise ValueError(
                f"slab stream {stream_bytes / 1e9:.1f} GB above "
                f"SLAB_FUSED_MAX_STREAM for n={n}")

        # per-side flat destinations in the [2, m, 3, s, s] band panels
        dest = []
        for side, (r_, c_) in enumerate(self.pattern):
            si, d, rl, cl = part.entry_destinations(r_, c_)
            dest.append(((((side * m + si) * 3 + d) * s + rl) * s + cl))

        # slab row map (sentinel n gathers the appended zero) and its
        # inverse gather
        rmap = np.full((m, s), n, np.int64)
        for i in range(m):
            rows_i = part.perm[part.starts[i]:part.starts[i + 1]]
            rmap[i, :len(rows_i)] = rows_i
        newidx = part.iperm
        src = part.slab_of_new[newidx] * s + part.loc_of_new[newidx]
        pad = (np.arange(s)[None, :] >= part.sizes[:, None])

        for name, arr in (("dest2", np.stack(dest)), ("rmap", rmap),
                          ("src", src), ("pad", pad.astype(np.complex64))):
            self.register_buffer(name, torch.from_numpy(arr),
                                 persistent=False)
        self.to(device)

    def _factor(self, blk: torch.Tensor):
        """Block-Thomas factorization of the [2, m, 3, s, s] band panels:
        per-slab inverses DT [2, m, s, s] and the K3 stream [2, 2m, s, s]
        (Wᵀ in forward order, then Cᵀ reversed)."""
        m, s = self.m, self.s
        eye = torch.eye(s, dtype=blk.dtype, device=blk.device).expand(2, s, s)
        DT = blk.new_empty(2, m, s, s)
        stream = blk.new_empty(2, 2 * m, s, s)
        C = blk.new_zeros(2, s, s)
        for i in range(m):
            Lb, Db, Ub = blk[:, i, 0], blk[:, i, 1], blk[:, i, 2]
            # padded rows/cols of the slab get a unit diagonal
            Dt = Db - Lb @ C + torch.diag(self.pad[i])
            Dtinv = torch.linalg.solve(Dt, eye)
            C = Dtinv @ Ub
            DT[:, i] = Dtinv
            stream[:, i] = (Dtinv @ Lb).transpose(1, 2)
            stream[:, 2 * m - 1 - i] = C.transpose(1, 2)
        return DT, stream

    def solver(self, g: torch.Tensor):
        """Row-equilibrate, scatter and factor g; each solve of both sides
        is Dt⁻¹b and one K3 launch."""
        m, s = self.m, self.s
        # per-side row equilibration in complex128, before the cast
        rm = self._ell(_pad0(g.abs())).amax(-1)            # [2, n]
        scale = 1.0 / torch.where(rm == 0, 1.0, rm)
        gs = (g * scale.gather(1, self.rows2)).to(DEVICE_CDTYPE)
        blk = gs.new_zeros(2 * m * 3 * s * s)
        blk.index_put_((self.dest2.view(-1),), gs.view(-1))
        DT, stream = self._factor(blk.view(2, m, 3, s, s))
        scale32 = scale.to(torch.float32)

        def solve_both(b):
            """Both sides' complex64 [2, n] UNSCALED rhs -> solutions (row
            scaling does not change x); one K3 launch."""
            slab = _pad0(b * scale32)[:, self.rmap]        # [2, m, s]
            bt = (DT @ slab.unsqueeze(-1)).squeeze(-1)     # Dt⁻¹ b
            x = slab_thomas(stream, bt)
            return x.reshape(2, m * s)[:, self.src]

        return solve_both


__all__ = ["FusedSlabPencilSolver", "SLAB_FUSED_MAX_STREAM"]
