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
* the block-Thomas factorization (:func:`block_thomas_factor`): m
  dependent steps a side on [s, s] complex64, each an LU with partial
  pivoting and its refined inverse, which produce the per-slab inverses
  Dt_i⁻¹ and the coupling stream Wᵀ_i = (Dt_i⁻¹L_i)ᵀ, Cᵀ_i = (Dt_i⁻¹U_i)ᵀ;
* every inner solve is Dt⁻¹b followed by ONE launch of the block-Thomas
  kernel (:func:`..ops.slab_thomas.slab_thomas`, kernel K3).

The first three run from the solve data to the stream without a host
sync, into static buffers.  On a card they are one CUDA graph, captured
at the solver's first step and replayed at every step after (the m steps
are a few thousand small launches, which the host would otherwise issue
one by one), with the two sides' recursions on two streams; on the CPU
the same function runs eagerly.  The LU infos stay on the device until
the step's one check after the factor.  Counter ``fused_slab.factor``:
key ``"capture"`` once a solver on a card, ``"replay"`` each step there,
``"eager"`` each step on the CPU.

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
from ..utils.config import DEVICE_CDTYPE, TORCH_CDTYPE
from ..utils.timing import count
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

        # the factor's static buffers: its input, the band panels (zero
        # off the fixed destinations) and its outputs
        dev = self.device
        self._g = torch.zeros(2, len(self.pattern[0][0]), dtype=TORCH_CDTYPE,
                              device=dev)
        self._blk = torch.zeros(2, m, 3, s, s, dtype=DEVICE_CDTYPE,
                                device=dev)
        self._DT = torch.empty(2, m, s, s, dtype=DEVICE_CDTYPE, device=dev)
        self._stream = torch.empty(2, 2 * m, s, s, dtype=DEVICE_CDTYPE,
                                   device=dev)
        self._scale32 = torch.empty(2, n, dtype=torch.float32, device=dev)
        self._info = torch.zeros(2, m, dtype=torch.int32, device=dev)
        #: on a card, a stream a side: the two recursions are independent,
        #: and each is a chain of launches too small to fill the card
        self._sides = (tuple(torch.cuda.Stream(dev) for _ in range(2))
                       if dev.type == "cuda" else None)
        #: the factor's CUDA graph, captured at the first step on a card
        self._graph = None

    def _fill(self):
        """From the solve data in ``_g``: per-side row equilibration in
        complex128 before the cast, the scatter into the band panels and
        each side's factorization (on a card, on the side's own stream),
        into the static buffers.  No host sync."""
        g = self._g
        rm = self._ell(_pad0(g.abs())).amax(-1)            # [2, n]
        scale = 1.0 / torch.where(rm == 0, 1.0, rm)
        gs = (g * scale.gather(1, self.rows2)).to(DEVICE_CDTYPE)
        self._blk.view(-1).index_put_((self.dest2.view(-1),), gs.view(-1))
        self._scale32.copy_(scale)
        cur = torch.cuda.current_stream(self.device) if self._sides else None
        for side, st in enumerate(self._sides or (None, None)):
            if st is not None:
                st.wait_stream(cur)
            with torch.cuda.stream(st):                # None: no-op
                block_thomas_factor(self._blk[side], self.pad,
                                    self._DT[side], self._stream[side],
                                    self._info[side])
        for st in self._sides or ():
            cur.wait_stream(st)

    def _capture(self) -> torch.cuda.CUDAGraph:
        """The CUDA graph of :meth:`_fill`, after one eager pass on a side
        stream that sets up the libraries' handles and workspaces."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._fill()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._fill()
        return graph

    def _factor(self, g: torch.Tensor):
        """Factor both sides' solve data g [2, nnz]: the inverses DT
        [2, m, s, s], K3's stream [2, 2m, s, s] and the float32 row
        scales [2, n], static buffers that the next step overwrites.
        Raises ``torch.linalg.LinAlgError`` where a Dt_i is singular."""
        self._g.copy_(g)
        if self.device.type == "cuda":
            if self._graph is None:
                self._graph = self._capture()
                count("fused_slab.factor", key="capture")
            self._graph.replay()
            count("fused_slab.factor", key="replay")
        else:
            self._fill()
            count("fused_slab.factor", key="eager")
        if self._info.any():
            side, i = (int(k) for k in self._info.nonzero()[0])
            raise torch.linalg.LinAlgError(
                f"slab factor: Dt of slab {i} (side {side}) is singular")
        return self._DT, self._stream, self._scale32

    def solver(self, g: torch.Tensor):
        """Row-equilibrate, scatter and factor g; each solve of both sides
        is Dt⁻¹b and one K3 launch."""
        m, s = self.m, self.s
        DT, stream, scale32 = self._factor(g)

        def solve_both(b):
            """Both sides' complex64 [2, n] UNSCALED rhs -> solutions (row
            scaling does not change x); one K3 launch."""
            slab = _pad0(b * scale32)[:, self.rmap]        # [2, m, s]
            bt = (DT @ slab.unsqueeze(-1)).squeeze(-1)     # Dt⁻¹ b
            x = slab_thomas(stream, bt)
            return x.reshape(2, m * s)[:, self.src]

        return solve_both


def block_thomas_factor(blk, pad, DT, stream, info):
    """Block-Thomas factorization of one side's band panels blk
    [m, 3, s, s] (L_i, D_i, U_i of each slab; ``pad`` [m, s] marks the
    padded rows): writes the per-slab inverses Dt_i⁻¹ into DT [m, s, s],
    K3's stream into ``stream`` [2m, s, s] (Wᵀ in forward order, then Cᵀ
    reversed) and each Dt_i's LU info into ``info`` [m] (nonzero:
    singular).

    Each Dt_i is inverted by an LU with partial pivoting, two triangular
    solves against the identity and one refinement step
    X ← X + X(I − Dt_i X) with its residual formed in complex128.  On a
    card the first two are cuSOLVER's getrf and cuBLAS's trsm, which
    neither synchronise the host nor allocate outside PyTorch's caching
    allocator, so a CUDA graph can hold the recursion (the batched
    ``torch.linalg.solve`` it replaced went to MAGMA, which does both).
    At (2, 59, 256) on an H100 the unrefined inverse leaves the recursion
    3× farther from its complex128 result than that solve did, the
    refined one 50× nearer (a residual formed in complex64 only 10×)."""
    m, s = blk.shape[0], blk.shape[-1]
    eye = torch.eye(s, dtype=blk.dtype, device=blk.device)
    eye128 = torch.eye(s, dtype=TORCH_CDTYPE, device=blk.device)
    C = blk.new_zeros(s, s)
    for i in range(m):
        Lb, Db, Ub = blk[i]
        # padded rows/cols of the slab get a unit diagonal
        Dt = Db - Lb @ C + torch.diag(pad[i])
        LU, piv, info[i] = torch.linalg.lu_factor_ex(Dt)
        X = torch.linalg.lu_solve(LU, piv, eye)
        E = eye128 - Dt.to(TORCH_CDTYPE) @ X.to(TORCH_CDTYPE)
        Dtinv = torch.addmm(X, X, E.to(blk.dtype), out=DT[i])
        C = Dtinv @ Ub
        stream[i] = (Dtinv @ Lb).T
        stream[2 * m - 1 - i] = C.T


__all__ = ["FusedSlabPencilSolver", "SLAB_FUSED_MAX_STREAM",
           "block_thomas_factor"]
