"""What the two fused local engines share: one device Newton step on the
σ-regularised pencil, in PyTorch.

Per Newton step the host evaluates the family's coefficient vectors c(z),
∂_z c(z) in complex128 and the device runs :meth:`PencilSolver.forward`:

* complex128 assembly ``c @ vals`` of the operator and of its adjoint on
  the union pattern, plus the σ-regularisation σ·M;
* the engine's inner solver for both sides (:meth:`PencilSolver.solver`:
  the dense GMRES of :mod:`.fused_local` or the slab-direct solve of
  :mod:`.fused_slab`), built once per step from that data;
* two inverse-iteration steps, the second with complex128 residual
  refinement;
* two-sided complex128 Rayleigh quotients on the pure A, which give λ, λ′
  and the Newton update dz = −λ/λ′.

A step's phases (``utils.timing``, under the caller's): ``coefficients``
(host c(z), any preconditioner refresh, the upload), ``factor`` (the solve
data and the engine's solver, :meth:`PencilSolver.solver`), ``solves``
(the inner solves and the quotients) and ``fetch`` (the one device→host
copy, where the host first waits for the card).  ``factor`` and
``solves`` are device spans: on a card they also time the stream.

The TPU's float64-pair arithmetic of the JAX package is native complex128
here and its float32 planes are complex64.  Sparse products use a padded
ELL gather (deterministic, no atomics).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.config import CDTYPE, DEVICE_CDTYPE, TORCH_CDTYPE
from ..utils.timing import phase
from .family import AUX_OPERATOR, OperatorFamily

REFINE_SWEEPS = 1


def _ell_ids(rows_sorted, n: int, nnz: int):
    """Padded-ELL entry-id map [n, w] (sentinel = nnz) for per-row
    reductions over data laid out in row-sorted order."""
    counts = np.bincount(rows_sorted, minlength=n)
    w = max(int(counts.max()), 1)
    ids = np.full((n, w), nnz, np.int64)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(rows_sorted)) - starts[rows_sorted]
    ids[rows_sorted, slot] = np.arange(len(rows_sorted))
    return ids


def _pad0(d: torch.Tensor) -> torch.Tensor:
    """Append one zero along the last axis (the ELL sentinel slot)."""
    return torch.cat([d, d.new_zeros(d.shape[:-1] + (1,))], dim=-1)


class PencilSolver(nn.Module):
    """Device-resident Newton state for one family.  Index maps and value
    stacks are buffers, so ``.to(device)`` moves them; one Newton step is
    :meth:`forward`.  Subclasses provide :meth:`solver` and call
    ``self.to(device)`` once their own buffers are registered."""

    def __init__(self, L: OperatorFamily):
        super().__init__()
        L.ensure_aux()
        S = L._stack()
        self.L = L
        self.n = n = int(S.shape[0])
        self.eig, self.aux = L.eigval, L.auxval
        rows = np.asarray(S.row_ids(), np.int64)
        cols = np.asarray(S.indices, np.int64)
        nnz = len(cols)
        vals = np.asarray(S.values)                        # [K, nnz] c128
        self.K = vals.shape[0]
        self.k_aux = next(i for i, t in enumerate(L.terms)
                          if t.operator == AUX_OPERATOR)

        # adjoint pattern (Aᴴ): conj data on (cols, rows), row-sorted
        perm = np.lexsort((rows, cols))
        self.pattern = ((rows, cols), (cols[perm], rows[perm]))
        self._perm = perm
        self._vals_host = vals

        e = np.zeros(self.K, np.complex128)
        e[self.k_aux] = -1.0
        mdat = e @ vals                                    # M = -coeff_aux
        self._m_data = mdat

        # ELL maps: entry ids per row (sentinel nnz) and their columns
        ell = [_ell_ids(r_, n, nnz) for r_, _ in self.pattern]
        w = max(a.shape[1] for a in ell)
        ell2 = np.full((2, n, w), nnz, np.int64)
        for side, a in enumerate(ell):
            ell2[side, :, :a.shape[1]] = a
        cell2 = np.stack([np.append(c_, 0)[ell2[side]]
                          for side, (_, c_) in enumerate(self.pattern)])

        for name, arr in (("vals2", np.stack([vals, np.conj(vals[:, perm])])),
                          ("mdat2", np.stack([mdat, np.conj(mdat[perm])])),
                          ("rows2", np.stack([r_ for r_, _ in self.pattern])),
                          ("ell2", ell2), ("cell2", cell2)):
            self.register_buffer(name, torch.from_numpy(arr),
                                 persistent=False)

    @property
    def device(self) -> torch.device:
        return self.vals2.device

    # -- host-side per-step scalar work -----------------------------------
    def coefficients(self, z: complex):
        L = self.L
        L.params[self.eig] = z
        L.params[self.aux] = 0.0
        saved_mode = L.mode
        L.mode = "householder"
        try:
            c = L.coefficients({})
            dc = L.coefficients({self.eig: 1})
        finally:
            L.mode = saved_mode
        c[self.k_aux] = 0.0
        dc[self.k_aux] = 0.0
        return c, dc

    def refresh_bj(self, c: np.ndarray, sigma: complex):
        """Refresh the engine's preconditioner at (c, σ); engines without
        one ignore it."""

    @property
    def stale(self) -> bool:
        """True while the engine has no preconditioner to step with."""
        return False

    # -- device step ---------------------------------------------------------
    def _ell(self, data: torch.Tensor) -> torch.Tensor:
        """[2, nnz+1] per-side padded data -> [2, n, w] ELL gather."""
        return data.gather(1, self.ell2.view(2, -1)).view(self.ell2.shape)

    def _spmv(self, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Both sides' y = A x: data [2, nnz], x [2, n] -> [2, n]."""
        xg = x.gather(1, self.cell2.view(2, -1)).view(self.cell2.shape)
        return (self._ell(_pad0(data)) * xg).sum(-1)

    def _spmv0(self, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Direct side only: data [nnz], x [n] -> [n]."""
        return (_pad0(data)[self.ell2[0]] * x[self.cell2[0]]).sum(-1)

    def solve_data(self, c: torch.Tensor, sigma: torch.Tensor):
        """complex128 data of A [nnz] and both sides' solve data g [2, nnz]
        (A + σM and Aᴴ + σ̄Mᴴ) at coefficients c."""
        vals2, mdat2 = self.vals2, self.mdat2
        a = c @ vals2[0]
        g = torch.stack([a + sigma * mdat2[0],
                         c.conj() @ vals2[1] + sigma.conj() * mdat2[1]])
        return a, g

    def solver(self, g: torch.Tensor):
        """From both sides' complex128 solve data g [2, nnz] (A + σM and
        Aᴴ + σ̄Mᴴ), the engine's inner solve: a function that maps complex64
        [2, n] right-hand sides to complex64 [2, n] solutions."""
        raise NotImplementedError

    def forward(self, c, dc, sigma, carries):
        """One Newton step.  c, dc [K] complex128 coefficient vectors, sigma
        a complex128 scalar tensor, carries [2, n] complex64 (direct and
        adjoint vector).  Returns (scal [3] = (dz, λ, λ′) complex128,
        res [2] float64 refined relative residuals, carries [2, n])."""
        with phase("factor", device=self.device):
            a, g = self.solve_data(c, sigma)
            solve_both = self.solver(g)
        with phase("solves", device=self.device):
            return self._solves(a, g, solve_both, dc, carries)

    def _solves(self, a, g, solve_both, dc, carries):
        """The inner solves and the Rayleigh quotients of :meth:`forward`
        from A's data ``a``, the solve data ``g`` and the engine's solve."""
        vals2, mdat2 = self.vals2, self.mdat2
        mdat32 = mdat2.to(DEVICE_CDTYPE)

        def refined_inverse_step(v, sweeps):
            """One inverse-iteration step of both sides from complex64 v
            [2, n]; complex128 solution, refined ``sweeps`` times, and the
            relative residuals of the refined solution."""
            b = self._spmv(mdat32, v)
            x = solve_both(b).to(TORCH_CDTYPE)
            b = b.to(TORCH_CDTYPE)
            for _ in range(sweeps):
                r = (b - self._spmv(g, x)).to(DEVICE_CDTYPE)
                x = x + solve_both(r).to(TORCH_CDTYPE)
            r = b - self._spmv(g, x)
            num = (r.real ** 2 + r.imag ** 2).sum(-1)
            den = (b.real ** 2 + b.imag ** 2).sum(-1).clamp_min(1e-300)
            return x, torch.sqrt(num / den)

        def normalized(x):
            nrm = (x.real ** 2 + x.imag ** 2).sum(-1).sqrt()
            return x / nrm.clamp_min(1e-300)[:, None]

        # two inverse-iteration steps: a plain amplification step, then a
        # refined one feeding the Rayleigh quotients
        x, _ = refined_inverse_step(carries, sweeps=0)
        x, res = refined_inverse_step(normalized(x).to(DEVICE_CDTYPE),
                                      sweeps=REFINE_SWEEPS)
        x = normalized(x)
        v, w = x[0], x[1]

        # two-sided Rayleigh quotients on the PURE A (σ-independent)
        wc = w.conj()
        num = (wc * self._spmv0(a, v)).sum()               # wᴴ A v
        dnum = (wc * self._spmv0(dc @ vals2[0], v)).sum()  # wᴴ A′ v
        den = (wc * self._spmv0(mdat2[0], v)).sum()        # wᴴ M v
        lam = num / den
        lamd = dnum / den
        dz = -lam / lamd                     # Newton/[1/0]-Padé update
        return torch.stack([dz, lam, lamd]), res, x.to(DEVICE_CDTYPE)

    def step(self, z: complex, carries, sigma: complex,
             refresh: bool = False):
        """Host side of one Newton step: coefficients in (and the
        preconditioner refreshed at them when ``refresh``), ONE device
        fetch of (dz, λ, residuals) out."""
        dev = self.device
        with phase("coefficients"):
            c, dc = self.coefficients(z)
            if refresh or self.stale:
                self.refresh_bj(c, sigma)
            c, dc = torch.from_numpy(c).to(dev), torch.from_numpy(dc).to(dev)
            sig = torch.tensor(complex(sigma), dtype=TORCH_CDTYPE, device=dev)
        scal, res, carries = self(c, dc, sig, carries)
        with phase("fetch"):
            out = torch.cat([scal, res.to(TORCH_CDTYPE)]).cpu().numpy()
        return complex(out[0]), complex(out[1]), carries, out[3:].real

    def fetch_vectors(self, carries):
        x = carries.cpu().numpy().astype(CDTYPE)
        return x[0], x[1]


__all__ = ["PencilSolver", "REFINE_SWEEPS"]
