"""Device-batched Bloch wavenumber sweep, in PyTorch.

Counterpart of the JAX package's ``nlevp/bloch_sweep.py``.  The
reference's tutorial-07 computes the azimuthal mode family by re-running
the local solver once per Bloch wavenumber b = 0..DOS−1
(docs/src/tutorial_07_Bloch_periodicity.md:119-130) — DOS serial
eigensolves.  On the union sparsity pattern a change of b is ONLY a
coefficient change (the exp(±ibΔϕ)/δ(b) factors of the blochified terms,
:mod:`..fem.bloch`), so the whole family solves as ONE batched device
iteration:

* per Newton step, the host evaluates the K coefficient values for every
  (z_b, b) pair exactly in complex128 — B·K scalars;
* the device (:class:`SweepStep`) assembles all B operators from the
  shared value stack, LU-factorizes them as one batched complex64
  ``torch.linalg.lu_factor`` on [B, N, N] (N = n padded to a multiple of
  128 with an identity pad), and runs one batched inverse-iteration +
  two-sided Rayleigh-quotient step;
* per-b Newton updates and convergence bookkeeping stay on the host;
* a warm-started complex128 polish pass supplies the final digits per b
  (:func:`.polish.polish_step`, the step of :mod:`.fused_local`: L(z)
  factored on ``device`` up to ``POLISH_DEVICE_MAX_DIM``).

The precision split is the JAX package's: complex64 LU and carries.  The
three Rayleigh sparse products are native complex128 where the JAX
package uses float64 pairs (a TPU workaround).  Sparse products are
padded-ELL gathers, as in :mod:`.pencil`.  There is no hand-written
kernel: the JAX step is plain XLA.

Where the port differs on purpose: ``device=`` (the card by default); the
JAX package's ``except Exception`` around the host Arnoldi seed and the
host polish is narrowed to ``(RuntimeError, np.linalg.LinAlgError)``, so
that a device, build or launch fault propagates; ``L.active``, ``L.mode``
and ``b`` are restored after an exception too.  On CPU tensors each b is
factored and solved on its own: torch's batched CPU LU with two or more
intra-op threads corrupts its pivots (see :mod:`..parallel.dist_beyn`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils.config import CDTYPE, DEVICE_CDTYPE, TORCH_CDTYPE
from ..utils.timing import phase
from .family import AUX_OPERATOR, OperatorFamily, Solution
from .pencil import _ell_ids, _pad0
from .polish import polish_step

#: the padded-N granularity of the batched LU
PAD = 128


class SweepStep:
    """Device state of the sweep for one family on ``device``: the value
    stack, the pencil weight M, the dense scatter map and the ELL maps of
    M, Mᴴ and the union pattern.  :meth:`step` is one batched Newton
    step."""

    def __init__(self, L: OperatorFamily, device):
        L.ensure_aux()
        S = L._stack()
        self.n = n = int(S.shape[0])
        self.N = N = ((n + PAD - 1) // PAD) * PAD
        self.device = dev = torch.device(device)
        rows = np.asarray(S.row_ids(), np.int64)
        cols = np.asarray(S.indices, np.int64)
        vals = np.asarray(S.values)                        # [K, nnz] c128
        self.K, nnz = vals.shape
        self.k_aux = next(i for i, t in enumerate(L.terms)
                          if t.operator == AUX_OPERATOR)
        e = np.zeros(self.K, np.complex128)
        e[self.k_aux] = -1.0
        mdat = e @ vals                                    # M = -coeff_aux
        perm = np.lexsort((rows, cols))                    # Mᴴ, row-sorted
        ell = _ell_ids(rows, n, nnz)
        ellT = _ell_ids(cols[perm], n, nnz)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        self.vals = t(vals)
        self.mdat = t(mdat)
        self.mdatT = t(np.conj(mdat[perm]))
        self.dest = t(rows * N + cols)
        self.pad_diag = t(np.arange(n, N) * (N + 1))
        self.ell, self.cell = t(ell), t(np.append(cols, 0)[ell])
        self.ellT, self.cellT = t(ellT), t(np.append(rows[perm], 0)[ellT])

    @staticmethod
    def _spmv(data, ell, cell, x):
        """y = A x for B vectors: data [B or 1, nnz], x [B, n] -> [B, n]."""
        return (_pad0(data)[:, ell] * x[:, cell]).sum(-1)

    def operators(self, c: torch.Tensor) -> torch.Tensor:
        """complex128 coefficients c [B, K] -> the complex64 dense
        operators [B, N, N], the padding an identity."""
        B, N = c.shape[0], self.N
        A = torch.zeros(B, N * N, dtype=DEVICE_CDTYPE, device=self.device)
        A[:, self.dest] = (c @ self.vals).to(DEVICE_CDTYPE)
        A[:, self.pad_diag] = 1
        return A.view(B, N, N)

    def factor(self, A: torch.Tensor):
        """Batched LU of [B, N, N]: one call on the card, one per b on the
        CPU."""
        if A.device.type == "cuda":
            return torch.linalg.lu_factor(A)
        lu = [torch.linalg.lu_factor(a) for a in A]
        return (torch.stack([f[0] for f in lu]),
                torch.stack([f[1] for f in lu]))

    def _solve(self, fac, b: torch.Tensor, adjoint: bool) -> torch.Tensor:
        LU, piv = fac
        bp = b.new_zeros(b.shape[0], self.N, 1)
        bp[:, :self.n, 0] = b
        if LU.device.type == "cuda":
            x = torch.linalg.lu_solve(LU, piv, bp, adjoint=adjoint)
        else:
            x = torch.stack([torch.linalg.lu_solve(l_, p_, b_, adjoint=adjoint)
                             for l_, p_, b_ in zip(LU, piv, bp)])
        return x[:, :self.n, 0]

    def step(self, c, dc, v, w):
        """One batched Newton step.  c, dc [B, K] complex128 coefficients
        of L(z_b) and ∂_z L(z_b) at aux = 0; v, w [B, n] complex64
        carries.  Returns (dz, λ, λ′) [3, B] complex128 and the new
        carries."""
        fac = self.factor(self.operators(c))
        m32 = self.mdat[None].to(DEVICE_CDTYPE)
        mT32 = self.mdatT[None].to(DEVICE_CDTYPE)

        def inv_step(x, adjoint):
            b = (self._spmv(mT32, self.ellT, self.cellT, x) if adjoint
                 else self._spmv(m32, self.ell, self.cell, x))
            y = self._solve(fac, b, adjoint)
            nrm = (y.real ** 2 + y.imag ** 2).sum(-1, keepdim=True).sqrt()
            return y / nrm.clamp_min(1e-30)

        for _ in range(2):                        # two amplification steps
            v = inv_step(v, False)
            w = inv_step(w, True)

        # complex128 two-sided Rayleigh quotients
        v64, wc = v.to(TORCH_CDTYPE), w.to(TORCH_CDTYPE).conj()
        a = c @ self.vals
        ap = dc @ self.vals
        num = (wc * self._spmv(a, self.ell, self.cell, v64)).sum(-1)
        dnum = (wc * self._spmv(ap, self.ell, self.cell, v64)).sum(-1)
        den = (wc * self._spmv(self.mdat[None], self.ell, self.cell,
                               v64)).sum(-1)
        lam = num / den
        lamd = dnum / den
        return torch.stack([-lam / lamd, lam, lamd]), v, w


def sweep_coefficients(L: OperatorFamily, zs, b_values, b_param: str,
                       k_aux: int):
    """complex128 coefficients [B, K] of L(z_b) and ∂_z L(z_b) at aux = 0
    for each (z_b, b), evaluated on the host in "householder" mode."""
    eig, aux = L.eigval, L.auxval
    K = len(L.terms)
    c = np.empty((len(b_values), K), np.complex128)
    dc = np.empty((len(b_values), K), np.complex128)
    saved_mode, L.mode = L.mode, "householder"
    try:
        for i, (z, b) in enumerate(zip(zs, b_values)):
            L.params[eig] = complex(z)
            L.params[aux] = 0.0
            L.params[b_param] = b
            c[i] = L.coefficients({})
            dc[i] = L.coefficients({eig: 1})
    finally:
        L.mode = saved_mode
    c[:, k_aux] = 0.0
    dc[:, k_aux] = 0.0
    return c, dc


def bloch_mode_sweep(L: OperatorFamily, z0, b_values: Sequence[float],
                     b_param: str = "b", tol: float = 1e-10,
                     maxiter: int = 30, scale: float = 1.0,
                     polish: bool = True, output: bool = False, *,
                     device="cuda"):
    """Solve the local eigenproblem for EVERY Bloch wavenumber in one
    batched device iteration on ``device`` (tutorial-07's b-sweep).

    Returns a list of (Solution, n_iters, flag) per b, matching per-b
    ``mslp(L, z0, ...)`` results.  ``z0`` may be a scalar (same start for
    every b) or a per-b sequence.  A scalar start seeds every b from its
    smallest-|λ| branch at z0, which need not be the branch per-b ``mslp``
    follows from the same z0 (ROADMAP.md Queue 3, F5)."""
    from ..ops.linsolve import factorize
    from .eigs import eigs_shift_invert
    from .solvers import (ITSOL_CONVERGED, ITSOL_IMPOSSIBLE, ITSOL_ISNAN,
                          ITSOL_MAXITER)

    L.ensure_aux()
    eig, aux = L.eigval, L.auxval
    Bn = len(b_values)
    zs = np.full(Bn, complex(z0) * scale, np.complex128) \
        if np.isscalar(z0) else np.asarray(z0, np.complex128) * scale
    zs = zs.copy()
    tol_s = tol * abs(scale) if scale != 1 else tol
    saved_active, saved_mode = list(L.active), L.mode
    saved_b = L.params.get(b_param)
    try:
        with phase("bloch_sweep.setup"):
            st = SweepStep(L, device)
        n, k_aux = st.n, st.k_aux

        # branch selection: plain inverse iteration converges to whichever
        # mode the start vector leans toward; one small host Arnoldi per b
        # at z0 (a one-time cost) seeds the smallest-|λ| branch — the same
        # branch mslp's inner eigensolver locks onto.  Where the host
        # numerics refuse, the ones start stays.
        v0 = np.ones((Bn, n), np.complex128)
        w0 = np.ones((Bn, n), np.complex128)
        try:
            with phase("bloch_sweep.seed"):
                for i, b in enumerate(b_values):
                    L.params[eig] = complex(zs[i])
                    L.params[aux] = 0.0
                    L.params[b_param] = b
                    A0 = L(complex(zs[i]))
                    M0 = L.aux_weight()
                    F0 = factorize(A0, check=True, backend="host")
                    _, Vs = eigs_shift_invert(A0, M0, nev=1, m=12, factor=F0)
                    _, Ws = eigs_shift_invert(A0, M0, nev=1, m=12, factor=F0,
                                              adjoint=True)
                    v0[i] = Vs[:, 0]
                    w0[i] = Ws[:, 0]
        except (RuntimeError, np.linalg.LinAlgError):
            pass
        v = torch.from_numpy(v0).to(st.device, DEVICE_CDTYPE)
        w = torch.from_numpy(w0).to(st.device, DEVICE_CDTYPE)

        def coefficients(zb):
            c, dc = sweep_coefficients(L, zb, b_values, b_param, k_aux)
            return (torch.from_numpy(c).to(st.device),
                    torch.from_numpy(dc).to(st.device))

        active = np.ones(Bn, bool)
        nan_dz = np.zeros(Bn, bool)
        iters = np.zeros(Bn, int)
        lam = np.full(Bn, np.inf, np.complex128)
        dz_floor = np.maximum(tol_s, 1e-9 * np.maximum(np.abs(zs), 1.0))
        it = 0
        while active.any() and it < maxiter:
            with phase("bloch_sweep.device_step"):
                c, dc = coefficients(zs)
                scal, v, w = st.step(c, dc, v, w)
                scal = scal.cpu().numpy()
            dz, lam = scal[0], scal[1]
            upd = active & np.isfinite(dz)
            nan_dz |= active & ~np.isfinite(dz)   # non-finite update
            zs[upd] = zs[upd] + dz[upd]
            iters[upd] += 1
            active &= np.abs(dz) > np.maximum(dz_floor, 1e-5 * np.abs(zs))
            if output:
                print(f"bloch sweep it{it}: active {int(active.sum())}/{Bn} "
                      f"max|dz| {np.abs(dz[np.isfinite(dz)]).max():.2e}")
            it += 1

        V = v.cpu().numpy().astype(CDTYPE)
        W = w.cpu().numpy().astype(CDTYPE)

        results = []
        for i, b in enumerate(b_values):
            z = complex(zs[i])
            vi, wi = V[i], W[i]
            flag = ITSOL_CONVERGED if iters[i] < maxiter else ITSOL_MAXITER
            if nan_dz[i]:
                # a wavenumber whose Newton update went non-finite was
                # deactivated without converging — not reported as
                # converged (the polish below may still rescue it)
                flag = (ITSOL_ISNAN if not np.isfinite(zs[i])
                        else ITSOL_IMPOSSIBLE)
            L.params[b_param] = b
            if polish:
                try:
                    for _ in range(3):
                        with phase("bloch_sweep.polish_step"):
                            dzp, lam_p, vh, wh = polish_step(L, z, vi, wi,
                                                             st.device)
                        if not (np.isfinite(dzp)
                                and abs(dzp) < 1e-2 * max(abs(z), 1.0)):
                            break
                        z = z + dzp
                        vi, wi = vh, wh
                        lam[i] = lam_p
                        if abs(dzp) <= tol_s:
                            if nan_dz[i]:   # rescued by the polish
                                flag = ITSOL_CONVERGED
                            break
                except (RuntimeError, np.linalg.LinAlgError):
                    pass                    # keep the device iterate
            params = dict(L.params)
            params[eig] = z
            params[aux] = complex(lam[i])
            params[b_param] = b
            # reference normalization (Householder.jl:189-190)
            M = L.aux_weight()
            with np.errstate(all="ignore"):
                L.params[eig] = z
                nmv = np.sqrt(vi.conj() @ (M @ vi))
                if nmv != 0 and np.isfinite(nmv):
                    vi = vi / nmv
                cn = np.conj(wi.conj() @ (L(z, 1) @ vi))
                if cn != 0 and np.isfinite(cn):
                    wi = wi / cn
            results.append((Solution(params, vi, wi, eig, aux),
                            int(iters[i]), flag))
    finally:
        L.active, L.mode = saved_active, saved_mode
        if saved_b is not None:
            L.params[b_param] = saved_b
    return results


__all__ = ["bloch_mode_sweep", "SweepStep", "sweep_coefficients"]
