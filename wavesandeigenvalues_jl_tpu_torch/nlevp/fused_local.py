"""Fused-device local NLEVP solvers — the dense engine and the Newton loop.

Counterpart of the JAX package's ``nlevp/fused_local.py``.  The host
evaluates coefficients in complex128, the device runs one fused step per
Newton iteration, and a complex128 polish (:mod:`.polish`: an LU of L(z)
on the device, SuperLU on the host above ``POLISH_DEVICE_MAX_DIM``, and
shift-invert Arnoldi) supplies the last digits.

Routing, as in the JAX package: n ≤ ``FUSED_MAX_DIM`` = 1,400 goes to the
dense engine :class:`FusedPencilSolver`, whose inner solves are one launch
each of the dense GMRES kernel K2 (:func:`..ops.dense_gmres.dense_gmres`);
larger n to the slab engine :class:`.fused_slab.FusedSlabPencilSolver`
(kernel K3).  Both share the Newton step of :class:`.pencil.PencilSolver`.

A non-finite device dz hands the iteration to the general engine
(:func:`.solvers._local_engine`) on the same device, with a warning that
names the step, as the JAX package falls back to its own.  Nothing else is
caught: the JAX function also returns ``None`` where building the engine
or a step raises; the port lets that error propagate, so a kernel that
fails to build or launch raises.  The polish is wrapped as in the JAX
package: a linear-algebra error there keeps the device iterate.

Phases (``utils.timing``): ``fused_local.setup`` (the engine, once a
family), ``fused_local.device_step`` (with the step's own, :mod:`.pencil`)
and ``fused_local.polish_step`` with ``assemble`` (L(z), L′(z), M),
``lu``, ``arnoldi`` (both shift-invert runs) and ``quotient``.  The dense
engine's block-Jacobi refresh is a span ``bj_refresh`` under whichever
phase calls it (``fused_local.device_step.coefficients`` at a step's
start, the request itself after a step), counted in
``fused_local.bj_refresh``.  The request's front door gets the attributes
``engine`` (the engine's class), ``device_steps`` and ``polish_steps``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..ops.dense_gmres import dense_gmres
from ..ops.gmres import BatchedBlockDiagInv
from ..utils.config import CDTYPE, DEVICE_CDTYPE
from ..utils.timing import annotate, count, phase
from .family import OperatorFamily, Solution
from .fused_slab import FusedSlabPencilSolver
from .pencil import REFINE_SWEEPS, PencilSolver
from .polish import polish_step

#: inner-solve controls of the dense engine
GMRES_M = 80   # GMRES(40) stagnates on the penalty-BC Helmholtz operators
GMRES_CYCLES = 1
BJ_BS = 128           # block-Jacobi block size = the padded-N granularity
#: largest family dimension routed to the dense engine
FUSED_MAX_DIM = 1400


class FusedPencilSolver(PencilSolver):
    """Dense fused Newton state for one family of n ≤ ``FUSED_MAX_DIM``.

    Per step (:meth:`solver`): the complex128 solve data of both sides is
    cast to complex64, scattered into dense [N, N] operators (N = n padded
    to a multiple of 128) and premultiplied by the block-Jacobi inverses
    (a batched ``torch.matmul``: P = D⁻¹G); every solve of both sides is
    D⁻¹b and ONE launch of K2, GMRES(``GMRES_M``) with ``GMRES_CYCLES``
    cycles.  The block-Jacobi inverses are host complex128 LAPACK
    inversions cast to complex64, refreshed by :meth:`refresh_bj` on the
    protocol of :func:`try_fused_local`."""

    def __init__(self, L: OperatorFamily, device):
        super().__init__(L)
        n = self.n
        if n > FUSED_MAX_DIM:
            raise ValueError(
                f"dimension {n} above FUSED_MAX_DIM={FUSED_MAX_DIM}")
        self.N = N = ((n + BJ_BS - 1) // BJ_BS) * BJ_BS
        # block-Jacobi structure at the PADDED size (pad blocks → identity)
        (rows, cols), (rows_h, cols_h) = self.pattern
        self.bj = BatchedBlockDiagInv(rows, cols, N, BJ_BS)
        self.bjH = BatchedBlockDiagInv(rows_h, cols_h, N, BJ_BS)
        dest = np.stack([(side * N + r_) * N + c_
                         for side, (r_, c_) in enumerate(self.pattern)])
        self.register_buffer("dense_dest", torch.from_numpy(dest),
                             persistent=False)
        self._dj = None
        self.to(device)

    def refresh_bj(self, c: np.ndarray, sigma: complex):
        """Block-Jacobi inverses of both sides' A + σM at coefficients c,
        host complex128, kept on the device as complex64 [2, N/128, 128,
        128]; span ``bj_refresh``, counter ``fused_local.bj_refresh``."""
        with phase("bj_refresh"):
            data = c @ self._vals_host + sigma * self._m_data
            dj = self.bj.inv(data[None])[0]
            djH = self.bjH.inv(np.conj(data[self._perm])[None])[0]
            self._dj = torch.from_numpy(np.stack([dj, djH]).astype(
                np.complex64)).to(self.device)
        count("fused_local.bj_refresh")

    @property
    def stale(self) -> bool:
        return self._dj is None

    def operators(self, g: torch.Tensor) -> torch.Tensor:
        """Both sides' complex128 solve data g [2, nnz] -> the dense
        pre-preconditioned operators P = D⁻¹G, complex64 [2, N, N]."""
        N = self.N
        G = g.new_zeros(2 * N * N, dtype=DEVICE_CDTYPE)
        G.index_put_((self.dense_dest.view(-1),),
                     g.to(DEVICE_CDTYPE).view(-1))
        return (self._dj @ G.view(2, N // BJ_BS, BJ_BS, N)).view(2, N, N)

    def preconditioned(self, b: torch.Tensor) -> torch.Tensor:
        """Both sides' complex64 [2, n] rhs -> D⁻¹b padded to [2, N]."""
        N = self.N
        bp = b.new_zeros(2, N)
        bp[:, :self.n] = b
        return (self._dj @ bp.view(2, N // BJ_BS, BJ_BS, 1)).view(2, N)

    def solver(self, g: torch.Tensor):
        P = self.operators(g)

        def solve_both(b):
            """Both sides' complex64 [2, n] rhs -> solutions; one K2
            launch."""
            x = dense_gmres(P, self.preconditioned(b), GMRES_M, GMRES_CYCLES)
            return x[:, :self.n]

        return solve_both


def _resolve(device) -> torch.device:
    """The device as a solver reports it (``cuda`` -> ``cuda:<current>``);
    raises from torch where there is no such device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def try_fused_local(L: OperatorFamily, z, *, maxiter, tol, relax, lam_tol,
                    v0, v0_adj, output, scale, device):
    """Fused-device mslp/householder order-1 engine on ``device``.

    Returns (Solution, n_iters, flag), or None after a non-finite device
    dz (the caller's general engine then starts over).  Semantics mirror
    the reference's local engine for nev=1, order=1 (Newton update
    dz = −λ/λ′, which is both the householder order-1 update and the
    [1/0]-Padé root)."""
    from .solvers import (ITSOL_CONVERGED, ITSOL_IMPOSSIBLE, ITSOL_ISNAN,
                          ITSOL_MAXITER, ITSOL_SLOW_CONVERGENCE)

    device = _resolve(device)
    cached = getattr(L, "_fused_solver", None)
    if (cached is not None and cached[0] is L._stack()
            and cached[1].device == device):
        solver = cached[1]
    else:
        with phase("fused_local.setup"):
            if L._stack().shape[0] <= FUSED_MAX_DIM:
                solver = FusedPencilSolver(L, device)
            else:
                solver = FusedSlabPencilSolver(L, device)
        L._fused_solver = (L._stack(), solver)

    z = complex(z) * scale
    tol_s = tol * abs(scale) if scale != 1 else tol
    d = L.size
    if v0 is None or len(v0) == 0:
        v0 = np.ones(d, dtype=CDTYPE)
    if v0_adj is None or len(v0_adj) == 0:
        v0_adj = np.conj(np.asarray(v0))
    v0 = np.asarray(v0, CDTYPE)
    v0_adj = np.asarray(v0_adj, CDTYPE)
    carries = torch.from_numpy(np.stack([v0, v0_adj])).to(
        device=solver.device, dtype=DEVICE_CDTYPE)

    saved_active, saved_mode = list(L.active), L.mode
    eig, aux = L.eigval, L.auxval
    z0 = complex(np.inf)
    lam = complex(np.inf)
    n_it = 0
    best_dz, n_stall = np.inf, 0
    #: attainable |dz| floor of the device loop, tied to the requested tol
    floor = lambda zz: max(tol_s, 1e-12 * max(abs(zz), 1.0))
    if output:
        print("Launching fused-device mslp solver...")
        print("Iter    Res:         dz:          z:")

    sigma = 0.0 + 0.0j
    n_dev = n_pol = 0
    # the device loop only needs to land inside the Newton basin — the
    # complex128 host polish below supplies the last digits
    dev_tol = max(tol_s, 1e-5 * max(abs(z), 1.0))
    # ... and leaves it at least the last iteration, so that every answer
    # of this engine ends with a complex128 step (JAX: the device loop may
    # take all maxiter iterations; ROADMAP.md Queue 3, F9)
    dev_maxiter = max(maxiter - 1, 1)
    while abs(z - z0) > dev_tol and n_it < dev_maxiter:
        if output:
            print(f"{n_it}\t{abs(lam):.3e}\t{abs(z - z0):.3e}\t{z / scale}")
        with phase("fused_local.device_step"):
            dz, lam, carries, res = solver.step(z, carries, sigma,
                                                refresh=(n_it == 0))
        n_dev += 1
        annotate(engine=type(solver).__name__, device_steps=n_dev)
        if not np.isfinite(dz):
            warnings.warn(f"fused device step {n_it}: non-finite dz = {dz}; "
                          "the general local engine takes over (above "
                          "DEVICE_DENSE_MAX_DIM it solves with DeviceGMRES, "
                          "which stalls on the 7,259-DOF Rijke operator: "
                          "ROADMAP.md Queue 3, F4)",
                          RuntimeWarning, stacklevel=3)
            return None
        if n_it == 0:
            # gap-scale regularization: λ(z₀) is O(|z₀−z*|·λ′), a proxy
            # for the pencil's eigenvalue spacing.  σ keeps (A+σM)
            # nonsingular at the Newton fixed point; λ itself is
            # σ-independent.
            sigma = 0.1 * abs(lam)
            solver.refresh_bj(solver.coefficients(z)[0], sigma)
        elif res.max() > 1e-3:               # preconditioner went stale
            solver.refresh_bj(solver.coefficients(z)[0], sigma)
        z0 = z
        z = z + relax * dz
        n_it += 1
        adz = abs(relax * dz)
        if adz < best_dz:
            best_dz, n_stall = adz, 0
        else:
            n_stall += 1
            if n_stall >= 3 and best_dz <= floor(z):
                if output:
                    print("dz stagnated at attainable accuracy — stopping.")
                z0 = z
                break

    # a device loop that ran out of iterations ends at ITSOL_MAXITER, as
    # when it took all maxiter, whatever its polish step does
    exhausted = abs(z - z0) > dev_tol
    v, v_adj = solver.fetch_vectors(carries)

    # ---- complex128 polish steps ----------------------------------------
    # The device loop lands inside the Newton basin (dev_tol above); the
    # last digits come from 1-2 warm-started complex128 Newton steps
    # (:func:`.polish.polish_step`: L(z) factored on the solver's device
    # up to POLISH_DEVICE_MAX_DIM, on the host above, and shift-invert
    # Arnoldi from the factor — the reference's per-iteration machinery).
    # As in the JAX package, a polish step the numerics refuse (SuperLU's
    # RuntimeError, a singular LU, a LAPACK error) keeps the device
    # iterate; a fault of the device there (.polish.DeviceFault) raises.
    try:
        for _ in range(3):
            if n_it >= maxiter:
                break
            n_pol += 1
            annotate(polish_steps=n_pol)
            with phase("fused_local.polish_step"):
                dz, lam_p, vh, wh = polish_step(L, z, v, v_adj,
                                                solver.device)
            if not (np.isfinite(dz)
                    and abs(dz) < 1e-2 * max(abs(z), 1.0)):
                break
            z0 = z
            z = z + dz
            v, v_adj = vh, wh
            lam = lam_p
            n_it += 1
            if abs(dz) <= tol_s:
                break
    except (RuntimeError, np.linalg.LinAlgError):
        pass                                      # keep the device result

    L.params[eig] = z
    L.params[aux] = lam
    if n_it >= maxiter or exhausted:
        flag = ITSOL_MAXITER
    elif abs(lam) <= lam_tol:
        flag = ITSOL_CONVERGED
    elif abs(z - z0) <= tol_s:
        flag = ITSOL_SLOW_CONVERGENCE
    elif np.isnan(z):
        flag = ITSOL_ISNAN
    else:
        # the host polish never reached the requested tol
        flag = ITSOL_IMPOSSIBLE
    if output:
        print(f"{n_it}\t{abs(lam):.3e}\t{abs(z - z0):.3e}\t{z / scale}")
        print(f"Eigenvalue: {z / scale}  ({z / scale / 2 / np.pi} /2π)")
    L.active, L.mode = saved_active, saved_mode
    # reference normalization (Householder.jl:189-190)
    M = L.aux_weight()
    with np.errstate(all="ignore"):
        nmv = np.sqrt(v.conj() @ (M @ v))
        if nmv != 0 and np.isfinite(nmv):
            v = v / nmv
        L1v = L(L.params[eig], 1) @ v
        cnorm = np.conj(v_adj.conj() @ L1v)
        if cnorm != 0 and np.isfinite(cnorm):
            v_adj = v_adj / cnorm
    return Solution(L.params, v, v_adj, eig), n_it, flag


__all__ = ["FusedPencilSolver", "try_fused_local", "GMRES_M", "GMRES_CYCLES",
           "REFINE_SWEEPS", "BJ_BS", "FUSED_MAX_DIM"]
