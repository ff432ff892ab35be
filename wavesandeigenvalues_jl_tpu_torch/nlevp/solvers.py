"""Nonlinear-eigenvalue solvers — the front door of the port.

Counterpart of the JAX package's ``nlevp/solvers.py``.

The local solvers take the fused device route: ``mslp`` and
``householder`` with ``order=1, nev=1, num_order<=1`` run
:func:`.fused_local.try_fused_local` on ``device``, the card (``"cuda"``)
unless the caller asks for the CPU.  It routes n ≤ 1,400 to the dense
engine (kernel K2) and larger n to the slab engine (kernel K3), as the JAX
package does.  Other settings (higher orders, several eigenvalues, the
host engine with perturbation theory) and the other local solvers raise
``NotImplementedError``; they are ROADMAP.md Queue 1 work.

The global solver is Beyn's contour method (``beyn``, beyn.jl:34-110):
quadrature nodes and the probe block, the moment sums through one of three
backends ("host": a SuperLU solve per node; "slab": the batched
block-tridiagonal direct solver on ``device``; "dense": one batched dense
solve on ``device``, :mod:`..parallel.dist_beyn`), the block-Hankel SVD
filter, the inside test and the eigenpair residuals.  The hybrid
global-local ``solve`` and ``generate_subspace`` raise
``NotImplementedError`` (ROADMAP.md Queue 1 item 3).

Reference implementations: src/NLEVP/{Householder.jl,iterative_solvers.jl,
beyn.jl}.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.linsolve import factorize
from ..utils.config import CDTYPE
from .family import OperatorFamily
from .fused_local import try_fused_local

# ---------------------------------------------------------------------------
# status flags (iterative_solvers.jl:4-14)
ITSOL_CONVERGED = 0
ITSOL_MAXITER = 1
ITSOL_SLOW_CONVERGENCE = 2
ITSOL_IMPOSSIBLE = -1
ITSOL_SINGULAR_EXCEPTION = -2
ITSOL_EIGS_EXCEPTION = -3
ITSOL_ISNAN = -4
ITSOL_UNKNOWN = -5

_FLAG_MSG = {
    ITSOL_CONVERGED: "Solution converged, everything OK!",
    ITSOL_MAXITER: "Warning: Maximum number of iterations has been reached!",
    ITSOL_SLOW_CONVERGENCE: "Warning: Slow progress!",
    ITSOL_IMPOSSIBLE: "Error: This error should be impossible. Please contact the developers!",
    ITSOL_SINGULAR_EXCEPTION: "Error: Singular matrix (iterate may be fully converged)!",
    ITSOL_EIGS_EXCEPTION: "Error: inner eigensolver failed!",
    ITSOL_ISNAN: "Error: eigenvalue is NaN!",
    ITSOL_UNKNOWN: "Error: Unknown error occurred!",
}


def decode_error_flag(flag: int) -> str:
    """Human-readable meaning of a solver status flag (fixed re-write of the
    reference's buggy decode_error_flag, iterative_solvers.jl:22-44)."""
    return _FLAG_MSG.get(flag, "Unknown flag code.")


def _local_engine(L: OperatorFamily, z, *, maxiter, tol, relax, lam_tol,
                  order, nev, v0, v0_adj, output, num_order, scale, device):
    if not (nev == 1 and order == 1 and num_order <= 1):
        raise NotImplementedError(
            f"order={order}, nev={nev}, num_order={num_order}: only the "
            "fused order-1 single-eigenvalue route is ported (ROADMAP.md "
            "Queue 1: host _local_engine with perturbation.py)")
    return try_fused_local(L, z, maxiter=maxiter, tol=tol, relax=relax,
                           lam_tol=lam_tol, v0=v0, v0_adj=v0_adj,
                           output=output, scale=scale, device=device)


def householder(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
                lam_tol=np.inf, order=1, nev=1, v0=None, v0_adj=None,
                output=False, *, device="cuda"):
    """Generalized Rayleigh-quotient / Householder iteration
    (Householder.jl:70-192) on ``device``."""
    return _local_engine(L, z, maxiter=maxiter, tol=tol, relax=relax,
                         lam_tol=lam_tol, order=order, nev=nev, v0=v0,
                         v0_adj=v0_adj, output=output, num_order=1, scale=1,
                         device=device)


def mslp(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
         lam_tol=np.inf, order=1, nev=1, v0=None, v0_adj=None, num_order=1,
         scale=1, output=False, *, device="cuda"):
    """Method of successive linear problems (iterative_solvers.jl:93-252)
    on ``device``."""
    return _local_engine(L, z, maxiter=maxiter, tol=tol, relax=relax,
                         lam_tol=lam_tol, order=order, nev=nev, v0=v0,
                         v0_adj=v0_adj, output=output, num_order=num_order,
                         scale=scale, device=device)


# ---------------------------------------------------------------------------
# Beyn contour solver (beyn.jl)


def gauss_nodes(Gamma, N: int):
    """Gauss-Legendre nodes/weights along the closed polygon ``Gamma``;
    returns flat arrays z[B], w[B] (w includes the (b-a)/2 edge scaling)
    (gauss, beyn.jl:112-138)."""
    X, W = np.polynomial.legendre.leggauss(N)
    zs, ws = [], []
    nG = len(Gamma)
    for i in range(nG):
        a, b = Gamma[i], Gamma[(i + 1) % nG]
        zs.append(X * (b - a) / 2 + (a + b) / 2)
        ws.append(W * (b - a) / 2)
    return np.concatenate(zs).astype(CDTYPE), np.concatenate(ws).astype(CDTYPE)


def initialize_V(d: int, l: int, random: bool = False, seed: int = 0):
    """Initial probe block (beyn.jl:379-392)."""
    if random:
        rng = np.random.default_rng(seed)
        V = rng.standard_normal((d, l)) + 1j * rng.standard_normal((d, l))
        V /= np.linalg.norm(V, axis=0, keepdims=True)
        return V.astype(CDTYPE)
    V = np.zeros((d, l), dtype=CDTYPE)
    for i in range(min(d, l)):
        V[i, i] = 1.0
    return V


def moments_digest(L: OperatorFamily, zs, ws, V, K: int) -> str:
    """Digest of what the moment sums depend on: the contour, probe block
    and K, the family's parameter values and its terms.  The eigval and
    auxval entries are left out: the quadrature overwrites the eigenvalue
    per node, so their values before the run do not matter."""
    import hashlib
    h = hashlib.sha256()
    for part in (zs.tobytes(), ws.tobytes(), np.asarray(V).tobytes(),
                 str(K).encode()):
        h.update(part)
    h.update(repr(sorted((str(k), complex(v))
                         for k, v in L.params.items()
                         if k not in (L.eigval, L.auxval))).encode())
    for t in L.terms:
        h.update(t.symbol.encode())
        h.update(str(t.params).encode())
        h.update(np.ascontiguousarray(t.coeff.data).tobytes())
    return h.hexdigest()


def load_moments(checkpoint: Optional[str], digest: str, A, output=False):
    """(A, next node) from ``checkpoint`` when its digest matches, else
    (A, 0) unchanged."""
    import os
    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint, allow_pickle=False) as ck:
            if str(ck["digest"]) == digest:
                if output:
                    print(f"resuming moments at node {int(ck['next'])}")
                return ck["A"], int(ck["next"])
        if output:
            print("checkpoint digest mismatch — recomputing")
    return A, 0


def save_moments(checkpoint: str, digest: str, A, next_idx: int):
    """Persist the partial moment sums atomically."""
    import os
    tmp = checkpoint + ".tmp.npz"
    np.savez(tmp, A=A, next=next_idx, digest=digest)
    os.replace(tmp, checkpoint)


def compute_moment_matrices(L: OperatorFamily, Gamma, V=None, l=5, K=1,
                            N=16, output=False, random=False,
                            checkpoint: Optional[str] = None,
                            checkpoint_every: int = 8):
    """Moment matrices A_p = ∮_Γ z^p L(z)^{-1} V dz, p = 0..2K-1
    (compute_moment_matrices, beyn.jl:233-268): one host SuperLU solve per
    quadrature node (:func:`..ops.linsolve.factorize`).

    ``checkpoint``: optional path; the partial sums are persisted there
    every ``checkpoint_every`` nodes (atomic npz) and an interrupted run
    resumes from the last saved node.  A checkpoint written for another
    contour, probe block, K or family is detected by digest and ignored."""
    from ..utils.timing import phase
    d = L.size
    if V is None:
        V = initialize_V(d, l, random=random)
    d, l = V.shape
    zs, ws = gauss_nodes(Gamma, N)
    A = np.zeros((d, l, 2 * K), dtype=CDTYPE)
    start, digest = 0, ""
    if checkpoint:
        digest = moments_digest(L, zs, ws, V, K)
        A, start = load_moments(checkpoint, digest, A, output)

    with phase("beyn.moments"):
        for idx in range(start, len(zs)):
            z, w = zs[idx], ws[idx]
            X = factorize(L(z), check=True).solve(V)
            zp = w
            for p in range(2 * K):
                A[:, :, p] += zp * X
                zp = zp * z
            if checkpoint and ((idx + 1) % checkpoint_every == 0
                               or idx + 1 == len(zs)):
                save_moments(checkpoint, digest, A, idx + 1)
    return A


def moments2eigs(A, tol_sigma: float = 0.0, return_sigma: bool = False,
                 rtol_sigma: float = 0.0):
    """Eigenpairs from moment matrices via block-Hankel SVD filtering
    (moments2eigs, beyn.jl:289-323).  ``A`` is one [d,l,2K] array or a list
    of them (incremental column blocks).

    ``tol_sigma`` is the reference's absolute σ cutoff; ``rtol_sigma``
    additionally drops directions with σ < rtol·σmax — essential when the
    operator is badly scaled (penalty admittance Y~1e15): Σ⁻¹ amplifies
    those pure-noise directions by σmax/σ ≳ 1/ε otherwise."""
    if isinstance(A, np.ndarray):
        A = [A]
    d = A[0].shape[0]
    dl = A[0].shape[1]
    l = len(A) * dl
    K = A[0].shape[2] // 2
    B0 = np.zeros((d * K, l * K), dtype=CDTYPE)
    B1 = np.zeros((d * K, l * K), dtype=CDTYPE)
    for i in range(K):
        for j in range(K):
            for ll, Ai in enumerate(A):
                r = slice(d * i, d * (i + 1))
                c = slice(ll * dl + l * j, ll * dl + l * j + dl)
                B0[r, c] = Ai[:, :, i + j]
                B1[r, c] = Ai[:, :, i + j + 1]
    V, S, Wh = np.linalg.svd(B0, full_matrices=False)
    cutoff = max(tol_sigma,
                 rtol_sigma * (S[0] if len(S) else 0.0))
    if cutoff > 0:
        mask = S > cutoff
        V, S, Wh = V[:, mask], S[mask], Wh[mask, :]
    W = Wh.conj().T
    Om, P = np.linalg.eig(V.conj().T @ B1 @ W @ np.diag(1.0 / S))
    P = V[:d, :] @ P
    if return_sigma:
        return Om, P, S
    return Om, P


def _isleft(a, b, c):
    return ((b.real - a.real) * (c.imag - a.imag)
            - (c.real - a.real) * (b.imag - a.imag))


def wn(z, Gamma) -> int:
    """Winding number of polygon Γ around z (wn, beyn.jl:185-209)."""
    w = 0
    nG = len(Gamma)
    for i in range(nG):
        a, b = Gamma[i], Gamma[(i + 1) % nG]
        if a.imag <= z.imag:
            if b.imag > z.imag and _isleft(a, b, z) > 0:
                w += 1
        else:
            if b.imag <= z.imag and _isleft(a, b, z) < 0:
                w -= 1
    return w


def inpoly(z, Gamma) -> bool:
    return wn(z, Gamma) != 0


def pos_test(Om, P, Gamma):
    """Keep only eigenpairs enclosed by Γ (pos_test, beyn.jl:333-337)."""
    mask = np.array([inpoly(z, Gamma) for z in Om], dtype=bool)
    return Om[mask], P[:, mask]


def row_equilibrated_residual(Lz, v) -> float:
    """Row-equilibrated relative eigenpair residual ‖D⁻¹L(ω)v‖/‖v‖ with
    D = diag of per-row max-abs of L(ω).

    The plain ‖Lv‖/(‖L‖_F‖v‖) is deflated by ~16 orders of magnitude on
    operators with 1e15 penalty rows: ‖L‖_F is dominated by the penalty
    entries, so a corrupted eigenpair whose residual lives in the
    O(1)-scaled rows still reports ~1e-17.  Equilibrating each row by its
    max-abs entry puts every row on the same O(1) scale.  O(nnz): one
    matvec + one segmented row reduction."""
    r = Lz @ v
    n = Lz.shape[0]
    indptr = np.asarray(Lz.indptr)
    rowmax = np.zeros(n)
    nonempty = indptr[:-1] < indptr[1:]
    if nonempty.any():
        rowmax[nonempty] = np.maximum.reduceat(
            np.abs(Lz.data), indptr[:-1][nonempty])
    rowmax[rowmax == 0.0] = 1.0
    return float(np.linalg.norm(r / rowmax)
                 / max(np.linalg.norm(v), 1e-300))


def verify_eigenpairs(L: OperatorFamily, Om, P, res_tol: Optional[float]
                      = None, output: bool = False):
    """Per-eigenpair sparse residuals for Beyn candidates, O(nnz) each.

    The metric used for ``res_tol`` and returned is the row-equilibrated
    relative residual (:func:`row_equilibrated_residual`); the
    Frobenius-normalized one the reference documents
    (docs/src/tutorial_00_NLEVP.md:291-302) is printed beside it but is no
    acceptance test on penalty-BC operators.  ``res_tol``: drop candidates
    above it (None keeps all).  Returns (Om, P, res) filtered alike."""
    Om = np.asarray(Om)
    res = np.empty(len(Om))
    res_frob = np.empty(len(Om))
    saved = L.params[L.eigval]
    for i, om in enumerate(Om):
        if not np.isfinite(om):
            res[i] = np.inf
            res_frob[i] = np.inf
            continue
        Lz = L(complex(om))
        v = P[:, i]
        res[i] = row_equilibrated_residual(Lz, v)
        res_frob[i] = (np.linalg.norm(Lz @ v)
                       / max(np.linalg.norm(Lz.data), 1e-300)
                       / max(np.linalg.norm(v), 1e-300))
    L.params[L.eigval] = saved
    if output and len(Om):
        for om, r, rf in zip(Om, res, res_frob):
            print(f"  eigenpair {om}: residual {r:.3e} "
                  f"(frobenius-normalized {rf:.3e})")
    if res_tol is not None:
        keep = res <= res_tol
        if output and (~keep).any():
            print(f"verify_eigenpairs: dropping {int((~keep).sum())} "
                  f"candidate(s) with residual > {res_tol:g}")
        return Om[keep], P[:, keep], res[keep]
    return Om, P, res


def _moments_backend(L: OperatorFamily, Gamma, V, K: int, N: int,
                     backend: str, output=False,
                     checkpoint: Optional[str] = None, device="cuda",
                     **solver_kw):
    """(moment matrices, info) through the selected quadrature backend:
    "auto" = "dense" up to DENSE_BEYN_MAX_DIM DOF, else "matfree"; "host"
    = serial sparse-LU loop on the host whatever ``device`` says
    (:func:`compute_moment_matrices`); "dense" = dense solves on
    ``device`` (:func:`..parallel.dist_beyn.batched_moments`); "slab" =
    the block-tridiagonal direct solver on ``device``
    (:func:`..parallel.dist_beyn.matfree_moments`); "matfree" = the
    matrix-free solver the partition favours, as in the JAX package (the
    slab solver; the panel GMRES it picks otherwise is not ported yet, nor
    is "gmres")."""
    from ..parallel.dist_beyn import (DENSE_BEYN_MAX_DIM, batched_moments,
                                      matfree_moments)
    if backend == "auto":
        backend = "dense" if L.size <= DENSE_BEYN_MAX_DIM else "matfree"
    if backend == "host":
        return compute_moment_matrices(L, Gamma, V, K=K, N=N, output=output,
                                       checkpoint=checkpoint), {}
    if backend == "gmres":
        raise NotImplementedError(
            "backend='gmres': the panel GMRES is not ported yet "
            "(ROADMAP.md Queue 1 item 4, ops/panel_solve.py)")
    if backend == "dense":
        if solver_kw:
            import warnings
            warnings.warn(
                "beyn: dense backend selected — matrix-free solver keywords "
                f"{sorted(solver_kw)} are ignored; pass backend='slab' to "
                "force the slab solver", stacklevel=3)
        return batched_moments(L, Gamma, V=V, K=K, N=N, device=device), {}
    method = {"slab": "slab", "matfree": "auto"}.get(backend)
    if method is None:
        raise ValueError(f"unknown backend {backend!r} (expected 'auto', "
                         "'host', 'dense', 'slab', 'matfree' or 'gmres')")
    return matfree_moments(L, Gamma, V=V, K=K, N=N, output=output,
                           checkpoint=checkpoint, method=method,
                           device=device, **solver_kw)


def beyn(L: OperatorFamily, Gamma, l=5, K=1, N=16, tol=0.0, rtol=0.0,
         pos_test_flag=True, output=False, random=False,
         checkpoint: Optional[str] = None, res_tol: Optional[float] = None,
         backend: str = "auto", return_residuals: bool = False,
         return_info: bool = False, *, device="cuda", **solver_kw):
    """Beyn's contour-integral global eigensolver (beyn.jl:34-110).

    Finds all eigenvalues inside the polygon Γ; follows the pseudocode of
    Buschmann et al. 2020.  ``tol``/``rtol``: absolute/relative singular-
    value cutoffs (:func:`moments2eigs`; use rtol≈1e-12 on badly scaled
    operators).  ``checkpoint``: optional path to persist/resume the
    quadrature.  ``res_tol``: per-eigenpair residual cutoff
    (:func:`verify_eigenpairs`; None keeps every candidate).  ``backend``:
    where the quadrature solves run (:func:`_moments_backend`) — by
    default on ``device``: dense solves up to DENSE_BEYN_MAX_DIM DOF, the
    slab direct solver above; "host" is the reference's serial sparse LU
    on the host.  Extra keywords pass to the slab solver.

    Returns (Om, P), then the eigenpair residuals if ``return_residuals``
    and, if ``return_info``, a dict with the Hankel singular values
    ``sigma`` and, from the slab solver, ``max_relres``, ``unconverged``
    and ``solver_timings``."""
    d = L.size
    # minimum augmentation so the Hankel blocks can hold l probes — the
    # reference's K=max(K, l÷d + (l%d≠0)) at beyn.jl:39
    K = max(K, (l + d - 1) // d)
    V = initialize_V(d, l, random=random)
    A, info = _moments_backend(L, Gamma, V, K, N, backend, output=output,
                               checkpoint=checkpoint, device=device,
                               **solver_kw)
    Om, P, S = moments2eigs(A, tol_sigma=tol, rtol_sigma=rtol,
                            return_sigma=True)
    if output:
        print("singular values:", S)
    if pos_test_flag:
        Om, P = pos_test(Om, P, Gamma)
    res = None
    if res_tol is not None or output or return_residuals:
        Om, P, res = verify_eigenpairs(L, Om, P, res_tol=res_tol,
                                       output=output)
    out = (Om, P)
    if return_residuals:
        out += (res,)
    if return_info:
        out += ({**info, "sigma": S},)
    return out


def count_poles_and_zeros(L: OperatorFamily, Gamma, N=16, output=False):
    """#zeros − #poles of det L inside Γ via the residue theorem on
    tr(L⁻¹L') (count_poles_and_zeros, beyn.jl:355-368).  A host-only
    utility: a sparse LU per node and a dense L' on the host, no
    ``device`` (it forms [d, d] matrices, so it serves small operators)."""
    zs, ws = gauss_nodes(Gamma, N)
    total = 0.0 + 0.0j
    for z, w in zip(zs, ws):
        F = factorize(L(z), check=True)
        L1 = L(z, 1).to_dense()
        total += w * np.trace(F.solve(L1))
    return total / (2 * np.pi * 1j)


def generate_subspace(L: OperatorFamily, Y, tol, Z, N=None, output=False,
                      include_Y=True):
    """Residual-controlled projection subspace (beyn.jl:429-569): not
    ported yet."""
    raise NotImplementedError(
        "generate_subspace needs the host _local_engine (ROADMAP.md Queue "
        "1 item 3)")


def solve(L: OperatorFamily, Gamma, *args, **kwargs):
    """Hybrid global-local solver (solver.jl): not ported yet.  Its local
    refinement calls householder(..., order=3), which needs the host
    _local_engine."""
    raise NotImplementedError(
        "solve needs householder(order=3), the host _local_engine "
        "(ROADMAP.md Queue 1 item 3)")


__all__ = ["ITSOL_CONVERGED", "ITSOL_MAXITER", "ITSOL_SLOW_CONVERGENCE",
           "ITSOL_IMPOSSIBLE", "ITSOL_SINGULAR_EXCEPTION",
           "ITSOL_EIGS_EXCEPTION", "ITSOL_ISNAN", "ITSOL_UNKNOWN",
           "decode_error_flag", "householder", "mslp", "gauss_nodes",
           "initialize_V", "compute_moment_matrices", "moments2eigs", "wn",
           "inpoly", "pos_test", "row_equilibrated_residual",
           "verify_eigenpairs", "beyn", "count_poles_and_zeros",
           "generate_subspace", "solve"]
