"""Restarted GMRES in plain PyTorch, block-Jacobi preconditioners, and the
dense test problem the kernel K2 is checked on.

Counterpart of the JAX package's ``ops/gmres.py``.  There GMRES(m) is a
jitted ``fori_loop`` Arnoldi inside a ``while_loop`` over restarts, vmapped
over independent systems.  Here :func:`gmres_impl` runs the same
iteration on a batch of systems at once, rows of [k, n] tensors: the CGS2
Arnoldi on the device, then the complex Givens rotations and the
triangular back substitution of the small least-squares problem on the
host; the host synchronises once per restart cycle, for that problem and
the convergence test, where the JAX ``while_loop`` evaluates its
condition.  A system that has stopped keeps its iterate while the others
go on, as under ``vmap``.

The block-Jacobi inverses are host complex128 LAPACK inversions
(:func:`_block_diag_inv`, :class:`BatchedBlockDiagInv`).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .device import EllOperator
from .sparse import CSR


def _givens(a, b):
    """Complex Givens rotation zeroing b (numpy, elementwise over the
    systems): (c, s) with c real, [c s; −conj(s) c] applied to (a, b)."""
    absa = np.abs(a)
    denom = np.sqrt(absa ** 2 + np.abs(b) ** 2)
    zero = denom == 0
    safe = np.where(zero, 1.0, denom)
    c = np.where(zero, 1.0, absa / safe)
    phase = a / np.where(absa == 0, 1.0, absa)
    s = np.where(zero, 0.0, np.where(absa == 0, 1.0, phase * np.conj(b) / safe))
    return c, s


def _least_squares(H: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """y minimising ‖β e₁ − H y‖ for each system (H [k, m+1, m]): Givens
    rotations in the JAX package's order (rotation i reaches column j
    after rotations 0..i−1, as when each new column is rotated on
    arrival), then back substitution, a zero pivot (Krylov breakdown)
    dividing by 1."""
    k, m1, m = H.shape
    H = H.copy()
    g = np.zeros((k, m1), H.dtype)
    g[:, 0] = beta
    for j in range(m):
        c, s = _givens(H[:, j, j], H[:, j + 1, j])
        rj, rj1 = H[:, j, j:].copy(), H[:, j + 1, j:].copy()
        H[:, j, j:] = c[:, None] * rj + s[:, None] * rj1
        H[:, j + 1, j:] = -np.conj(s)[:, None] * rj + c[:, None] * rj1
        H[:, j + 1, j] = 0.0
        g[:, j], g[:, j + 1] = c * g[:, j] + s * g[:, j + 1], \
            -np.conj(s) * g[:, j]
    y = np.zeros((k, m), H.dtype)
    for i in range(m - 1, -1, -1):
        d = H[:, i, i]
        y[:, i] = ((g[:, i] - np.einsum("kj,kj->k", H[:, i, :], y))
                   / np.where(d == 0, 1.0, d))
    return y


def gmres_impl(matvec: Callable, b: torch.Tensor,
               x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
               restart: int = 40, max_restarts: int = 20,
               precond: Optional[Callable] = None,
               stagnation: float = 0.9,
               reduce_fn: Optional[Callable] = None):
    """GMRES(``restart``) on the systems A_i x_i = b_i, the rows of ``b``
    ([k, n], or one system [n]), with an optional RIGHT preconditioner
    (solves A M⁻¹ u = b, x = M⁻¹ u).  ``matvec`` and ``precond`` map
    [k, n] to [k, n], row i through system i.  Returns (x, relres,
    n_restarts), each per system.

    The Arnoldi recurrence runs on b's device; the (m+1)×m least-squares
    problem of each cycle goes to the host, whose one synchronisation a
    cycle it shares with the convergence test.

    ``stagnation``: a system stops restarting when a restart improves its
    residual by less than this factor (res ≥ stagnation·prev), for
    mixed-precision callers that recover accuracy by refinement; pass
    ``float('inf')`` to run to ``tol`` or ``max_restarts``.

    ``reduce_fn``: the sum across row shards of a tensor of partial sums
    (None: the rows are whole).  With row-sharded systems every dot
    product and norm goes through it (both CGS2 projections, β, ‖w‖ and
    the convergence test), so the least-squares problem and every branch
    on the residuals read only reduced values: each shard solves the same
    small problem and takes the same decisions
    (:mod:`..parallel.dist_solve`)."""
    single = b.dim() == 1
    if single:
        b = b.unsqueeze(0)
    k, n = b.shape
    m = restart
    x = torch.zeros_like(b) if x0 is None else x0.reshape(k, n).clone()
    Minv = precond if precond is not None else (lambda v: v)
    if reduce_fn is None:
        reduce_ = lambda t: t                               # noqa: E731

        def vnorm(v):
            return torch.linalg.vector_norm(v, dim=1)
    else:
        reduce_ = reduce_fn

        def vnorm(v):
            return reduce_fn((v * v.conj()).real.sum(1)).sqrt()
    bnorm = vnorm(b)
    bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)

    def arnoldi_cycle(x):
        r = b - matvec(x)
        beta = vnorm(r)
        V = b.new_zeros(k, m + 1, n)
        V[:, 0] = r / torch.where(beta == 0, torch.ones_like(beta),
                                  beta)[:, None]
        H = b.new_zeros(k, m + 1, m)
        for j in range(m):
            w = matvec(Minv(V[:, j]))
            # classical Gram-Schmidt with re-orthogonalization (CGS2):
            # one pass loses orthogonality like ε·κ² (JAX ops/gmres.py)
            Vj = V[:, :j + 1]
            h1 = reduce_(torch.einsum("kin,kn->ki", Vj.conj(), w))
            w = w - torch.einsum("ki,kin->kn", h1, Vj)
            h2 = reduce_(torch.einsum("kin,kn->ki", Vj.conj(), w))
            w = w - torch.einsum("ki,kin->kn", h2, Vj)
            hn = vnorm(w)
            V[:, j + 1] = w / torch.where(hn == 0, torch.ones_like(hn),
                                          hn)[:, None]
            H[:, :j + 1, j] = h1 + h2
            H[:, j + 1, j] = hn
        y = _least_squares(H.cpu().numpy(), beta.cpu().numpy())
        y = torch.from_numpy(y).to(b.device)
        return x + Minv(torch.einsum("ki,kin->kn", y, V[:, :m]))

    def relres(x):
        return vnorm(b - matvec(x)) / bnorm

    res = relres(x)
    prev = torch.full_like(res, float("inf"))
    its = torch.zeros(k, dtype=torch.int64, device=b.device)

    def going():
        return (its < max_restarts) & (res > tol) & (res < stagnation * prev)

    active = going()
    while bool(active.any()):             # one host sync a restart cycle
        x_new = arnoldi_cycle(x)
        res_new = relres(x_new)
        x = torch.where(active[:, None], x_new, x)
        prev = torch.where(active, res, prev)
        res = torch.where(active, res_new, res)
        its = its + active.to(its.dtype)
        active = going()
    if single:
        return x[0], res[0], its[0]
    return x, res, its


def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
          restart: int = 40, max_restarts: int = 20,
          precond: Optional[Callable] = None, stagnation=float("inf")):
    """Restarted GMRES(m) for A x = b with an optional RIGHT
    preconditioner (residuals are true residuals).  Returns (x, relres,
    n_restarts).  The stagnation cutoff is off by default (runs to tol or
    max_restarts), as the JAX package's ``gmres``."""
    return gmres_impl(matvec, b, x0, tol=tol, restart=restart,
                      max_restarts=max_restarts, precond=precond,
                      stagnation=stagnation)


def _block_diag_inv(rows, cols, data, n: int, bs: int) -> np.ndarray:
    """[nb, bs, bs] inverted diagonal blocks of a COO matrix (duplicates
    summed); empty pad rows regularized to identity."""
    nb = (n + bs - 1) // bs
    D = np.zeros((nb, bs, bs), np.complex128)
    sel = (rows // bs) == (cols // bs)
    np.add.at(D, (rows[sel] // bs, rows[sel] % bs, cols[sel] % bs),
              data[sel])
    idx = np.arange(bs)
    dead = np.abs(D[:, idx, idx]) == 0
    D[:, idx, idx] = np.where(dead, 1.0, D[:, idx, idx])
    return np.linalg.inv(D)


def gmres_test_problem(N: int, seed: int = 0, bs: int = 128):
    """The dense GMRES test problem of the JAX package's
    ``tests/test_pallas_gmres.py:13-29`` for both sides (A and Aᴴ), with
    this module's block-Jacobi inverse.  Returns the pre-preconditioned
    P = D⁻¹G [2, N, N] and D⁻¹b [2, N] in complex64, and the complex128
    operators G (a list of two) and rhs b for the true residuals."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    A = A * 0.05 + np.diag(3.0 + rng.standard_normal(N)
                           + 1j * 0.3 * rng.standard_normal(N))
    b = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    nb = N // bs
    rows, cols = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    Ps, b0s, Gs = [], [], []
    for G in (A, A.conj().T):
        D = _block_diag_inv(rows.ravel(), cols.ravel(), G.ravel(), N, bs)
        Ps.append(np.einsum("bij,bjk->bik", D,
                            G.reshape(nb, bs, N)).reshape(N, N))
        b0s.append(np.einsum("bij,bj->bi", D, b.reshape(nb, bs)).reshape(N))
        Gs.append(G)
    return (np.stack(Ps).astype(np.complex64),
            np.stack(b0s).astype(np.complex64), Gs, b)


class BatchedBlockDiagInv:
    """Precomputed diagonal-block structure for inverting the [bs,bs]
    block-Jacobi smoother at many shifts in one shot: structure indices are
    built once, each batch is one fancy-index scatter + one batched LAPACK
    inversion."""

    def __init__(self, rows, cols, n: int, bs: int):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        self.n, self.bs = int(n), int(bs)
        self.nb = (n + bs - 1) // bs
        sel = (rows // bs) == (cols // bs)
        self.sel = np.where(sel)[0]
        self.bi = rows[self.sel] // bs
        self.ri = rows[self.sel] % bs
        self.ci = cols[self.sel] % bs
        # COO inputs may carry duplicate entries (to be summed); union-CSR
        # patterns are unique and take the direct-assignment fast path
        key = (self.bi * bs + self.ri) * bs + self.ci
        self.unique = len(np.unique(key)) == len(key)

    def inv(self, data: np.ndarray) -> np.ndarray:
        """[c, nnz] per-shift data -> [c, nb, bs, bs] inverted blocks."""
        data = np.atleast_2d(np.asarray(data, np.complex128))
        c = data.shape[0]
        D = np.zeros((c, self.nb, self.bs, self.bs), np.complex128)
        if self.unique:
            D[:, self.bi, self.ri, self.ci] = data[:, self.sel]
        else:
            np.add.at(D, (np.arange(c)[:, None], self.bi[None, :],
                          self.ri[None, :], self.ci[None, :]),
                      data[:, self.sel])
        idx = np.arange(self.bs)
        diag = D[:, :, idx, idx]
        D[:, :, idx, idx] = np.where(np.abs(diag) == 0, 1.0, diag)
        return np.linalg.inv(D)


def _block_apply(Dinv: torch.Tensor, n: int):
    """Closure v ↦ D⁻¹v over the block inverses ``Dinv`` [nb, bs, bs] (or
    one set per system, [k, nb, bs, bs]) for v [k, n]."""
    nb, bs = Dinv.shape[-3], Dinv.shape[-2]
    npad = nb * bs
    spec = "kbij,kbj->kbi" if Dinv.dim() == 4 else "bij,kbj->kbi"

    def apply(v):
        vp = v.new_zeros(v.shape[0], npad)
        vp[:, :n] = v
        out = torch.einsum(spec, Dinv, vp.view(v.shape[0], nb, bs))
        return out.reshape(v.shape[0], npad)[:, :n]

    return apply


def block_jacobi(A, bs: int = 64, device="cuda"):
    """Right preconditioner v ↦ D⁻¹v ([k, n] rows) from the inverted
    [bs, bs] diagonal blocks of a host CSR matrix, complex128 on
    ``device``."""
    rows, cols, vals = A.to_coo()
    Dinv = _block_diag_inv(np.asarray(rows, np.int64),
                           np.asarray(cols, np.int64),
                           np.asarray(vals, np.complex128), A.shape[0], bs)
    return _block_apply(torch.from_numpy(Dinv).to(device), A.shape[0])


def solve_shifted_batch(family, zs, B, tol: float = 1e-8, restart: int = 60,
                        max_restarts: int = 50, bs: int = 64,
                        device="cuda"):
    """Solve L(z_s) X_s = B_s for a batch of shifts on ``device``, all at
    once in :func:`gmres_impl` (the Beyn quadrature axis, beyn.jl:62-74).

    ``family``: an OperatorFamily; ``zs``: [S] complex shifts; ``B``:
    [S, n] right-hand sides.  Uses the union-pattern stacked operator and
    per-shift LEFT block-Jacobi preconditioners (left, because the penalty
    rows span ~16 orders of magnitude and left scaling normalises them).
    Returns ([S, n] host solutions, the preconditioned residuals
    ‖D⁻¹(b−Ax)‖/‖D⁻¹b‖), complex128 as the JAX package off a TPU."""
    S = family._stack()
    n = S.shape[0]
    zs = np.asarray(zs)
    coeffs = np.zeros((len(zs), S.values.shape[0]), np.complex128)
    eig = family.eigval
    z_saved = family.params[eig]
    for i, z in enumerate(zs):
        family.params[eig] = complex(z)
        coeffs[i] = family.coefficients({})
    family.params[eig] = z_saved
    data = coeffs @ np.asarray(S.values)                     # [S, nnz]
    rows = np.asarray(S.row_ids(), np.int64)
    cols = np.asarray(S.indices, np.int64)
    Dinv = np.stack([_block_diag_inv(rows, cols, d, n, bs) for d in data])

    ell = EllOperator.from_csr(CSR(S.indptr, S.indices, data[0], S.shape),
                               device=device)
    dt = torch.from_numpy(data).to(device)
    vals = torch.cat([dt, dt.new_zeros(len(zs), 1)], 1)[:, ell.gather]
    dinv = _block_apply(torch.from_numpy(Dinv).to(device), n)

    def spmv(x):
        return (vals * x[:, ell.cols]).sum(-1)

    b = torch.from_numpy(np.asarray(B, np.complex128)).to(device)
    x, res, _its = gmres_impl(lambda x: dinv(spmv(x)), dinv(b), tol=tol,
                              restart=restart, max_restarts=max_restarts,
                              stagnation=0.9)
    return x.cpu().numpy(), res.cpu().numpy()


__all__ = ["gmres_impl", "gmres", "block_jacobi", "solve_shifted_batch",
           "BatchedBlockDiagInv", "_block_diag_inv", "gmres_test_problem"]
