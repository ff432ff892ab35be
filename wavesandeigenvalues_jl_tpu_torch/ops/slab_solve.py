"""BFS-slab partition and the block-tridiagonal direct panel solver.

Counterpart of the JAX package's ``ops/slab_solve.py``.  The partition
(``_concat_ranges``, ``bfs_levels``, ``SlabPartition``) is host numpy,
copied.  The solver (:class:`SlabSolver`) solves L(z_j) X_j = V at many
shifts z_j for the Beyn contour (reference: beyn.jl:62-74, one UMFPACK
factorization per node).

BFS level sets of ANY sparse operator's adjacency graph have the property
that every edge connects the same or adjacent levels — so ordering DOFs by
(merged) BFS level makes the operator block tridiagonal with dense-padded
slab blocks [s, s].  A block-Thomas factorization is then m sequential
steps of batched dense linear algebra, batched over the shifts of a chunk:

    Dt_i   = D_i − L_i · C_{i−1}
    C_i    = Dt_i⁻¹ U_i,     y_i = Dt_i⁻¹ (b_i − L_i y_{i−1})
    x_m    = y_m,            x_i = y_i − C_i x_{i+1}

The JAX solver is plain XLA (``lax.scan`` passes around a batched dense
solve), so here it is plain PyTorch: a Python loop over the m slabs of
``torch.linalg.inv_ex`` and matmuls on [B, s, s] complex64 tensors on
``device``.  The block inverses Dt_i⁻¹ stay on the device, so each
refinement re-solve is matmuls and band gathers only.  Rows are
equilibrated per shift (1/max|row|) on the host in complex128 before the
cast: the penalty rows (admittance Y≈1e15) otherwise destroy the complex64
factorization.  Residuals and the acceptance norm are exact complex128 on
the host (the product L(z)·X in the native multithreaded CSR SpMM).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import native
from .reorder import adjacency_from_csr
from .sparse import CSR

#: device-memory budget (bytes) for the stored block inverses of a chunk
SLAB_BUDGET = 6.0e9


def _concat_ranges(starts, counts):
    """Concatenate ranges(starts[i], starts[i]+counts[i]) vectorized."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    out = np.ones(total, np.int64)
    ends = np.cumsum(counts)
    out[0] = starts[0]
    nz = counts > 0
    first = np.flatnonzero(nz)
    # at each range boundary, jump to the next start
    prev_end = starts[first[:-1]] + counts[first[:-1]]
    out[ends[first[:-1]]] = starts[first[1:]] - prev_end + 1
    return np.cumsum(out)


def bfs_levels(indptr, nbrs, n: int):
    """BFS level of every vertex from a pseudo-peripheral seed (two-pass);
    disconnected components continue the level numbering (no cross edges,
    so sharing slab indices across components stays block-tridiagonal)."""
    lvl = np.full(n, -1, np.int64)
    deg = np.diff(indptr)

    def _bfs(start, base, write):
        seen = lvl >= 0 if write else np.zeros(n, bool)
        local = np.full(n, -1, np.int64)
        frontier = np.array([start], np.int64)
        local[start] = 0
        seen[start] = True
        d = 0
        while frontier.size:
            counts = (indptr[frontier + 1] - indptr[frontier])
            nb = nbrs[_concat_ranges(indptr[frontier], counts)]
            nb = np.unique(nb[~seen[nb]])
            seen[nb] = True
            d += 1
            local[nb] = d
            frontier = nb
        if write:
            sel = local >= 0
            lvl[sel] = base + local[sel]
        return local

    base = 0
    todo = np.ones(n, bool)
    while todo.any():
        seed = int(np.flatnonzero(todo)[np.argmin(deg[todo])])
        l0 = _bfs(seed, 0, write=False)
        # farthest reached vertex of this component = better peripheral seed
        reach = l0 >= 0
        far = int(np.flatnonzero(reach)[np.argmax(l0[reach])])
        l1 = _bfs(far, base, write=True)
        comp = l1 >= 0
        base = int(lvl[lvl >= 0].max()) + 1
        todo &= ~comp
    return lvl


class SlabPartition:
    """DOF ordering by merged BFS levels: ``perm`` (new→old), slab sizes
    and, for every union-pattern nnz entry, its (slab, block, row, col)
    destination — everything the device assembly gathers/scatters need."""

    def __init__(self, indptr, indices, n: int, target: Optional[int] = None):
        A = CSR(np.asarray(indptr), np.asarray(indices),
                np.ones(len(indices)), (n, n))
        aptr, nbrs = adjacency_from_csr(A)
        lvl = bfs_levels(aptr, nbrs, n)
        sizes = np.bincount(lvl)

        # greedy merge of consecutive levels (edges only ever span one
        # level, so merged slabs stay tridiagonal)
        def merge(tgt):
            slab_of_level = np.empty(len(sizes), np.int64)
            cur, acc = 0, 0
            for k, sz in enumerate(sizes):
                if acc and acc + sz > tgt:
                    cur += 1
                    acc = 0
                slab_of_level[k] = cur
                acc += sz
            return slab_of_level

        if target is None:
            # auto-target: the stored block inverses cost m·smax² HBM
            # bytes per shift (re-read every refinement sweep — the
            # dominant resolve traffic) and the factorization m·smax³
            # flops; levels padded to the widest slab waste both, so
            # search merge targets for the one minimizing m·smax²
            # (tridiagonality holds for ANY consecutive-level merge)
            base = int(sizes.max())
            best_cost = None
            for mult in (1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0):
                tgt = int(base * mult)
                sol = merge(tgt)
                sl = sol[lvl]
                m_ = int(sl.max()) + 1
                smax_ = int(np.bincount(sl, minlength=m_).max())
                cost = m_ * smax_ * smax_
                if best_cost is None or cost < best_cost:
                    best_cost, target = cost, tgt
        slab_of_level = merge(target)
        slab = slab_of_level[lvl]
        self.m = int(slab.max()) + 1
        self.sizes = np.bincount(slab, minlength=self.m)
        self.smax = int(self.sizes.max())
        order = np.lexsort((np.arange(n), slab))
        self.perm = order                       # new -> old
        self.iperm = np.empty(n, np.int64)
        self.iperm[order] = np.arange(n)
        self.slab_of_new = slab[order]
        starts = np.zeros(self.m + 1, np.int64)
        np.cumsum(self.sizes, out=starts[1:])
        self.starts = starts
        self.loc_of_new = np.arange(n) - starts[self.slab_of_new]
        self.n = n

    def entry_destinations(self, rows, cols):
        """Per-nnz (slab i, block d∈{0:L,1:D,2:U}, row loc, col loc)."""
        rn = self.iperm[np.asarray(rows, np.int64)]
        cn = self.iperm[np.asarray(cols, np.int64)]
        si, sj = self.slab_of_new[rn], self.slab_of_new[cn]
        d = sj - si + 1
        if d.min() < 0 or d.max() > 2:
            raise AssertionError("BFS slab partition violated "
                                 "tridiagonality — this cannot happen")
        return si, d, self.loc_of_new[rn], self.loc_of_new[cn]


def _band_ell(si, rl, cl, sel, m: int, s: int, nnz: int):
    """Padded-ELL map of one band: for every (slab, row-loc) the nnz ids
    and column locs of its entries, padded to the widest row (sentinel id
    ``nnz`` gathers the appended zero value, col 0).  Lets the passes apply
    L·y / U·x as gather+reduce instead of re-scattering dense [s, s]
    blocks every step."""
    s_i = np.asarray(si)[sel]
    r_i = np.asarray(rl)[sel]
    c_i = np.asarray(cl)[sel]
    eids = np.flatnonzero(sel)
    key = s_i * s + r_i
    order = np.argsort(key, kind="stable")
    ks = key[order]
    if len(ks):
        first = np.r_[True, ks[1:] != ks[:-1]]
        start = np.maximum.accumulate(
            np.where(first, np.arange(len(ks)), 0))
        slot = np.arange(len(ks)) - start
        w = int(slot.max()) + 1
    else:
        slot = np.empty(0, np.int64)
        w = 1
    eid = np.full((m, s, w), nnz, np.int64)
    col = np.zeros((m, s, w), np.int64)
    eid[s_i[order], r_i[order], slot] = eids[order]
    col[s_i[order], r_i[order], slot] = c_i[order]
    return eid, col


def family_coefficients(L, zs) -> np.ndarray:
    """Per-term coefficients of ``L`` at each shift [S, K] (host,
    complex128); the family's eigenvalue parameter is restored after."""
    eig = L.eigval
    saved = L.params[eig]
    out = np.zeros((len(zs), len(L.terms)), np.complex128)
    for i, z in enumerate(np.asarray(zs)):
        L.params[eig] = complex(z)
        out[i] = L.coefficients({})
    L.params[eig] = saved
    return out


# ---------------------------------------------------------------------------
# device passes: Python loops over the slabs.  ``d`` [B, nnz+1] is a
# chunk's equilibrated values (sentinel 0 last), ``mp`` the solver's maps.


def _slab_panel(d, eidx_i, dest_i, s: int):
    """One slab's [B, 3, s, s] (L, D, U) block panel: the slab's values
    gathered and scatter-added into a flat panel whose extra last slot
    takes the padding entries (their value is the zero sentinel, so the
    collisions there add 0 and no real entry is touched)."""
    B = d.shape[0]
    blk = torch.zeros(B, 3 * s * s + 1, 2, dtype=d.real.dtype,
                      device=d.device)
    blk.index_add_(1, dest_i, torch.view_as_real(d[:, eidx_i]))
    return torch.view_as_complex(blk[:, :3 * s * s]).view(B, 3, s, s)


def _band_apply(d, eid_i, col_i, v):
    """(band_i @ v) by padded-ELL gather+reduce: ``eid_i``/``col_i`` [s, w]
    per-row nnz ids / neighbour-slab column locs, ``v`` [B, s, l] the
    neighbouring slab's panel; no dense [s, s] block is formed."""
    return torch.einsum("bsw,bswl->bsl", d[:, eid_i], v[:, col_i, :])


def _slab_rhs(b, rmap):
    """RHS [B, n+1, l] (row n zero) in slab layout [m, B, s, l]."""
    return b[:, rmap].transpose(0, 1)


def _unpermute(X, src):
    """Slab-layout X [m, B, s, l] to [B, n, l] in the original order."""
    m, B, s, l = X.shape
    return X.transpose(0, 1).reshape(B, m * s, l)[:, src]


def _fwd_pass(DT, d, bs, mp):
    """Forward re-solve y_i = Dt_i⁻¹ (b_i − L_i y_{i−1}) of a slab-layout
    RHS ``bs`` [m, B, s, l] with the stored inverses ``DT`` [m, B, s, s]."""
    Y = torch.empty_like(bs)
    y = torch.zeros_like(bs[0])
    for i in range(bs.shape[0]):
        y = DT[i] @ (bs[i] - _band_apply(d, mp["eidL"][i], mp["colL"][i], y))
        Y[i] = y
    return Y


def _bwd_pass(DT, d, Y, mp):
    """Backward substitution x_i = y_i − Dt_i⁻¹ U_i x_{i+1}, slab layout."""
    X = torch.empty_like(Y)
    x = torch.zeros_like(Y[0])
    for i in range(Y.shape[0] - 1, -1, -1):
        x = Y[i] - DT[i] @ _band_apply(d, mp["eidU"][i], mp["colU"][i], x)
        X[i] = x
    return X


def _factor_pass(d, b, mp, s: int):
    """Block-Thomas factorization and solve of one chunk: ``b`` [B, n+1,
    l] the equilibrated RHS.  Returns X [B, n, l], the inverses DT
    [m, B, s, s] and the summed LU infos (nonzero: an exactly singular
    Dt_i).  No host sync inside: the infos are read once, by the caller."""
    m = mp["eidx"].shape[0]
    B, l = d.shape[0], b.shape[-1]
    DT = d.new_empty(m, B, s, s)
    Y = d.new_empty(m, B, s, l)
    C = d.new_zeros(B, s, s)
    y = d.new_zeros(B, s, l)
    info = torch.zeros(B, dtype=torch.int32, device=d.device)
    for i in range(m):
        Lb, Db, Ub = _slab_panel(d, mp["eidx"][i], mp["dest"][i],
                                 s).unbind(1)
        # empty tail rows of a short slab get a unit diagonal
        Dtinv, bad = torch.linalg.inv_ex(
            Db - Lb @ C + torch.diag(mp["pad"][i]))
        info += bad
        C = Dtinv @ Ub
        y = Dtinv @ (b[:, mp["rmap"][i]] - Lb @ y)
        DT[i], Y[i] = Dtinv, y
    return _unpermute(_bwd_pass(DT, d, Y, mp), mp["src"]), DT, info


def _resolve_pass(DT, d, b, mp):
    """One refinement re-solve with the stored inverses."""
    Y = _fwd_pass(DT, d, _slab_rhs(b, mp["rmap"]), mp)
    return _unpermute(_bwd_pass(DT, d, Y, mp), mp["src"])


def _double_resolve_pass(DT, d, b, mp):
    """Two refinement sweeps: re-solve, the residual of the first sweep on
    the device in complex64 (slab-layout band matvecs, accurate enough while
    the relres is far above the complex64 floor ~1e-7), re-solve that, and
    return the summed correction."""
    bs = _slab_rhs(b, mp["rmap"])
    X1 = _bwd_pass(DT, d, _fwd_pass(DT, d, bs, mp), mp)
    m = X1.shape[0]
    R = torch.empty_like(bs)
    for i in range(m):
        r = bs[i] - _band_apply(d, mp["eidD"][i], mp["colD"][i], X1[i])
        if i > 0:
            r -= _band_apply(d, mp["eidL"][i], mp["colL"][i], X1[i - 1])
        if i + 1 < m:
            r -= _band_apply(d, mp["eidU"][i], mp["colU"][i], X1[i + 1])
        R[i] = r
    X2 = _bwd_pass(DT, d, _fwd_pass(DT, d, R, mp), mp)
    return _unpermute(X1 + X2, mp["src"])


def auto_chunk(part: SlabPartition) -> int:
    """Shifts a chunk holds within SLAB_BUDGET (at most 16): the complex64
    inverses and y panels, counted as the JAX package's f32 planes."""
    per_shift = (2 * part.m * part.smax ** 2 + 2 * part.m * part.smax * 8) * 4
    return int(max(1, min(16, SLAB_BUDGET // per_shift)))


class SlabSolver:
    """Block-tridiagonal DIRECT solver for L(z_j) X_j = V panels at many
    shifts, on ``device``.

    Each chunk of shifts runs one batched block-Thomas factorization (m
    steps of [B, s, s] dense work) and keeps the block inverses on the
    device; every refinement re-solve is then matmuls and band gathers.
    Mixed precision: complex64 factorization + exact complex128 host
    residuals + iterative refinement, judged in the row-equilibrated norm
    (the factorization runs on the equilibrated system).

    ``refine_sweeps`` caps the re-solve sweeps of a chunk; a chunk also
    stops at ``refine_tol`` or when a double sweep gains less than 4x.
    The cap is 12 where the JAX package's is 4: on the 57,210-DOF passive
    Rijke contour a double sweep gains only ~100x, so 4 sweeps stop near
    relres 1e-8, and Beyn's Hankel filter with the identity probe block
    amplifies that by up to σ_max/σ_k (7.4e4 there) into mode errors of
    2e-4·f; the JAX package's complex64 solver leaves the same errors at
    the same cap.  A chunk
    that ends above ``refine_tol`` is listed in the ``unconverged`` entry
    of :meth:`solve`'s info and warned about."""

    def __init__(self, family, chunk: Optional[int] = None,
                 refine_sweeps: int = 12, refine_tol: float = 1e-11, *,
                 device="cuda"):
        import scipy.sparse as sp
        self.family = family
        S = family._stack()
        self.n = int(S.shape[0])
        self.nnz = int(S.nnz)
        self.refine_sweeps, self.refine_tol = refine_sweeps, refine_tol
        self.device = torch.device(device)
        self._sp = sp
        self._indptr = np.asarray(S.indptr, np.int64)
        self._indices = np.asarray(S.indices)
        self._indices64 = self._indices.astype(np.int64)
        self._values128 = np.asarray(S.values, np.complex128)
        rows = np.asarray(S.row_ids(), np.int64)
        self._rows = rows
        part = SlabPartition(S.indptr, S.indices, self.n)
        self.part = part
        m, s = part.m, part.smax
        si, d, rl, cl = part.entry_destinations(rows, self._indices)
        # per-slab scatter maps, padded to the slab with the most entries:
        # eidx into the values [nnz] + zero sentinel, dest into the flat
        # [3·s·s] panel + dump slot
        counts = np.bincount(si, minlength=m)
        eidx = np.full((m, counts.max()), self.nnz, np.int64)
        dest = np.full((m, counts.max()), 3 * s * s, np.int64)
        order = np.argsort(si, kind="stable")
        flat_dest = (d * s + rl) * s + cl
        off = np.concatenate([[0], np.cumsum(counts)])
        # per-slab RHS row map (new-order rows; sentinel row n is zero)
        rmap = np.full((m, s), self.n, np.int64)
        for i in range(m):
            sl = order[off[i]:off[i + 1]]
            eidx[i, :len(sl)] = sl
            dest[i, :len(sl)] = flat_dest[sl]
            rows_i = part.perm[part.starts[i]:part.starts[i + 1]]
            rmap[i, :len(rows_i)] = rows_i
        # original DOF -> flat padded slab slot (the un-permute gather)
        newidx = part.iperm
        src = part.slab_of_new[newidx] * s + part.loc_of_new[newidx]
        pad = (np.arange(s)[None, :] >= part.sizes[:, None])
        host = {"eidx": eidx, "dest": dest, "rmap": rmap, "src": src,
                "pad": pad.astype(np.complex64)}
        # padded-ELL maps of the L (d=0), D (d=1) and U (d=2) bands
        for name, band in (("L", 0), ("D", 1), ("U", 2)):
            host["eid" + name], host["col" + name] = _band_ell(
                si, rl, cl, d == band, m, s, self.nnz)
        self._maps = {k: torch.from_numpy(v).to(self.device)
                      for k, v in host.items()}
        self._chunk = chunk
        self.timings = {"prep_s": 0.0, "device_s": 0.0, "residual_s": 0.0,
                        "factor_steps": 0, "resolve_steps": 0}

    # -- host helpers ------------------------------------------------------

    def coefficients(self, zs) -> np.ndarray:
        return family_coefficients(self.family, zs)

    def _host_csr(self, coeff):
        data = coeff @ self._values128
        return self._sp.csr_matrix((data, self._indices, self._indptr),
                                   shape=(self.n, self.n))

    def default_group(self, l: int) -> int:
        """Natural shift-group size for contour drivers (one chunk)."""
        return self._chunk or auto_chunk(self.part)

    def _equilibrate(self, data):
        """Per-shift row scalings 1/max|row| of L(z) ([B, n]) from its
        values ``data`` [B, nnz], and the scaled values ([B, nnz+1],
        sentinel 0 appended)."""
        B = data.shape[0]
        absd = np.abs(data)
        srow = np.empty((B, self.n))
        seg = np.maximum.reduceat(absd, self._indptr[:-1], axis=1)
        empty = np.diff(self._indptr) == 0
        seg[:, empty] = 1.0
        srow[:] = 1.0 / np.where(seg == 0, 1.0, seg)
        dpad = np.concatenate([data * srow[:, self._rows],
                               np.zeros((B, 1), data.dtype)], axis=1)
        return srow, dpad

    def _to_device(self, x):
        return torch.from_numpy(np.asarray(x, np.complex64)).to(self.device)

    @staticmethod
    def _to_host(X):
        return X.cpu().numpy().astype(np.complex128)

    # -- device sweeps -----------------------------------------------------

    def _factor_solve_chunk(self, dpad, bsc):
        """Factorize + solve one chunk: ``dpad`` [B, nnz+1] equilibrated
        values, ``bsc`` [B, n+1, l] equilibrated RHS (row n zero).  Returns
        (X [B, n, l] host complex128, (inverses, values) for re-solves)."""
        d = self._to_device(dpad)
        X, DT, info = _factor_pass(d, self._to_device(bsc), self._maps,
                                   self.part.smax)
        self.timings["factor_steps"] += self.part.m
        X = self._to_host(X)
        if int(info.abs().max()) != 0:
            raise np.linalg.LinAlgError(
                "slab factorization: an exactly singular block")
        return X, (DT, d)

    def _resolve_chunk(self, fact, bsc):
        """Re-solve with the stored inverses (one sweep)."""
        DT, d = fact
        X = _resolve_pass(DT, d, self._to_device(bsc), self._maps)
        self.timings["resolve_steps"] += self.part.m
        return self._to_host(X)

    def _double_resolve_chunk(self, fact, bsc):
        """Two refinement sweeps (device complex64 mid-residual)."""
        DT, d = fact
        X = _double_resolve_pass(DT, d, self._to_device(bsc), self._maps)
        self.timings["resolve_steps"] += 2 * self.part.m
        return self._to_host(X)

    # -- public API --------------------------------------------------------

    def _prep_chunk(self, c, b):
        """Host-side chunk preparation: residual CSR values, row
        equilibration, scaled RHS.  Runs on a worker thread (numpy and
        scipy only, never torch) so chunk k+1's prep overlaps chunk k's
        device factorization."""
        t0 = time.perf_counter()
        chunk = len(c)
        l = b.shape[2]
        data = c @ self._values128                       # [B, nnz]
        srow, dpad = self._equilibrate(data)
        bsc = np.zeros((chunk, self.n + 1, l), np.complex128)
        bsc[:, :self.n] = b * srow[:, :, None]
        bnorm = np.linalg.norm(bsc, axis=1)              # [B, l] scaled
        bnorm = np.where(bnorm == 0, 1.0, bnorm)
        return {"data": data, "srow": srow, "dpad": dpad, "bsc": bsc,
                "bnorm": bnorm, "b": b,
                "prep_s": time.perf_counter() - t0}

    def solve(self, zs, V, output: bool = False):
        """X[j] = L(z_j)⁻¹ V to complex128 accuracy; ``V`` is one [n, l]
        panel or per-shift [S, n, l].  Returns (X, info) with the relres
        per shift and column, its max, the accumulated ``timings`` and
        ``unconverged``: (first shift, end shift, max relres) of every
        chunk that ended above ``refine_tol`` (a warning names them)."""
        import warnings
        from concurrent.futures import ThreadPoolExecutor
        zs = np.asarray(zs)
        Sn = len(zs)
        V = np.asarray(V, np.complex128)
        if V.ndim == 2:
            Bfull = np.broadcast_to(V[None], (Sn,) + V.shape).copy()
        else:
            Bfull = np.ascontiguousarray(V)              # [S, n, l]
        l = Bfull.shape[2]
        coeffs = self.coefficients(zs)
        cmax = self._chunk or auto_chunk(self.part)
        X = np.empty((Sn, self.n, l), np.complex128)
        relres = np.empty((Sn, l))
        # chunk boundaries up front so the worker can prep chunk k+1
        # while the device factorizes chunk k; a short last chunk is
        # padded to a power of two by repeating its last shift
        bounds = []
        s0 = 0
        while s0 < Sn:
            rem = Sn - s0
            chunk = min(cmax, 1 << (rem - 1).bit_length())
            s1 = min(s0 + chunk, Sn)
            bounds.append((s0, s1, chunk))
            s0 = s1

        def chunk_inputs(s0, s1, chunk):
            pad = chunk - (s1 - s0)
            c = coeffs[s0:s1]
            b = Bfull[s0:s1]
            if pad:
                c = np.concatenate([c, np.repeat(c[-1:], pad, 0)])
                b = np.concatenate([b, np.repeat(b[-1:], pad, 0)])
            return c, b

        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self._prep_chunk, *chunk_inputs(*bounds[0]))
            self._solve_chunks(bounds, chunk_inputs, fut, pool, X, relres,
                               l, output)
        unconverged = [(s0, s1, float(relres[s0:s1].max()))
                       for s0, s1, _ in bounds
                       if relres[s0:s1].max() > self.refine_tol]
        if unconverged:
            warnings.warn(
                f"SlabSolver: {len(unconverged)} of {len(bounds)} chunks "
                f"ended above refine_tol {self.refine_tol:g} (max relres "
                f"{max(r for *_, r in unconverged):.3e}, refine_sweeps "
                f"{self.refine_sweeps})", RuntimeWarning, stacklevel=2)
        info = {"relres": relres, "max_relres": float(relres.max()),
                "timings": dict(self.timings), "unconverged": unconverged}
        return X, info

    def _residual(self, P, j, Xj):
        """Exact complex128 equilibrated residual [n+1, l] of shift j; the
        product L(z_j)·X_j in the native multithreaded CSR SpMM, as the
        JAX package's ``_resid_matvec``."""
        R = np.zeros((self.n + 1, Xj.shape[1]), np.complex128)
        LX = native.csr_spmm(self._indptr, self._indices64, P["data"][j], Xj)
        R[:self.n] = (P["b"][j] - LX) * P["srow"][j][:, None]
        return R

    def _solve_chunks(self, bounds, chunk_inputs, fut, pool, X, relres, l,
                      output):
        tm = self.timings
        for ci, (s0, s1, chunk) in enumerate(bounds):
            t_w0 = time.perf_counter()
            P = fut.result()
            t_wait = time.perf_counter() - t_w0
            if ci + 1 < len(bounds):
                fut = pool.submit(self._prep_chunk,
                                  *chunk_inputs(*bounds[ci + 1]))
            bnorm = P["bnorm"]
            t1 = time.perf_counter()
            best, fact = self._factor_solve_chunk(P["dpad"], P["bsc"])
            t2 = time.perf_counter()
            # exact c128 residuals in the equilibrated norm + refinement
            R = np.empty_like(P["bsc"])
            best_res = np.empty((chunk, l))
            for j in range(chunk):
                R[j] = self._residual(P, j, best[j])
                best_res[j] = np.linalg.norm(R[j], axis=0) / bnorm[j]
            t3 = time.perf_counter()
            prev_max = np.inf
            # each iteration is 2 sweeps (complex64 device residual
            # between them, see _double_resolve_pass)
            for sweep in range(-(-self.refine_sweeps // 2)):
                cur_max = float(best_res.max())
                if output:
                    print(f"slab refine sweep {sweep}: max relres "
                          f"{cur_max:.3e}")
                if cur_max < self.refine_tol or cur_max > 0.25 * prev_max:
                    break
                prev_max = cur_max
                # adaptive depth: each sweep gains ~κ·ε_f32 ≈ 1e-3, so when
                # one sweep lands refine_tol the second would be wasted
                if cur_max < self.refine_tol * 1e3:
                    dX = self._resolve_chunk(fact, R)
                else:
                    dX = self._double_resolve_chunk(fact, R)
                t_h0 = time.perf_counter()
                cand = best + dX
                for j in range(chunk):
                    Rc = self._residual(P, j, cand[j])
                    rc = np.linalg.norm(Rc, axis=0) / bnorm[j]
                    upd = rc < best_res[j]
                    best[j][:, upd] = cand[j][:, upd]
                    best_res[j][upd] = rc[upd]
                    R[j][:, upd] = Rc[:, upd]
                tm["refine_host_resid_s"] = (
                    tm.get("refine_host_resid_s", 0.0)
                    + time.perf_counter() - t_h0)
            # drop the inverses before the next chunk factorizes, so two
            # chunks' inverses never coexist on the device
            del fact
            t4 = time.perf_counter()
            # prep_s = worker-thread wall; prep_wait_s = the un-hidden
            # remainder the main loop actually blocked on
            tm["prep_s"] += P["prep_s"]
            tm["prep_wait_s"] = tm.get("prep_wait_s", 0.0) + t_wait
            tm["device_s"] += (t2 - t1) + (t4 - t3)
            tm["device_factor_s"] = tm.get("device_factor_s", 0.0) + (t2 - t1)
            tm["device_refine_s"] = tm.get("device_refine_s", 0.0) + (t4 - t3)
            tm["residual_s"] += t3 - t2
            if output:
                print(f"slab chunk [{s0}:{s1}]: prep {P['prep_s']:.1f}s "
                      f"(waited {t_wait:.1f}s)  factor+bwd {t2 - t1:.1f}s  "
                      f"residual {t3 - t2:.1f}s  refine {t4 - t3:.1f}s")
            X[s0:s1] = best[:s1 - s0]
            relres[s0:s1] = best_res[:s1 - s0]


__all__ = ["bfs_levels", "SlabPartition", "SlabSolver", "SLAB_BUDGET",
           "auto_chunk", "family_coefficients"]
