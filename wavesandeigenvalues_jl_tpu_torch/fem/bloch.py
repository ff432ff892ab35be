"""Bloch-periodic operator reduction for annular unit-cell meshes (host
numpy, copied from the JAX package's ``fem/bloch.py``).

``blochify`` splits each assembled COO stream into up to 6 matrix classes
(src/Bloch.jl:4-112) by whether the row/column DOF lives on the Bloch
image plane (remapped to the reference plane with a phase) and whether it
touches the center axis:

    interior          · 1
    +shift            · exp(+i b Δϕ)
    −shift            · exp(−i b Δϕ)
    interior (axis)   · δ(b)
    +shift  (axis)    · δ(b)·exp(+i b Δϕ)
    −shift  (axis)    · δ(b)·exp(−i b Δϕ)

where δ(b) is the DFT wavenumber filter (axis DOFs are shared by all
sectors and only couple at b ≡ 0 mod DOS) and Δϕ = 2π/DOS.  For b ≠ 0 the
axis DOFs get an essential-BC penalty diagonal (1−δ(b))·D
(Helmholtz.jl:541-568).  The JAX package reads D's diagonal from a dense
copy of the mass matrix; here it is read from the CSR (the same numbers,
without the O(n²) host memory).

Vectorized: the classification of all COO entries is a handful of
numpy masks, not a per-entry loop."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..mesh.core import Mesh
from ..nlevp.algebra import ExpAz, OneMinus, Product, SumYExpIKX
from ..nlevp.family import Term
from ..ops.sparse import CSR
from ..utils.config import CDTYPE


class BlochContext:
    """Bookkeeping for Bloch-reduced assembly on a unit-cell mesh
    (wraps the symmetry metadata exactly as Helmholtz.jl:82-118)."""

    def __init__(self, mesh: Mesh, order: str, b: str):
        if mesh.dos is None or not mesh.dos.unit:
            raise ValueError("Bloch assembly needs a unit-cell mesh from "
                             "extend_mesh(..., unit=True)")
        dos = mesh.dos
        self.mesh = mesh
        self.order = order
        self.b = b
        self.DOS = dos.DOS
        self.naxis = dos.naxis
        self.nxbloch = dos.nxbloch
        self.nsector = dos.naxis + dos.nxsector
        self.N_points = mesh.n_points
        # line-DOF boundaries in GLOBAL dof numbering (Helmholtz.jl:87-88)
        self.naxis_ln = dos.naxis_ln + self.N_points
        self.nsector_ln = dos.naxis_ln + dos.nxsector_ln + self.N_points
        self.nxbloch_ln = dos.nxbloch_ln
        dphi = 2 * np.pi / dos.DOS
        self.exp_plus = ExpAz(1j * dphi)
        self.exp_minus = ExpAz(-1j * dphi)
        y = np.zeros(dos.DOS, complex)
        y[0] = 1.0 / dos.DOS
        self.bloch_filt = SumYExpIKX(np.fft.fft(y))
        self.anti_bloch_filt = OneMinus(self.bloch_filt)
        self.bloch_exp_plus = Product(self.bloch_filt, self.exp_plus)
        self.bloch_exp_minus = Product(self.bloch_filt, self.exp_minus)
        self._suffixes = [
            ((), (), ""),
            ((self.exp_plus,), ((b,),), f"*exp(i{b}2π/{dos.DOS})"),
            ((self.exp_minus,), ((b,),), f"*exp(-i{b}2π/{dos.DOS})"),
            ((self.bloch_filt,), ((b,),), f"*δ({b})"),
            ((self.bloch_exp_plus,), ((b,),), f"*δ({b})*exp(i{b}2π/{dos.DOS})"),
            ((self.bloch_exp_minus,), ((b,),),
             f"*δ({b})*exp(-i{b}2π/{dos.DOS})"),
        ]

    def reduced_dim(self, dim: int) -> int:
        if self.order == "lin":
            return dim - self.nxbloch
        if self.order == "quad":
            return dim - self.nxbloch - self.nxbloch_ln
        raise ValueError(f"Bloch reduction not defined for order {self.order}")

    # -- core splitting (Bloch.jl:4-112, 0-based) ---------------------------
    def _split(self, rows, cols, vals, axis: bool = True):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, CDTYPE)
        Np = self.N_points
        blochshift = self.nsector - self.naxis
        blochshift_ln = self.nsector_ln - self.naxis_ln

        def remap(idx):
            is_pnt = idx < Np
            chk = np.where(is_pnt, idx >= self.nsector, idx >= self.nsector_ln)
            out = np.where(chk, idx - np.where(is_pnt, blochshift,
                                               blochshift_ln), idx)
            return out, chk

        i, i_chk = remap(rows)
        j, j_chk = remap(cols)
        if axis:
            axis_chk = ((i < self.naxis) | (j < self.naxis)
                        | ((Np <= i) & (i < self.naxis_ln))
                        | ((Np <= j) & (j < self.naxis_ln)))
        else:
            axis_chk = np.zeros(len(i), bool)
        # account for removed bloch-image point DOFs in line-DOF numbering
        i = np.where(i >= Np, i - self.nxbloch, i)
        j = np.where(j >= Np, j - self.nxbloch, j)

        plain = ~i_chk & ~j_chk | (i_chk & j_chk)
        plus = ~i_chk & j_chk
        minus = i_chk & ~j_chk
        masks = [plain & ~axis_chk, plus & ~axis_chk, minus & ~axis_chk,
                 plain & axis_chk, plus & axis_chk, minus & axis_chk]
        return [(i[m], j[m], vals[m]) for m in masks]

    def blochify(self, rows, cols, vals):
        """COO stream -> list of (triplets, func-suffix, arg-suffix,
        txt-suffix) for the up-to-6 Bloch terms."""
        streams = self._split(rows, cols, vals, axis=True)
        n_take = 6 if self.naxis > 0 else 3
        return [(streams[k],) + self._suffixes[k] for k in range(n_take)]

    def blochify_weight(self, rows, cols, vals):
        """Splitting without the axis classes — used for the __aux__ mass
        weighting (Helmholtz.jl:545-549)."""
        s = self._split(rows, cols, vals, axis=False)
        return s[0], s[1], s[2]

    def axis_penalty(self, M: CSR, dim: int) -> Optional[Term]:
        """(1−δ(b))·D essential-BC penalty on axis DOFs for b ≠ 0
        (Helmholtz.jl:551-568): D has 1/M[ii] at axis point (and axis
        line, for quad) diagonal entries."""
        if self.naxis == 0:
            return None
        di = list(range(self.naxis))
        if self.order == "quad":
            di += list(range(self.N_points - self.nxbloch,
                             self.naxis_ln - self.nxbloch))
        di = np.asarray(di, np.int64)
        # M's diagonal from the CSR (its entries are unique per (i, j))
        rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
        on = rows == M.indices
        diag = np.zeros(M.shape[0], CDTYPE)
        diag[rows[on]] = M.data[on]
        dg = diag[di]
        # reduced re-assembly (shape sensitivity) can leave axis DOFs with
        # zero mass — no penalty contribution there instead of 1/0
        dv = np.where(dg != 0, 1.0 / np.where(dg != 0, dg, 1.0), 0.0)
        D = CSR.from_coo(di, di, dv.astype(CDTYPE), (dim, dim))
        return Term(D, (self.anti_bloch_filt,), ((self.b,),),
                    f"(1-δ({self.b}))", "D")


__all__ = ["BlochContext"]
