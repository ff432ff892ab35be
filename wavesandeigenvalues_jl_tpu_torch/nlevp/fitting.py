"""State-space fitting of measured frequency responses (vector fitting).

Host numpy, copied from the JAX package's ``nlevp/fitting.py``.  The
reference stubs this workflow (fit_ss commented out of
src/NLEVP/algebra.jl:2 and NLEVP_exports.jl:17, empty
tutorial_11_experimental_data.jl); what it *does* ship is the state-space
coefficient function C(iωI−A)⁻¹B + D (`generate_stsp_z`) that a fitted
model plugs into.  This module closes the loop: fit measured FTF /
admittance samples to a rational model with the vector-fitting algorithm
(Gustavsen & Semlyen 1999) and emit the matching `StateSpace` coefficient
function — analytic ω-derivatives included, so the fitted model works in
every solver and in perturbation theory.

    freqs, data = ...                      # measured FTF(ω) samples
    ss = fit_state_space(freqs, data, order=6)
    dscrp["Flame"] = ("flame", (γ, ρ, Q02U0, x_ref, n_ref, ss))
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .algebra import StateSpace, generate_stsp_z


def _vf_iteration(s, f, poles, weights):
    """One vector-fitting pole-relocation step: solve for the residues of
    σ(s)·f(s) and σ(s), then new poles = zeros of σ (eigenvalues of the
    relocated companion matrix)."""
    N = len(poles)
    M = len(s)
    # basis: [1/(s-p_k)..., 1, s] for f-residues, [1/(s-p_k)...] for sigma
    A = np.zeros((M, 2 * N + 2), dtype=np.complex128)
    for k, p in enumerate(poles):
        A[:, k] = 1.0 / (s - p)
        A[:, N + 2 + k] = -f / (s - p)
    A[:, N] = 1.0
    A[:, N + 1] = s
    Aw = A * weights[:, None]
    bw = f * weights
    # complex least squares: residues may be genuinely complex (the model
    # is only required to match the sampled ω-band, not to be a
    # real-coefficient system — same contract as generate_stsp_z)
    x, *_ = np.linalg.lstsq(Aw, bw, rcond=None)
    sigma_res = x[N + 2:]
    # zeros of sigma: eig(diag(poles) - ones * sigma_res)
    H = np.diag(poles) - np.outer(np.ones(N), sigma_res)
    return np.linalg.eigvals(H)


def _enforce_stable(poles):
    """Flip unstable poles into the left half of the s-plane."""
    return np.where(poles.real > 0, -poles.real + 1j * poles.imag, poles)


def fit_state_space(freqs, data, order: int = 4, n_iter: int = 12,
                    weights: Optional[np.ndarray] = None,
                    strictly_proper: bool = False
                    ) -> Tuple[StateSpace, np.ndarray]:
    """Fit samples ``data[j] ≈ F(i·2π·freqs[j])`` with a stable rational
    model of the given order by vector fitting; returns the ready-to-use
    :class:`~.algebra.StateSpace` coefficient function (call it as
    F(ω, k) for the k-th ω-derivative) and the fitted values at the
    sample points.

    ``freqs`` are in Hz (the model lives in s = iω = i·2πf);
    ``strictly_proper`` drops the constant/linear terms (D = 0)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    f = np.asarray(data, dtype=np.complex128)
    s = 2j * np.pi * freqs
    if weights is None:
        weights = np.ones(len(s))
    weights = np.asarray(weights, dtype=np.float64)

    # initial poles: spread over the sample band, well damped (a smooth,
    # well-conditioned starting basis; relocation sharpens them if the
    # data warrants it)
    wmin = 2 * np.pi * max(freqs.min(), 1e-3)
    wmax = 2 * np.pi * freqs.max()
    n_pair = order // 2
    betas = np.linspace(wmin, wmax, max(n_pair, 1))
    poles = []
    for b in betas[:n_pair]:
        poles += [(-0.5 + 1j) * b, (-0.5 - 1j) * b]
    if order % 2:
        poles.append(-wmax / 2)
    poles = np.asarray(poles, dtype=np.complex128)

    def residue_solve(poles):
        N = len(poles)
        ncol = N + (0 if strictly_proper else 1)
        A = np.zeros((len(s), ncol), dtype=np.complex128)
        for k, p in enumerate(poles):
            A[:, k] = 1.0 / (s - p)
        if not strictly_proper:
            A[:, N] = 1.0
        Aw = A * weights[:, None]
        x, *_ = np.linalg.lstsq(Aw, f * weights, rcond=None)
        resid = np.linalg.norm((A @ x - f) * weights)
        return x, resid

    # pole relocation; plain VF can diverge on noisy data, so keep the
    # pole set with the smallest true fit residual seen (incl. the start)
    best_poles, (best_x, best_res) = poles, (None, np.inf)
    x, res = residue_solve(poles)
    best_poles, best_x, best_res = poles, x, res
    for _ in range(n_iter):
        new = _enforce_stable(_vf_iteration(s, f, poles, weights))
        converged = np.allclose(np.sort_complex(new),
                                np.sort_complex(poles), rtol=1e-10, atol=0)
        poles = new
        x, res = residue_solve(poles)
        if res < best_res:
            best_poles, best_x, best_res = poles, x, res
        if converged:
            break
    poles, x = best_poles, best_x

    N = len(poles)
    residues = x[:N].astype(np.complex128)
    D = complex(x[N]) if not strictly_proper else 0.0

    # realize as a (complex-diagonal) state space: A=diag(poles), B=1,
    # C=residues — generate_stsp_z builds C(iωI−A)⁻¹B + D with analytic
    # ω-derivatives of every order
    Ass = np.diag(poles)
    Bss = np.ones((N, 1), dtype=np.complex128)
    Css = residues.reshape(1, N)
    ss = generate_stsp_z(Ass, Bss, Css, D)
    fitted = np.array([ss.eval((w,), (0,)) for w in s / 1j])
    return ss, fitted


__all__ = ["fit_state_space"]
