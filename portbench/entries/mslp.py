"""One local eigen-solve a request: the program's ``nlevp.mslp`` from the
request's start ``z0`` at its parameters (``solver`` of the mix passes
as keywords).

Judged on a sample drawn from the seed, by three numbers of the
reference: ``omega_gap`` |ω − ω_ref|/|ω_ref|, with ω_ref the reference's
complex128 Newton iteration started at the answer; ``resid`` the
row-equilibrated residual of the answer's (ω, v) in the reference's
L(ω); ``family`` the largest row-relative entry gap between the
program's L(ω) and the reference's.  The control is the reference's
Newton iteration from ``z0`` in complex64 in the program's place.

A request's ``engine`` is the class of the program's fused local solver
when both its device steps and its host polish ran (the
``fused_local.device_step`` and ``fused_local.polish_step`` phase counts
rose), and ``"general"`` when the program handed the solve to its
general local engine.
"""
from __future__ import annotations

import numpy as np

from ..reference.solve import family_gap, newton, residual
from .common import port_matrix, port_params, sample, worst

NUMBERS = ("omega_gap", "resid", "family")


def _params(ctx, req):
    return {k: req[k] for k in ctx.problem.PORT_NAMES if k in req}


FUSED_PHASES = ("fused_local.device_step", "fused_local.polish_step")


def _calls(timing) -> list:
    report = timing.report()
    return [report.get(k, {}).get("calls", 0) for k in FUSED_PHASES]


def run(ctx, req: dict) -> dict:
    from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    params = _params(ctx, req)
    port_params(ctx, params)
    before = _calls(timing)
    sol, n_it, flag = mslp(ctx.L, req["z0"], device=ctx.device,
                           **ctx.mix["solver"])
    fused = all(b > a for a, b in zip(before, _calls(timing)))
    om = complex(sol.params[sol.eigval])
    ok = flag == 0 and bool(np.isfinite(om))
    return {"ok": ok, "modes": int(ok), "omega": om, "v": sol.v,
            "params": params, "flag": int(flag), "iterations": int(n_it),
            "engine": (type(ctx.L._fused_solver[1]).__name__ if fused
                       else "general")}


warm = run


def control(ctx, req: dict) -> dict:
    """The reference in complex64, from the request's start."""
    params = _params(ctx, req)
    z0 = req["z0"] * ctx.mix["solver"].get("scale", 1.0)
    om, v, ok = newton(ctx.R, z0, params, tol=ctx.mix["solver"]["tol"]
                       / abs(z0), maxiter=ctx.mix["solver"]["maxiter"],
                       dtype=np.complex64)
    return {"ok": ok, "modes": int(ok), "omega": om, "v": v,
            "params": params, "latency_s": 0.0}


def control_matrix(ctx):
    """The control's L(ω): the reference's, in complex64."""
    return lambda om, p: ctx.R.matrix(om, p).astype(np.complex64)


def judge(ctx, records: list, rng, matrix=None) -> dict:
    """The compared numbers over a sample of the answers; ``matrix(ω,
    params)`` is the answering side's L(ω) (the program's by default)."""
    matrix = matrix or (lambda om, p: port_matrix(ctx, om, p))
    picked = sample(records, ctx.mix["check"]["sample"], rng)
    gaps, res, fam, rows = [], [], [], []
    for r in picked:
        om, p = r["omega"], r["params"]
        A_prog = matrix(om, p)
        A_ref = ctx.R.matrix(om, p)
        fam.append(family_gap(A_prog, A_ref))
        res.append(residual(A_ref, r["v"]))
        z, _, ok = newton(ctx.R, om, p, tol=1e-13)
        gaps.append(abs(om - z) / abs(z) if ok else np.inf)
        rows.append(f"{p} omega {om:.12g}: omega_gap {gaps[-1]:.3e} "
                    f"resid {res[-1]:.3e} family {fam[-1]:.3e}")
    return {"omega_gap": worst(gaps), "resid": worst(res),
            "family": worst(fam), "_checked": len(picked), "_rows": rows}
