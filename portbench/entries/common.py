"""What the entries share: the program's matrix at a point, the sample of
answers to judge."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def port_params(ctx, params: dict) -> None:
    """Set a request's parameters on the program's family."""
    for k, v in params.items():
        ctx.L.params[ctx.problem.PORT_NAMES[k]] = v


def port_matrix(ctx, omega, params: dict) -> sp.csr_matrix:
    """The program's L(ω) at ``params`` (auxiliary λ = 0), as SciPy CSR."""
    port_params(ctx, params)
    ctx.L.params[ctx.L.auxval] = 0.0
    A = ctx.L(complex(omega))
    return sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)


def sample(records: list, k: int, rng) -> list:
    """Up to k answered records drawn by ``rng``, the slowest always in."""
    ok = [r for r in records if r["ok"]]
    if len(ok) <= k:
        return ok
    slow = max(range(len(ok)), key=lambda i: ok[i]["latency_s"])
    rest = [i for i in range(len(ok)) if i != slow]
    pick = rng.choice(len(rest), size=k - 1, replace=False)
    return [ok[slow]] + [ok[rest[i]] for i in sorted(pick)]


def worst(values) -> float:
    vals = [float(v) for v in values]
    if not vals:
        return float("inf")
    return float(max(v if np.isfinite(v) else np.inf for v in vals))


__all__ = ["port_params", "port_matrix", "sample", "worst"]
