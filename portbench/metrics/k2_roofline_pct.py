"""k2_roofline_pct: kernel K2 (``dense_gmres_kernel``, the dense engine's
GMRES) — the sum over the launches the program counted in the traced
requests (counter ``dense_gmres.launches``, keyed by the launch shape
(S, N, m, cycles)) of the bound time at each launch's shape, over K2's
summed device time in the trace, in percent.  Nothing where the counter
carries no shape.  Device trace."""
from portbench.roofline import bound_s
from portbench.roofline_k2 import dense_gmres_work

KERNEL = "dense_gmres_kernel"


def read(run):
    if run.trace is None:
        return None
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    ks = run.trace.kernels(KERNEL)
    if not ks or not hasattr(timing, "counts"):
        return None
    traced = [s.request for s in timing.spans()
              if s.id == s.request and s.traced]
    launches = timing.counts("dense_gmres.launches", request=traced)
    if not launches or None in launches:
        return None
    bound = sum(n * bound_s(*dense_gmres_work(*shape))
                for shape, n in launches.items())
    return 100.0 * bound / (sum(d for _, _, d in ks) * 1e-6)
