"""k3_roofline_pct.counted: kernel K3 (``slab_thomas_kernel``) — the sum
over the launches the program counted in the traced requests (counter
``slab_thomas.launches``, keyed by the shape (sides, m, s)) of the bound
time at each launch's shape, over K3's summed device time in the trace,
in percent.  Device trace."""
from portbench.roofline import bound_s, slab_thomas_work

KERNEL = "slab_thomas"


def read(run):
    if run.trace is None:
        return None
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    ks = run.trace.kernels(KERNEL)
    if not ks or not hasattr(timing, "counts"):
        return None
    traced = [s.request for s in timing.spans()
              if s.id == s.request and s.traced]
    launches = timing.counts("slab_thomas.launches", request=traced)
    if not launches:
        return None
    bound = sum(n * bound_s(*slab_thomas_work(*shape))
                for shape, n in launches.items())
    return 100.0 * bound / (sum(d for _, _, d in ks) * 1e-6)
