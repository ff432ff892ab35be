"""k3_roofline_pct: kernel K3 (``slab_thomas_kernel``, the block-Thomas
substitution) — the sum over its launches in the traced requests of the
bound time at the partition's shape (2, m, s), over its summed device
time, in percent.  Device trace; the shape is read from the program's
slab engine."""
from portbench.roofline import bound_s, slab_thomas_work

KERNEL = "slab_thomas"


def read(run):
    if run.trace is None:
        return None
    ks = run.trace.kernels(KERNEL)
    solver = getattr(run.ctx.L, "_fused_solver", None)
    if not ks or solver is None or not hasattr(solver[1], "part"):
        return None
    m, s = solver[1].m, solver[1].s
    device_s = sum(d for _, _, d in ks) * 1e-6
    return 100.0 * len(ks) * bound_s(*slab_thomas_work(2, m, s)) / device_s
