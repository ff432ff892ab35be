"""polish_steps_per_mode: mean number of host polish steps of the
window's converged requests (attribute ``polish_steps`` of the program's
request spans with ``flag`` 0).  Program counter."""


def read(run):
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    if not hasattr(timing, "spans"):
        return None
    steps = [s.attrs["polish_steps"] for s in timing.spans()
             if s.id == s.request and s.attrs.get("flag") == 0
             and "polish_steps" in s.attrs]
    return sum(steps) / len(steps) if steps else None
