"""device_steps_per_mode: mean number of device Newton steps of the
window's converged requests (attribute ``device_steps`` of the program's
request spans with ``flag`` 0).  Program counter."""


def read(run):
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    if not hasattr(timing, "spans"):
        return None
    steps = [s.attrs["device_steps"] for s in timing.spans()
             if s.id == s.request and s.attrs.get("flag") == 0
             and "device_steps" in s.attrs]
    return sum(steps) / len(steps) if steps else None
