"""device_idle_pct.step: share of the traced requests' device Newton
steps (the program's ``fused_local.device_step`` spans, on the trace's
clock) in which no kernel, copy or set ran on the card.  Device trace."""
from bisect import bisect_right

STEP = "fused_local.device_step"


def read(run):
    if run.trace is None:
        return None
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    if not hasattr(timing, "spans"):
        return None
    spans = timing.spans()
    traced = {s.request for s in spans if s.id == s.request and s.traced}
    steps = [(s.start, s.end) for s in spans if s.path == STEP
             and s.request in traced and s.end is not None]
    if not steps:
        return None
    merged = []                     # union of the device operations
    for t0, t1 in sorted((t, t + d) for _, t, d in run.trace.device_ops):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    starts = [m[0] for m in merged]
    wall = busy = 0.0
    for a, b in steps:
        wall += b - a
        j = max(bisect_right(starts, a) - 1, 0)
        while j < len(merged) and merged[j][0] < b:
            busy += max(0.0, min(b, merged[j][1]) - max(a, merged[j][0]))
            j += 1
    return 100.0 * (1.0 - busy / wall) if wall > 0 else None
