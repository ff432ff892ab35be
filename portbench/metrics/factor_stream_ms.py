"""factor_stream_ms: mean stream time of the device step's ``factor``
span (solve data, row equilibration, scatter and the block-Thomas factor
loop; CUDA events on the stream) in the window's untraced requests, so
that the profiler's cost is left out.  Program span."""

FACTOR = "fused_local.device_step.factor"


def read(run):
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    if not hasattr(timing, "spans"):
        return None
    spans = timing.spans()
    untraced = {s.request for s in spans if s.id == s.request
                and not s.traced}
    ms = [s.device_ms for s in spans if s.path == FACTOR
          and s.request in untraced and s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
