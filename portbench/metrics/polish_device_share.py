"""polish_device_share: the share of the window's polish steps whose
factor of L(z) ran on the device (counter ``polish.factor``: key
``device`` over all its keys, ``host`` besides).  Program counter."""

COUNTER = "polish.factor"


def read(run):
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    if not hasattr(timing, "counts"):
        return None
    counts = timing.counts(COUNTER)
    total = sum(counts.values())
    return counts.get("device", 0) / total if total else None
