"""factor_graph_share: the share of the window's slab factors that were
replays of the engine's captured CUDA graph (counter
``fused_slab.factor``: key ``replay`` over all its keys, ``capture`` and
``eager`` besides).  Program counter."""

COUNTER = "fused_slab.factor"


def read(run):
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    if not hasattr(timing, "counts"):
        return None
    counts = timing.counts(COUNTER)
    total = sum(counts.values())
    return counts.get("replay", 0) / total if total else None
