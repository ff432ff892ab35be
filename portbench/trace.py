"""Reading a traced window from the profiler's Chrome trace.

The program's ``utils.timing.start_device_trace`` / ``stop_device_trace``
capture host operations and the card's kernels (CUPTI) and write them as
a Chrome trace; its ``phase`` ranges appear there as user annotations,
as do the harness's ``portbench.request`` ranges around each traced
request.  :func:`summarize` reduces the file to what the per-layer
readers and the ``breakdown`` need: the device operations, their union
(busy time) inside the traced window, and the idle gaps, each labelled
with the innermost annotation open at its midpoint.
"""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field

#: Chrome-trace categories of operations that run on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REQUEST_RANGE = "portbench.request"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: (name, start_us, duration_us) of every device operation in the window
    device_ops: list = field(default_factory=list)
    #: idle seconds by the host range open at the time
    idle_by_label: dict = field(default_factory=dict)

    def kernels(self, substring: str) -> list:
        return [(n, t, d) for n, t, d in self.device_ops if substring in n]

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for n, _, d in self.device_ops:
            by_name[n] += d * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def summarize(path: str) -> TraceSummary:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, ann = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((e.get("name", "?"), t0, dur))
        elif cat == "user_annotation":
            ann.append((t0, t0 + dur, e.get("name", "?")))
    del events
    reqs = [a for a in ann if a[2] == REQUEST_RANGE]
    if not reqs:
        raise ValueError(f"{path}: no {REQUEST_RANGE} range in the trace")
    w0, w1 = min(a[0] for a in reqs), max(a[1] for a in reqs)
    inside = []
    for n, t0, d in dev:
        a, b = max(t0, w0), min(t0 + d, w1)
        if b > a:
            inside.append((n, a, b - a))
    # union of the device intervals, and the gaps between them
    busy, gaps, cur_end = 0.0, [], w0
    for _, a, d in sorted(inside, key=lambda x: x[1]):
        b = a + d
        if a > cur_end:
            gaps.append((cur_end, a))
        if b > cur_end:
            busy += b - max(a, cur_end)
            cur_end = b
    if w1 > cur_end:
        gaps.append((cur_end, w1))
    # the innermost range open at each gap's midpoint: a sweep with a
    # stack of open ranges (the host ranges of one thread nest)
    ann.sort()
    idle, stack, i = defaultdict(float), [], 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while i < len(ann) and ann[i][0] <= mid:
            while stack and stack[-1][1] < ann[i][0]:
                stack.pop()
            stack.append(ann[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "outside any range"
        idle[label] += (g1 - g0) * 1e-6
    return TraceSummary((w1 - w0) * 1e-6, busy * 1e-6, inside, dict(idle))


__all__ = ["TraceSummary", "summarize", "DEVICE_CATS", "REQUEST_RANGE"]
