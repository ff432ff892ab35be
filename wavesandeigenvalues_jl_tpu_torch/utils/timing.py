"""Structured per-phase timing.

``phase("name")`` accumulates wall time per phase into a process-global
registry (nested phases get dotted paths) and, while CUDA is initialised,
pushes an NVTX range of the same name so the phase shows up on a profiler
timeline next to the kernels it launched.  ``report()`` returns the table,
``reset()`` clears it.  Host wall time only: a phase that enqueues device
work without synchronising measures the enqueue.  ``device_ms(fn)`` is
the device time of one call of ``fn``, from CUDA-graph replays;
``events_ms(fn)`` the same from CUDA events around calls made back to
back, for calls that graph capture refuses.
"""
from __future__ import annotations

import statistics
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch

_lock = threading.Lock()
_times: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_stack = threading.local()


@contextmanager
def phase(name: str):
    """Accumulate wall time under ``name`` (dotted path when nested)."""
    parts = getattr(_stack, "parts", None)
    if parts is None:
        parts = _stack.parts = []
    parts.append(name)
    path = ".".join(parts)
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(path)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if nvtx:
            torch.cuda.nvtx.range_pop()
        parts.pop()
        with _lock:
            _times[path] += dt
            _counts[path] += 1


def report() -> Dict[str, Dict[str, float]]:
    """{phase_path: {total_s, calls, mean_s}} accumulated so far."""
    with _lock:
        return {k: {"total_s": _times[k], "calls": _counts[k],
                    "mean_s": _times[k] / max(_counts[k], 1)}
                for k in sorted(_times)}


def reset():
    with _lock:
        _times.clear()
        _counts.clear()


__all__ = ["phase", "report", "reset", "device_ms", "events_ms"]


def device_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn`` (ms): the median over ``reps``
    replays of a CUDA graph of ``n`` calls, over n.  It leaves out the
    host's time between calls, which exceeds a kernel's own for
    microsecond kernels.  ``fn`` must be capturable: no host sync and no
    first-call set-up (three calls on a side stream come first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def events_ms(fn, n: int = 20) -> float:
    """Time of one call of ``fn`` (ms) from CUDA events around ``n`` calls
    made back to back, after 3 warm-up calls: the device time where the
    calls queue faster than they run."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n
