"""Structured per-phase timing and the device trace.

``phase("name")`` accumulates wall time per phase into a process-global
registry (nested phases get dotted paths) and, while CUDA is initialised,
pushes an NVTX range of the same name so the phase shows up on a profiler
timeline next to the kernels it launched; while a device trace is being
captured it also records a ``torch.profiler`` range of that name.
``report()`` returns the table, ``format_report()`` formats it,
``reset()`` clears it.  Host wall time only: a phase that enqueues device
work without synchronising measures the enqueue.
``start_device_trace(logdir)`` / ``stop_device_trace()`` capture a
``torch.profiler`` trace (host operations and, on a card, its kernels
through CUPTI) and write it as a Chrome trace JSON into ``logdir``.
``device_ms(fn)`` is
the device time of one call of ``fn``, from CUDA-graph replays;
``events_ms(fn)`` the same from CUDA events around calls made back to
back, for calls that graph capture refuses.
"""
from __future__ import annotations

import os
import statistics
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

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
    span = None
    if _trace is not None:
        span = torch.profiler.record_function(path)
        span.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if span is not None:
            span.__exit__(None, None, None)
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


def format_report() -> str:
    rows = report()
    if not rows:
        return "(no phases recorded)"
    w = max(len(k) for k in rows)
    lines = [f"{'phase':<{w}}  {'total [s]':>10}  {'calls':>6}  "
             f"{'mean [ms]':>10}"]
    for k, v in rows.items():
        lines.append(f"{k:<{w}}  {v['total_s']:>10.4f}  {v['calls']:>6d}  "
                     f"{v['mean_s']*1e3:>10.3f}")
    return "\n".join(lines)


#: the running capture: (profiler, logdir), or None
_trace: Optional[tuple] = None


def start_device_trace(logdir: str) -> str:
    """Begin capturing a ``torch.profiler`` trace: host operations, and
    the card's kernels and copies (CUDA activity) where a card is
    present."""
    global _trace
    if _trace is not None:
        raise RuntimeError(f"a device trace into {_trace[1]} is running")
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _trace = (prof, logdir)
    return logdir


def stop_device_trace() -> str:
    """End the capture and write it into its ``logdir`` as a Chrome trace
    JSON; returns the file's path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no device trace is running")
    (prof, logdir), _trace = _trace, None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


__all__ = ["phase", "report", "reset", "format_report", "start_device_trace",
           "stop_device_trace", "device_ms", "events_ms"]


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
