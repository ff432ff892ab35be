"""Structured per-phase timing, spans, counters and the device trace.

``phase("name")`` accumulates wall time per phase into a process-global
registry (nested phases get dotted paths) and, while CUDA is initialised,
pushes an NVTX range of the same name so the phase shows up on a profiler
timeline next to the kernels it launched; while a device trace is being
captured it also records a ``torch.profiler`` range of that name.
``report()`` returns the table, ``format_report()`` formats it.  Host wall
time only: a phase that enqueues device work without synchronising
measures the enqueue; ``phase(name, device=d)`` on a CUDA device ``d``
also times the stream between two pooled CUDA events
(:attr:`Span.device_ms`, resolved once the stream has passed them).

Every phase also appends a :class:`Span` record (ids, request, dotted
path, host start and end, attributes) to a bounded buffer: ``spans()``
returns the records, ``dropped()`` the number a full buffer refused.
``request(name)`` is a front door's span: outside any request it opens a
new one (its span id is the request id), inside one it is a child span;
its name never enters the dotted path.  ``annotate(**attrs)`` sets
attributes on the innermost open front door.  A span's host start and end
(:attr:`Span.start`, :attr:`Span.end`) lie on the time base of the last
device trace written, so they intersect that trace's events.
``count(name, n, key)`` adds to a counter, kept by key, and by request
for the requests whose root span the buffer kept; ``counts()`` and
``total()`` read it.
``reset()`` clears phases, spans and counters.

``start_device_trace(logdir)`` / ``stop_device_trace()`` capture a
``torch.profiler`` trace (host operations and, on a card, its kernels
through CUPTI) and write it as a Chrome trace JSON into ``logdir``.
``device_ms(fn)`` is
the device time of one call of ``fn``, from CUDA-graph replays;
``events_ms(fn)`` the same from CUDA events around calls made back to
back, for calls that graph capture refuses.
"""
from __future__ import annotations

import itertools
import os
import re
import statistics
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Union

import torch

_lock = threading.Lock()
_times: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_stack = threading.local()

#: most span records kept between two resets; later spans are dropped
SPAN_CAPACITY = 1 << 16
_spans: List["Span"] = []
_dropped = 0
_ids = itertools.count(1)
#: device spans whose end event the host has not yet read: (span, start
#: event, end event, device index), and the idle events by device index
_pending: list = []
_event_pool: Dict[int, list] = defaultdict(list)
#: counter totals by (name, key), and the same for each request whose
#: root span the buffer kept, by request id
_counters: Dict[tuple, int] = defaultdict(int)
_by_request: Dict[int, Dict[tuple, int]] = {}
#: CLOCK_REALTIME less the monotonic clock, and the last device trace's
#: time base (the Chrome trace's ``baseTimeNanoseconds``), in ns
_clock = [time.time_ns() - time.perf_counter_ns(), 0]
_BASE_RE = re.compile(rb'"baseTimeNanoseconds":\s*(\d+)')


class Span:
    """One phase or front door.  ``id`` is process-unique; ``parent`` the
    id of the span open around it (None at the top); ``request`` the id of
    its request's root span (None outside any request; a root has
    ``id == request``); ``path`` the dotted phase path (a front door's own
    name); ``traced`` whether a device trace was running at its start;
    ``device_ms`` the stream time of a device span on a CUDA device, else
    None."""
    __slots__ = ("id", "parent", "request", "name", "path", "t0", "t1",
                 "attrs", "device_ms", "traced")

    @property
    def start(self) -> float:
        """Host start, µs on the last device trace's time base."""
        return _trace_us(self.t0)

    @property
    def end(self) -> Optional[float]:
        """Host end (None while open), µs on the same base."""
        return None if self.t1 is None else _trace_us(self.t1)

    @property
    def wall_s(self) -> Optional[float]:
        return None if self.t1 is None else (self.t1 - self.t0) * 1e-9

    def __repr__(self):
        return (f"Span({self.id}, parent={self.parent}, "
                f"request={self.request}, {self.path!r}, "
                f"wall_s={self.wall_s}, attrs={self.attrs}, "
                f"device_ms={self.device_ms})")


def _trace_us(t_ns: int) -> float:
    return (t_ns + _clock[0] - _clock[1]) * 1e-3


def _state():
    st = _stack
    if not hasattr(st, "parts"):
        st.parts, st.open, st.fronts = [], [], []
    return st


def _open(st, name: str, path: str, front: bool) -> Span:
    global _dropped
    parent = st.open[-1] if st.open else None
    rec = Span()
    rec.id = next(_ids)
    rec.parent = None if parent is None else parent.id
    if parent is not None and parent.request is not None:
        rec.request = parent.request
    else:
        rec.request = rec.id if front else None
    rec.name, rec.path, rec.attrs = name, path, {}
    rec.t1 = rec.device_ms = None
    rec.traced = _trace is not None
    st.open.append(rec)
    with _lock:
        if len(_spans) < SPAN_CAPACITY:
            _spans.append(rec)
            if rec.id == rec.request:
                _by_request[rec.id] = defaultdict(int)
        else:
            _dropped += 1
    return rec


def _event(index: int):
    pool = _event_pool[index]
    return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


def _resolve(block: bool):
    """Store the stream time of every pending device span whose end event
    the stream has passed (with ``block``, of every one, waiting for it)."""
    with _lock:
        pending = _pending[:]
        del _pending[:]
    keep = []
    for rec, e0, e1, index in pending:
        if block:
            e1.synchronize()
        elif not e1.query():
            keep.append((rec, e0, e1, index))
            continue
        rec.device_ms = e0.elapsed_time(e1)
        _event_pool[index] += (e0, e1)
    if keep:
        with _lock:
            _pending.extend(keep)


@contextmanager
def _span(name: str, front: bool, device=None):
    st = _state()
    if not front:
        st.parts.append(name)
    path = ".".join(st.parts) if not front else name
    rec = _open(st, name, path, front)
    if front:
        st.fronts.append(rec)
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(path)
    ev = None
    if device is not None and torch.device(device).type == "cuda":
        index = torch.device(device).index
        if index is None:
            index = torch.cuda.current_device()
        ev = (_event(index), _event(index), index)
        ev[0].record(torch.cuda.current_stream(index))
    span = None
    t0 = time.perf_counter_ns()
    if _trace is not None:
        # the range's own start lies inside its (slow) entry: take the
        # middle, and the end after its exit
        span = torch.profiler.record_function(path)
        span.__enter__()
        t0 = (t0 + time.perf_counter_ns()) // 2
    rec.t0 = t0
    try:
        yield rec
    finally:
        if ev is not None:
            ev[1].record(torch.cuda.current_stream(ev[2]))
        if span is not None:
            span.__exit__(None, None, None)
        t1 = rec.t1 = time.perf_counter_ns()
        if nvtx:
            torch.cuda.nvtx.range_pop()
        st.open.pop()
        if front:
            st.fronts.pop()
        else:
            st.parts.pop()
        with _lock:
            if not front:
                _times[path] += (t1 - t0) * 1e-9
                _counts[path] += 1
            if ev is not None:
                _pending.append((rec, *ev))
            many = len(_pending) > 64
        if rec.id == rec.request or many:
            _resolve(block=rec.id == rec.request)


def phase(name: str, device=None):
    """Accumulate wall time under ``name`` (dotted path when nested) and
    record its :class:`Span` (yielded).  With a CUDA ``device`` the span
    also times that device's current stream."""
    return _span(name, False, device)


def request(name: str):
    """A front door's span (a context manager, or a decorator): a new
    request outside any, a child span inside one.  Its name does not enter
    the dotted path of the phases under it; :func:`annotate` sets its
    attributes."""
    return _span(name, True)


def annotate(**attrs):
    """Set attributes on the innermost open front door of this thread
    (nothing outside any)."""
    fronts = _state().fronts
    if fronts:
        fronts[-1].attrs.update(attrs)


def spans() -> List[Span]:
    """The span records since the last reset, in the order they opened
    (device spans resolved first)."""
    _resolve(block=True)
    with _lock:
        return list(_spans)


def dropped() -> int:
    """Spans a full buffer refused since the last reset."""
    return _dropped


def count(name: str, n: int = 1, key=None):
    """Add ``n`` to counter ``name`` (under ``key``), and to the open
    request's own count where the buffer kept that request's root span."""
    opened = _state().open
    req = opened[-1].request if opened else None
    k = (name, key)
    with _lock:
        _counters[k] += n
        own = _by_request.get(req)
        if own is not None:
            own[k] += n


def counts(name: str, *,
           request: Union[None, int, Iterable[int]] = None) -> dict:
    """{key: total} of counter ``name`` since the last reset; ``request``
    (an id, or several) keeps the counts made inside those requests (none
    for a request whose root span a full buffer refused)."""
    if isinstance(request, int):
        request = (request,)
    out: dict = defaultdict(int)
    with _lock:
        if request is None:
            tables = [_counters]
        else:
            tables = [_by_request[r] for r in set(request)
                      if r in _by_request]
        for table in tables:
            for (nm, key), n in table.items():
                if nm == name:
                    out[key] += n
    return dict(out)


def total(name: str, **scope) -> int:
    """Total of counter ``name`` over its keys (``scope`` as
    :func:`counts`)."""
    return sum(counts(name, **scope).values())


def report() -> Dict[str, Dict[str, float]]:
    """{phase_path: {total_s, calls, mean_s}} accumulated so far."""
    with _lock:
        return {k: {"total_s": _times[k], "calls": _counts[k],
                    "mean_s": _times[k] / max(_counts[k], 1)}
                for k in sorted(_times)}


def reset():
    """Clear the phases, the span records and the counters."""
    global _dropped
    with _lock:
        _times.clear()
        _counts.clear()
        _spans.clear()
        _counters.clear()
        _by_request.clear()
        del _pending[:]
        _dropped = 0


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
    # a first range under the profiler is slow to open: open one here
    with torch.profiler.record_function("timing.start_device_trace"):
        _clock[0] = time.time_ns() - time.perf_counter_ns()
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
    # the events' ts are µs of CLOCK_REALTIME less this base (absent in
    # older files, whose ts are absolute)
    with open(path, "rb") as f:
        m = _BASE_RE.search(f.read(1 << 16))
    _clock[1] = int(m.group(1)) if m else 0
    return path


__all__ = ["phase", "request", "annotate", "spans", "dropped", "Span",
           "count", "counts", "total", "report", "reset", "format_report",
           "start_device_trace", "stop_device_trace", "device_ms",
           "events_ms", "SPAN_CAPACITY"]


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
