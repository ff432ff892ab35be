"""The port's spans and counters (utils/timing): request spans of the front
doors, the sub-spans of the fused engine's device and polish steps, the
counter registry, the shared clock with the device trace, and the span
buffer.  On the CPU, with the slab engine forced on the 437-DOF active
Rijke tube as tests/test_torch_fused_slab.py does."""
import json

import numpy as np
import pytest
import torch

from wavesandeigenvalues_jl_tpu_torch.models.rijke import active_rijke_family
from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp, track_branch
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
    FusedSlabPencilSolver
from wavesandeigenvalues_jl_tpu_torch.utils import timing

from port_threads import one_thread  # noqa: F401

Z0 = 340 * 2 * np.pi
FUSED_PHASES = ("fused_local.device_step", "fused_local.polish_step")
STEP_PHASES = {f"fused_local.device_step{p}" for p in
               ("", ".coefficients", ".factor", ".solves", ".fetch")} | \
    {f"fused_local.polish_step{p}" for p in
     ("", ".assemble", ".lu", ".arnoldi", ".quotient")}


def _calls(report):
    return [report.get(k, {}).get("calls", 0) for k in FUSED_PHASES]


@pytest.fixture(scope="module")
def solved():
    """One sweep of one point (``track_branch`` around ``mslp``) and then
    one ``mslp`` of its own, the spans, report and counters of each."""
    L = active_rijke_family()
    L._fused_solver = (L._stack(), FusedSlabPencilSolver(L, "cpu"))
    timing.reset()
    track_branch(L, "n", [1.0], Z0, order=0, tol=1e-11, maxiter=30,
                 device="cpu")
    before = timing.report()
    sol, n_it, flag = mslp(L, Z0, maxiter=30, tol=1e-11, device="cpu")
    out = dict(L=L, spans=timing.spans(), before=before,
               after=timing.report(), flag=flag, n_it=n_it,
               twin=timing.counts("slab_thomas.twin_calls"),
               by_request={})
    for s in out["spans"]:
        if s.id == s.request:
            out["by_request"][s.id] = timing.counts(
                "slab_thomas.twin_calls", request=s.id)
    timing.reset()
    return out


def _roots(spans):
    return [s for s in spans if s.id == s.request]


def _mslps(spans):
    return [s for s in spans if s.name == "mslp"]


def test_request_ids_and_nesting(solved):
    """One request a front-door call; the mslp inside track_branch is a
    child span of its request; every span's parent is open around it."""
    spans = solved["spans"]
    by_id = {s.id: s for s in spans}
    roots = _roots(spans)
    assert [r.name for r in roots] == ["track_branch", "mslp"]
    assert all(r.parent is None for r in roots)
    inner = [s for s in spans if s.name == "mslp" and s.id != s.request]
    assert len(inner) == 1 and inner[0].parent == roots[0].id
    assert inner[0].request == roots[0].id
    for s in spans:
        assert s.request in {r.id for r in roots}
        assert s.t1 is not None and s.traced is False
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.request == s.request
            assert p.t0 <= s.t0 and s.t1 <= p.t1
            if s.path.startswith("fused_local.") and "." in s.path[12:]:
                # a sub-span's path extends its phase's, never a front door
                assert s.path.rsplit(".", 1)[0] == p.path
    # each request holds the steps of its one mslp
    for m in _mslps(spans):
        steps = [s for s in spans if s.request == m.request
                 and s.path == "fused_local.device_step"]
        assert len(steps) == m.attrs["device_steps"] >= 1


def test_report_keys_unchanged(solved):
    """The aggregate keeps its dotted paths: front doors never enter them,
    and the steps' sub-spans nest under ``fused_local.device_step`` and
    ``fused_local.polish_step``."""
    assert set(solved["after"]) == STEP_PHASES
    assert set(solved["before"]) == STEP_PHASES


def test_root_attributes_match_the_phase_counts(solved):
    """engine, flag, device_steps and polish_steps of the mslp request
    against the phase-count deltas portbench's mslp entry reads."""
    root = _roots(solved["spans"])[1]
    before, after = _calls(solved["before"]), _calls(solved["after"])
    fused = all(b > a for a, b in zip(before, after))
    engine = type(solved["L"]._fused_solver[1]).__name__ if fused \
        else "general"
    assert root.attrs["engine"] == engine == "FusedSlabPencilSolver"
    assert root.attrs["flag"] == solved["flag"] == 0
    assert root.attrs["device_steps"] == after[0] - before[0]
    assert root.attrs["polish_steps"] == after[1] - before[1]
    assert root.attrs["device_steps"] + root.attrs["polish_steps"] >= \
        solved["n_it"]


def test_k3_counter_keyed_by_shape(solved):
    """K3's CPU calls counted under (2, m, s), three a device step, in the
    request that made them."""
    solver = solved["L"]._fused_solver[1]
    shape = (2, solver.m, solver.s)
    assert set(solved["twin"]) == {shape}
    for m in _mslps(solved["spans"]):
        assert solved["by_request"][m.request] == {
            shape: 3 * m.attrs["device_steps"]}
    assert sum(solved["twin"].values()) == sum(
        sum(c.values()) for c in solved["by_request"].values())


def test_device_spans_on_the_cpu(solved):
    """``factor`` and ``solves`` are device spans; on the CPU they hold no
    stream time."""
    for s in solved["spans"]:
        if s.name in ("factor", "solves"):
            assert s.device_ms is None


def test_counters_and_annotate_scope():
    """count() by key and by request; annotate() outside any request does
    nothing."""
    timing.reset()
    timing.annotate(engine="nowhere")
    timing.count("c", 2, key="x")
    with timing.request("r") as r:
        timing.count("c", key="x")
        timing.count("c", 5)
        timing.annotate(flag=7)
    assert r.attrs == {"flag": 7}
    assert timing.counts("c") == {"x": 3, None: 5}
    assert timing.counts("c", request=r.id) == {"x": 1, None: 5}
    assert timing.total("c", request=[r.id]) == 6
    assert timing.total("c", request=[]) == 0
    assert timing.total("c") == 8
    assert timing.counts("absent") == {}
    timing.reset()


def test_spans_lie_on_the_trace_clock(tmp_path):
    """Under start_device_trace on the CPU, every span's host start and end
    lie within 50 µs of its annotation in the exported Chrome trace."""
    timing.reset()
    timing.start_device_trace(str(tmp_path))
    with timing.request("req"):
        with timing.phase("outer"):
            for _ in range(3):
                with timing.phase("inner", device="cpu"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    path = timing.stop_device_trace()
    spans = timing.spans()
    ann = {}
    for e in json.load(open(path))["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ann.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert [s.path for s in spans] == ["req", "outer"] + ["outer.inner"] * 3
    for s in spans:
        a0, a1 = ann[s.path].pop(0)
        assert s.traced and s.device_ms is None
        assert abs(s.start - a0) <= 50 and abs(s.end - a1) <= 50, \
            (s.path, s.start - a0, s.end - a1)
    timing.reset()


def test_reset_clears_spans_and_counters():
    timing.reset()
    with timing.request("r"):
        with timing.phase("p"):
            timing.count("c", key=(1, 2, 3))
    assert len(timing.spans()) == 2 and timing.total("c") == 1
    timing.reset()
    assert timing.spans() == [] and timing.counts("c") == {}
    assert timing.report() == {} and timing.dropped() == 0


def test_full_buffer_drops_and_counts(monkeypatch):
    """A full buffer keeps the first spans, counts the rest as dropped,
    and the aggregate still sees every phase."""
    timing.reset()
    monkeypatch.setattr(timing, "SPAN_CAPACITY", 3)
    for _ in range(5):
        with timing.phase("p"):
            pass
    assert [s.path for s in timing.spans()] == ["p"] * 3
    assert timing.dropped() == 2
    assert timing.report()["p"]["calls"] == 5
    timing.reset()
    assert timing.dropped() == 0


def test_full_buffer_keeps_counters_bounded(monkeypatch):
    """Counts of a request whose root span a full buffer refused go to the
    totals alone: the counters hold one table per kept request, however
    many requests count."""
    timing.reset()
    monkeypatch.setattr(timing, "SPAN_CAPACITY", 4)
    ids = []
    for i in range(50):
        with timing.request("r") as r:
            with timing.phase("p"):
                timing.count("c", key=i % 3)
        ids.append(r.id)
    kept = [s.id for s in timing.spans() if s.id == s.request]
    assert kept == ids[:2] and timing.dropped() == 96
    assert len(timing._by_request) == 2
    assert len(timing._counters) == 3
    assert timing.counts("c") == {0: 17, 1: 17, 2: 16}
    assert timing.counts("c", request=ids[0]) == {0: 1}
    assert timing.total("c", request=ids[1:]) == 1
    timing.reset()
    assert timing._by_request == {} and timing._counters == {}
