"""The readers of the program's spans and counters, on synthetic runs: the
program's ``timing.spans`` and ``timing.counts`` replaced by fixed
records, and no readers' value without what it reads."""
from types import SimpleNamespace

import pytest

from portbench.harness import metric_reader
from portbench.roofline import bound_s, slab_thomas_work
from portbench.trace import TraceSummary

STEP = "fused_local.device_step"


def _span(id, request, path, traced=False, device_ms=None, start=0.0,
          end=1.0, **attrs):
    return SimpleNamespace(id=id, request=request, path=path,
                           name=path.rsplit(".", 1)[-1], traced=traced,
                           device_ms=device_ms, start=start, end=end,
                           attrs=attrs)


def _run(trace=None, report=None, modes=(1, 1, 0)):
    records = [{"ok": bool(m), "modes": m} for m in modes]
    return SimpleNamespace(trace=trace, report=report or {},
                           records=records, window_s=1.0,
                           ctx=SimpleNamespace(mix={"trace_requests": 1}))


@pytest.fixture
def program(monkeypatch):
    """Set the program's span records and counter totals by request."""
    from wavesandeigenvalues_jl_tpu_torch.utils import timing

    def use(spans, launches=None):
        monkeypatch.setattr(timing, "spans", lambda: list(spans))

        def counts(name, request=None):
            assert name == "slab_thomas.launches"
            out = {}
            for req, by_shape in (launches or {}).items():
                if request is None or req in request:
                    for shape, n in by_shape.items():
                        out[shape] = out.get(shape, 0) + n
            return out
        monkeypatch.setattr(timing, "counts", counts)
    return use


def _trace(device_ops):
    return TraceSummary(window_s=1.0, busy_s=0.5, device_ops=device_ops)


def test_polish_split_divides_by_converged_modes():
    report = {"fused_local.polish_step.lu": {"total_s": 3.0, "calls": 6},
              "fused_local.polish_step.arnoldi": {"total_s": 1.0,
                                                  "calls": 6}}
    run = _run(report=report, modes=(1, 0, 1, 0))
    assert metric_reader("polish_lu_s_per_mode")(run) == 1.5
    assert metric_reader("polish_arnoldi_s_per_mode")(run) == 0.5
    assert metric_reader("polish_lu_s_per_mode")(_run(modes=(1,))) is None
    assert metric_reader("polish_lu_s_per_mode")(
        _run(report=report, modes=(0,))) is None


def test_steps_per_mode_of_converged_requests(program):
    program([_span(1, 1, "mslp", flag=0, device_steps=5, polish_steps=3),
             _span(2, 1, STEP),
             _span(3, 3, "mslp", flag=1, device_steps=20, polish_steps=0),
             _span(4, 4, "mslp", flag=0, device_steps=4, polish_steps=2),
             _span(5, 1, "mslp", flag=0, device_steps=9, polish_steps=9)])
    assert metric_reader("device_steps_per_mode")(_run()) == 4.5
    assert metric_reader("polish_steps_per_mode")(_run()) == 2.5
    program([_span(1, 1, "mslp", flag=1, device_steps=5, polish_steps=3)])
    assert metric_reader("device_steps_per_mode")(_run()) is None


def test_factor_stream_of_untraced_requests(program):
    """The traced request's factor spans are left out, found by id."""
    program([_span(1, 1, "mslp", traced=True),
             _span(2, 1, STEP + ".factor", traced=True, device_ms=90.0),
             _span(3, 3, "mslp"),
             _span(4, 3, STEP + ".factor", device_ms=40.0),
             _span(5, 3, STEP + ".solves", device_ms=7.0),
             _span(6, 6, "mslp"),
             _span(7, 6, STEP + ".factor", device_ms=50.0),
             _span(8, 6, STEP + ".factor", device_ms=None)])
    assert metric_reader("factor_stream_ms")(_run()) == 45.0
    program([_span(1, 1, "mslp", traced=True),
             _span(2, 1, STEP + ".factor", traced=True, device_ms=90.0)])
    assert metric_reader("factor_stream_ms")(_run()) is None


def test_k3_counted_over_several_shapes(program):
    """Launches of the traced requests at two shapes, bound over K3's
    device time; the untraced request's launches are left out."""
    program([_span(1, 1, "mslp", traced=True),
             _span(2, 2, "mslp", traced=True),
             _span(3, 3, "mslp")],
            launches={1: {(2, 60, 256): 10}, 2: {(2, 48, 128): 4},
                      3: {(2, 60, 256): 99}})
    ops = [("slab_thomas_kernel", 0.0, 300.0)] * 10 + \
        [("slab_thomas_kernel", 0.0, 200.0)] * 4 + [("other", 0.0, 1e6)]
    bound = 10 * bound_s(*slab_thomas_work(2, 60, 256)) + \
        4 * bound_s(*slab_thomas_work(2, 48, 128))
    got = metric_reader("k3_roofline_pct.counted")(_run(_trace(ops)))
    assert got == pytest.approx(100 * bound / 3.8e-3)


def test_idle_share_of_traced_steps(program):
    """Device operations against the traced requests' device steps on the
    trace's clock: 10 of 40 µs busy, the untraced step left out."""
    program([_span(1, 1, "mslp", traced=True),
             _span(2, 1, STEP, traced=True, start=100.0, end=120.0),
             _span(3, 1, STEP, traced=True, start=200.0, end=220.0),
             _span(4, 4, "mslp"),
             _span(5, 4, STEP, start=300.0, end=400.0)])
    ops = [("k", 95.0, 10.0), ("k", 102.0, 2.0), ("k", 210.0, 30.0),
           ("k", 300.0, 100.0)]
    got = metric_reader("device_idle_pct.step")(_run(_trace(ops)))
    assert got == pytest.approx(100 * (1 - 15.0 / 40.0))


@pytest.mark.parametrize("name", ["k3_roofline_pct.counted",
                                  "device_idle_pct.step"])
def test_device_trace_readers_need_a_trace(program, name):
    program([_span(1, 1, "mslp", traced=True),
             _span(2, 1, STEP, traced=True)], launches={1: {(2, 8, 128): 3}})
    assert metric_reader(name)(_run()) is None


@pytest.mark.parametrize("name", [
    "polish_steps_per_mode", "device_steps_per_mode", "factor_stream_ms",
    "k3_roofline_pct.counted", "device_idle_pct.step"])
def test_readers_of_a_program_without_spans(monkeypatch, name):
    """A program with no span records or counters (the parent's) gives no
    value and raises nothing."""
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "spans")
    monkeypatch.delattr(timing, "counts")
    run = _run(_trace([("slab_thomas_kernel", 0.0, 300.0)]))
    assert metric_reader(name)(run) is None
