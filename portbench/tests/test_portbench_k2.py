"""Kernel K2's work count and the two readers the dense cell adds
(``k2_roofline_pct``, ``bj_refresh_s_per_mode``), on synthetic runs: the
program's ``timing.spans`` and ``timing.counts`` replaced by fixed
records, and no value without what a reader reads."""
from types import SimpleNamespace

import pytest

from portbench.harness import metric_reader
from portbench.roofline import bound_s
from portbench.roofline_k2 import dense_gmres_work
from portbench.trace import TraceSummary

K2 = "void dense_gmres_kernel(Args)"


def test_k2_work_at_the_dense_cell_shape():
    """(2, 1408, 80, 1), the launch of every inner solve at 1,369 DOF:
    P and b read once, x written once; operations bound it."""
    nbytes, flops = dense_gmres_work(2, 1408, 80, 1)
    assert nbytes == 31_764_480 == 8 * (2 * 1408 ** 2 + 2 * 2 * 1408)
    assert flops == 2_832_231_424
    assert bound_s(nbytes, flops) == pytest.approx(flops / 67e12)
    assert bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0423, abs=5e-5)


def test_k2_work_counts_a_restart_matvec():
    """A second cycle adds m matvecs and one for its residual."""
    one = dense_gmres_work(1, 128, 10, 1)[1]
    two = dense_gmres_work(1, 128, 10, 2)[1]
    assert two - 2 * one == 8 * 128 * 128


def _span(id, request, path, traced=False, **attrs):
    return SimpleNamespace(id=id, request=request, path=path,
                           name=path.rsplit(".", 1)[-1], traced=traced,
                           device_ms=None, start=0.0, end=1.0, attrs=attrs)


def _run(trace=None, report=None, modes=(1, 1, 0)):
    records = [{"ok": bool(m), "modes": m} for m in modes]
    return SimpleNamespace(trace=trace, report=report or {},
                           records=records, window_s=1.0,
                           ctx=SimpleNamespace(mix={"trace_requests": 2}))


def _trace(device_ops):
    return TraceSummary(window_s=1.0, busy_s=0.5, device_ops=device_ops)


@pytest.fixture
def program(monkeypatch):
    """Set the program's span records and K2's launch counts by request."""
    from wavesandeigenvalues_jl_tpu_torch.utils import timing

    def use(spans, launches):
        monkeypatch.setattr(timing, "spans", lambda: list(spans))

        def counts(name, request=None):
            assert name == "dense_gmres.launches"
            out = {}
            for req, by_shape in launches.items():
                if request is None or req in request:
                    for shape, n in by_shape.items():
                        out[shape] = out.get(shape, 0) + n
            return out
        monkeypatch.setattr(timing, "counts", counts)
    return use


SPANS = [_span(1, 1, "mslp", traced=True), _span(2, 2, "mslp", traced=True),
         _span(3, 3, "mslp")]


def test_k2_roofline_over_counted_shapes(program):
    """Launches of the traced requests at two shapes, bound over K2's
    device time; the untraced request's launches are left out."""
    program(SPANS, {1: {(2, 1408, 80, 1): 15}, 2: {(2, 512, 80, 1): 6},
                    3: {(2, 1408, 80, 1): 99}})
    ops = [(K2, 0.0, 1100.0)] * 15 + [(K2, 0.0, 900.0)] * 6 + \
        [("other", 0.0, 1e6)]
    bound = 15 * bound_s(*dense_gmres_work(2, 1408, 80, 1)) + \
        6 * bound_s(*dense_gmres_work(2, 512, 80, 1))
    got = metric_reader("k2_roofline_pct")(_run(_trace(ops)))
    assert got == pytest.approx(100 * bound / 21.9e-3)
    assert 3 < got < 5


def test_k2_roofline_needs_a_trace_and_a_keyed_counter(program):
    """None without a trace, without K2 in it, and where the counter
    carries no shape (a program whose counter is unkeyed)."""
    ops = [(K2, 0.0, 1100.0)]
    program(SPANS, {1: {(2, 1408, 80, 1): 1}})
    assert metric_reader("k2_roofline_pct")(_run()) is None
    assert metric_reader("k2_roofline_pct")(
        _run(_trace([("other", 0.0, 5.0)]))) is None
    program(SPANS, {1: {None: 15}})
    assert metric_reader("k2_roofline_pct")(_run(_trace(ops))) is None
    program(SPANS, {})
    assert metric_reader("k2_roofline_pct")(_run(_trace(ops))) is None


def test_k2_roofline_of_a_program_without_counters(monkeypatch):
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "spans")
    monkeypatch.delattr(timing, "counts")
    run = _run(_trace([(K2, 0.0, 1100.0)]))
    assert metric_reader("k2_roofline_pct")(run) is None


def test_bj_refresh_sums_every_refresh_span_per_mode():
    """The refresh inside a step's ``coefficients`` and at request level,
    summed, over the converged answers; other spans left out."""
    report = {"fused_local.device_step.coefficients.bj_refresh":
              {"total_s": 0.3, "calls": 4},
              "bj_refresh": {"total_s": 0.5, "calls": 6},
              "fused_local.device_step.coefficients":
              {"total_s": 9.0, "calls": 20},
              "fused_local.polish_step.lu": {"total_s": 9.0, "calls": 8}}
    got = metric_reader("bj_refresh_s_per_mode")(
        _run(report=report, modes=(1, 0, 1, 1, 1)))
    assert got == pytest.approx(0.2)


@pytest.mark.parametrize("report,modes", [
    ({}, (1, 1)),
    ({"fused_local.device_step.coefficients": {"total_s": 1.0,
                                               "calls": 2}}, (1,)),
    ({"bj_refresh": {"total_s": 0.5, "calls": 2}}, (0, 0))])
def test_bj_refresh_gives_nothing_without_spans_or_modes(report, modes):
    """No refresh span (the slab engine, or a program without the span)
    or no converged answer: None."""
    assert metric_reader("bj_refresh_s_per_mode")(
        _run(report=report, modes=modes)) is None
