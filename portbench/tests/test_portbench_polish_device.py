"""The reader of ``polish_device_share`` on synthetic runs: the program's
``timing.counts`` replaced by fixed counter totals, and no value without
a counter to read."""
from types import SimpleNamespace

import pytest

from portbench.harness import metric_reader

COUNTER = "polish.factor"


@pytest.fixture
def counters(monkeypatch):
    """Set the program's counter totals: {name: {key: n}}."""
    from wavesandeigenvalues_jl_tpu_torch.utils import timing

    def use(table):
        monkeypatch.setattr(timing, "counts",
                            lambda name, request=None:
                            dict(table.get(name, {})))
    return use


def _run():
    return SimpleNamespace(trace=None, report={}, records=[], window_s=1.0)


@pytest.mark.parametrize("keys,share", [
    ({"device": 70}, 1.0),
    ({"device": 3, "host": 1}, 0.75),
    ({"host": 5}, 0.0)])
def test_share_of_device_factors(counters, keys, share):
    """Device factors over all polish factors of the window: 1.0 with
    device factors only, the host's in the denominator."""
    counters({COUNTER: keys})
    assert metric_reader("polish_device_share")(_run()) == share


def test_no_polish_counted(counters):
    """Nothing to read where no polish step was counted (a program
    without the counter, as the parent's): None, and no error."""
    counters({"fused_slab.factor": {"replay": 7}})
    assert metric_reader("polish_device_share")(_run()) is None


def test_program_without_counters(monkeypatch):
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "counts")
    assert metric_reader("polish_device_share")(_run()) is None
