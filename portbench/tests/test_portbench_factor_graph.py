"""The reader of ``factor_graph_share`` on synthetic runs: the program's
``timing.counts`` replaced by fixed counter totals, and no value without
a counter to read."""
from types import SimpleNamespace

import pytest

from portbench.harness import metric_reader

COUNTER = "fused_slab.factor"


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
    ({"replay": 40}, 1.0),
    ({"replay": 6, "capture": 1, "eager": 1}, 0.75),
    ({"eager": 5}, 0.0)])
def test_share_of_replays(counters, keys, share):
    """Replays over all factors of the window: 1.0 with replays only, the
    capture and eager counts in the denominator."""
    counters({COUNTER: keys})
    assert metric_reader("factor_graph_share")(_run()) == share


def test_no_factor_counted(counters):
    """Nothing to read where no factor was counted (a program without the
    counter, as the parent's): None, and no error."""
    counters({"slab_thomas.launches": {(2, 59, 256): 3}})
    assert metric_reader("factor_graph_share")(_run()) is None


def test_program_without_counters(monkeypatch):
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "counts")
    assert metric_reader("factor_graph_share")(_run()) is None
