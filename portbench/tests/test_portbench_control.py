"""The control of each cell comes out not correct: the reference in
complex64 in the program's place (local solves).  At CPU sizes; the
readings that set the limits were taken on the card at the cells' own
sizes (``python3 -m portbench.control``)."""
import pytest

from portbench.control import control_numbers

from .conftest import ROOT, small


@pytest.mark.parametrize("workload", ["rijke7259.mslp_map"])
def test_control_fails_a_limit(workload):
    cfg, mix = small(workload)
    rows = control_numbers(workload, [2 ** 31 + 5], 3, device="cpu",
                           root=ROOT, cfg=cfg, mix=mix)
    for row in rows:
        assert row["checked"] > 0
        assert any(row["numbers"][k] > row["limits"][k]
                   for k in row["limits"]), row
