"""K3's work at the 7,259-DOF slab shape against a hand count."""
import pytest

from portbench.roofline import bound_s, slab_thomas_work


def test_k3_work_at_rijke_shape():
    nbytes, flops = slab_thomas_work(2, 60, 256)
    stream = 2 * 120 * 256 * 256 * 8        # complex64 [2, 2m, s, s]
    assert stream == 125_829_120            # 125.8 MB of stream
    assert nbytes == stream + 2 * (2 * 60 * 256 * 8)
    assert flops == 8 * 2 * 120 * 256 * 256
    # bytes bound it: 126.3 MB at 3.35 TB/s
    assert bound_s(nbytes, flops) == pytest.approx(nbytes / 3.35e12)
    assert bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0377, abs=5e-5)


def test_k3_bound_at_a_narrower_shape():
    """(2, 48, 128), where the bound is set by the bytes as well."""
    nbytes, flops = slab_thomas_work(2, 48, 128)
    assert bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0076, abs=5e-5)
