"""The one thread policy of the port's CPU tests (``tests/test_torch_*.py``).

A test module takes it with one line::

    from port_threads import one_thread  # noqa: F401

pytest finds the fixture in the module's namespace, and it is autouse, so
every test of the module runs under it; nothing else in a port test module
sets a thread count.  The file has no ``test_`` prefix, so pytest does not
collect it.

Why one thread: the test run puts six xdist workers on eight cores, and
each worker's OpenBLAS (numpy's and scipy's) and libgomp default to one
thread a core, so up to 48 threads spin on eight cores.  On an
eight-core host, ``tests/test_torch_*.py`` under six workers took 409 s
of wall and 2,065 test-seconds with each module at its own thread setting,
and 165 s and 658 test-seconds under this fixture; one polish test took
152 s among the oversubscribed workers and 5.9 s under it.  torch's
batched CPU LU with two or more intra-op threads also corrupts its
pivots and hangs from n ≈ 192 on (``parallel/dist_beyn.py``).  The ranks
that ``parallel.multihost.run_world`` starts get ``OMP_NUM_THREADS=1``
from the program itself.

The limits hold from the module's first test to its last, module-scoped
fixtures included (pytest sets up autouse fixtures first in their scope),
and both are restored after it: a worker runs other modules too, and every
worker imports every module at collection, so a limit set at import would
hold for the whole session.
"""
import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS/OpenMP thread (``threadpoolctl``) and one torch intra-op
    thread while the importing module runs."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(saved)
