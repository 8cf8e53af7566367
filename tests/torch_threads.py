"""The one thread policy of the port's tests.

Every ``tests/test_torch_*.py`` module takes :func:`torch_threads`, a
module-scoped autouse fixture, with one import::

    from torch_threads import torch_threads  # noqa: F401

and passes :func:`child_env` to the Python processes it starts (CLI
children, torchrun ranks), whose torch reads the cap from
``OMP_NUM_THREADS`` at start-up.  ``tests/test_torch_port_hygiene.py``
holds every module to it.

Why a cap: the suite runs in several pytest-xdist workers on one machine.
At torch's default of one intra-op thread per core in each worker, the
workers' thread pools oversubscribe the cores and spin against each
other; a batch-1 HRNet-W32 training step that takes about a second with
two threads took minutes so.  Two threads ran the whole suite a few
percent faster than one (6 workers on 8 cores).
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Cap torch's intra-op threads at :data:`THREADS` for the module's
    tests; restore the count it found afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def child_env(env: dict) -> dict:
    """``env`` with the cap that a child's torch reads at start-up."""
    return dict(env, OMP_NUM_THREADS=str(THREADS))
