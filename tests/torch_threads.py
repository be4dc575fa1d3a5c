"""One intra-op thread for the port's tests' in-process CPU ops.

A port test module takes the fixture with
``from tests.torch_threads import one_thread  # noqa: F401``: it is
module-scoped and autouse, so every test of that module runs its
in-process torch ops on one thread, as the spawned ring members do. The
test run's workers share the machine's cores, and beside them a pool of
threads only waits on busy cores.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
