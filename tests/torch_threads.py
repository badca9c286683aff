"""One intra-op thread for torch in the port's CPU tests.

The tier-1 run starts six pytest workers on the machine's CPUs at once.
torch's OpenMP pool in each worker would run a thread per CPU, and those
threads spin while they wait, so that every small tensor op of one worker
waits on the others' spinning: the port's test files took about four times
as long that way. Each ``tests/test_torch_*.py`` module imports
``one_torch_thread`` (module-scoped, autouse): its tests run torch on one
thread, and the count is restored after the module's last test.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
