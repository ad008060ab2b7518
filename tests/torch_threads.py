"""``one_torch_thread``: an autouse fixture that runs a test module's
torch CPU work on one thread.

The tier-1 command spreads the test files over several worker processes
on one machine.  torch's CPU kernels start one OpenMP thread per core in
every worker, and the workers' threads then spin waiting on each other
for cores: a file of the port's that takes ~30 s alone took ~20 minutes
beside five others.  One thread a worker keeps those files within the
run's time limit; what they check does not change.  A module uses it by
importing the name.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
