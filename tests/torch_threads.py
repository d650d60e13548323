"""Test helper: cap torch's CPU thread pool at two threads for the test
module that imports ``few_torch_threads`` (an autouse fixture).

The tests run in several worker processes at once; torch's default pool has
a thread per core in each of them, and at the port's small test shapes the
oversubscribed pools cost far more than they parallelise (the eight heavy
``test_torch_*`` files took 483 s on 6 workers of an 8-core host with the
default pools and 77 s with this fixture)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
